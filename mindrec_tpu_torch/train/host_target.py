"""Host-resident embedding tables: the reference's CPU-target regime.

Port of ``mindrec_tpu/train/host_target.py``.  Under PS mode without the
device cache (``parameter_server=True, vocab_cache_size=0``) the tables
never enter device memory: they and their optimizer state live in tiers
(:class:`~mindrec_tpu_torch.ops.cache.HostTier`, RAM cap + SSD spill, or
:class:`~mindrec_tpu_torch.ops.remote.RemoteTier` on table servers), and
only the batch's unique rows travel to the card and their gradients back.

Per step (:meth:`HostTargetAdapter.train_step`):

* host: a stable sort of the batch's ids gives the ascending unique ids
  ``uq``, each position's unique index ``uidx``, the sorted positions
  ``perm`` and their unique index ``uidx_sorted``; the param tiers'
  rows of ``uq`` form ``rows_stack [unique_bucket, sum(D)]`` (the tail
  past ``uq.size`` zero: no position reads it), while the state tiers'
  rows are read on the io pool beside the card's work;
* card: ``rows_stack`` expands to batch order through an autograd
  function whose backward is the sorted segment-sum kernel
  (``segsum_sorted`` through ``perm``: the per-unique gradient that the
  reference's ``jax.grad`` of ``rows_stack[uidx]`` gives by a
  scatter-add); the model's forward and backward; the dense updates with
  the optimizers' ``update_leaf``;
* host: FTRL / LazyAdam on the touched rows in float64 numpy (the
  reference's ``optimizer.target="CPU"``), written back to the tiers.

Every tier read and write runs on the calling thread or on the io pool
while it waits, one task per tier, so no tier's socket is used from two
threads at once.
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mindrec_tpu_torch.data.criteo import to_device
from mindrec_tpu_torch.ops import prng
from mindrec_tpu_torch.ops.cache import make_tier
from mindrec_tpu_torch.ops.kernels.segsum import segsum_sorted
from mindrec_tpu_torch.train.step import (
    BucketOverflow, TrainState, flatten_params, is_wide_key, map_leaves,
)


def _np_ftrl(g, w, accum, linear, lr, l1, l2, loss_scale):
    """FTRL-proximal (lr_power -0.5) in float64 -> float32 (w, accum, linear)."""
    g = g.astype(np.float64) / loss_scale
    accum_new = accum + g * g
    sigma = (np.sqrt(accum_new) - np.sqrt(accum)) / lr
    linear_new = linear + g - sigma * w
    quad = np.sqrt(accum_new) / lr + 2.0 * l2
    w_new = np.where(np.abs(linear_new) > l1,
                     (np.sign(linear_new) * l1 - linear_new) / quad, 0.0)
    return (w_new.astype(np.float32), accum_new.astype(np.float32),
            linear_new.astype(np.float32))


def _np_adam(g, w, m, v, step, lr, b1, b2, eps, loss_scale):
    """LazyAdam on the touched rows in float64 -> float32 (w, m, v)."""
    g = g.astype(np.float64) / loss_scale
    lr_t = lr * np.sqrt(1.0 - b2**step) / (1.0 - b1**step)
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * g * g
    w_new = w - lr_t * m_new / (np.sqrt(v_new) + eps)
    return (w_new.astype(np.float32), m_new.astype(np.float32),
            v_new.astype(np.float32))


class _ExpandRows(torch.autograd.Function):
    """``rows_stack.to(dtype)[uidx]``, whose backward is the sorted
    segment-sum of the batch-order gradient through ``perm`` -> the
    float32 gradient of ``rows_stack`` (rows past the last unique id
    zero)."""

    @staticmethod
    def forward(ctx, rows_stack, uidx, uidx_sorted, perm, dtype):
        ctx.save_for_backward(uidx_sorted, perm)
        ctx.n_out = rows_stack.shape[0]
        return rows_stack.to(dtype)[uidx]

    @staticmethod
    def backward(ctx, g):
        uidx_sorted, perm = ctx.saved_tensors
        g_rows = segsum_sorted(g.contiguous(), uidx_sorted, ctx.n_out, perm).T
        return g_rows, None, None, None, None


def sort_ids(ids: np.ndarray):
    """-> (uq ascending, uidx [n], perm [n] int32, uidx_sorted [n] int32)
    of flat int64 ids, by one stable sort."""
    n = ids.size
    perm = np.argsort(ids, kind="stable")
    sorted_ids = ids[perm]
    newv = np.empty(n, bool)
    newv[:1] = True
    np.not_equal(sorted_ids[1:], sorted_ids[:-1], out=newv[1:])
    uidx_sorted = (np.cumsum(newv, dtype=np.int32) - 1).astype(np.int32)
    uidx = np.empty(n, np.int32)
    uidx[perm] = uidx_sorted
    return sorted_ids[newv], uidx, perm.astype(np.int32), uidx_sorted


class HostTargetAdapter:
    """Trains a model whose tables (their specs declare ``target="host"``)
    live entirely in tiers.

    ``model``: a W&D built with ``parameter_server=True`` (one id space);
    ``vocab_size``: the host tiers' rows; ``unique_bucket``: the bound on a
    batch's distinct ids (the card's static row count); ``opt_w`` /
    ``opt_d``: the optimizers, whose ``kind`` and ``hyper`` pick the host
    row update (ftrl, or adam as LazyAdam); ``ram_bytes`` /
    ``spill_dir``: the host tiers' knobs; ``remote_addrs``: "host:port"
    table servers holding the tiers instead (named ``host.<table>`` and
    ``host.<table>.<state>``, as the reference names them);
    ``matmul_dtype``: the dtype the expanded rows enter the model in.
    The device is the state's."""

    def __init__(self, model, vocab_size: int, unique_bucket: int,
                 opt_w, opt_d, ram_bytes=None, spill_dir=None,
                 remote_addrs=None, seed: int = 0,
                 matmul_dtype=torch.bfloat16):
        self.model = model
        self.bucket = unique_bucket
        self.opt_w, self.opt_d = opt_w, opt_d
        self.matmul_dtype = matmul_dtype
        self.tables = {}  # name -> (path, spec, opt)
        self.tiers = {}  # name -> {"param": tier, <state>: tier}
        self._adam_steps = {}
        for name, (path, spec) in model.table_specs.items():
            opt = opt_w if is_wide_key("/".join(map(str, path))) else opt_d
            self.tables[name] = (path, spec, opt)
            self._adam_steps[name] = 0
            tier = functools.partial(
                make_tier, dim=spec.emb_dim, vocab_size=vocab_size,
                remote_addrs=remote_addrs, ram_bytes=ram_bytes,
                spill_dir=spill_dir, seed=seed)
            tiers = {"param": tier(f"host.{name}")}
            for s in (("accum", "linear") if opt.kind == "ftrl" else ("m", "v")):
                bias = float(opt.hyper.get("initial_accum", 1.0)) if s == "accum" else 0.0
                tiers[s] = tier(f"host.{name}.{s}", init_std=0.0, init_bias=bias)
            self.tiers[name] = tiers
        # one thread per tier: the state reads beside the card's work, then
        # every tier's write
        self._io = ThreadPoolExecutor(
            max_workers=sum(len(t) for t in self.tiers.values()),
            thread_name_prefix="host-target-io")

    # -- host side -----------------------------------------------------

    def _rows_stack(self, uq: np.ndarray) -> tuple[np.ndarray, dict]:
        """The param rows of ``uq``: ``[bucket, sum(D)]`` with a zero tail,
        and each table's ``[uq.size, D]`` block."""
        if uq.size > self.bucket:
            raise BucketOverflow(uq.size, self.bucket)
        dims = [spec.emb_dim for _p, spec, _o in self.tables.values()]
        stack = np.zeros((self.bucket, sum(dims)), np.float32)
        rows, off = {}, 0
        for (name, tiers), d in zip(self.tiers.items(), dims):
            rows[name] = tiers["param"].read(uq)
            stack[: uq.size, off: off + d] = rows[name]
            off += d
        return stack, rows

    def _expand(self, stack, uidx, perm, uidx_sorted, batch, dev, grad: bool):
        """Batch-order rows per table, ``[B, F, D]`` each (and the leaf to
        differentiate)."""
        t = to_device({"rows": stack, "uidx": uidx.astype(np.int64),
                       "perm": perm, "uidx_sorted": uidx_sorted}, dev)
        leaf = t["rows"].requires_grad_(grad)
        if grad:
            pos = _ExpandRows.apply(leaf, t["uidx"], t["uidx_sorted"],
                                    t["perm"], self.matmul_dtype)
        else:
            pos = leaf[t["uidx"]]
        B, F = np.asarray(batch["wts"]).shape
        rows, off = {}, 0
        for name, (_path, spec, _opt) in self.tables.items():
            rows[name] = pos[:, off: off + spec.emb_dim].reshape(B, F, spec.emb_dim)
            off += spec.emb_dim
        return leaf, rows

    # -- one training step ---------------------------------------------

    def train_step(self, state: TrainState, batch: dict):
        """``state`` holds only the dense parameters (tables absent);
        -> (state', (loss_w, loss_d)), the losses device tensors."""
        dev = state.step.device
        ids = np.asarray(batch["ids"], np.int64).reshape(-1)
        uq, uidx, perm, uidx_sorted = sort_ids(ids)
        stack, w_rows = self._rows_stack(uq)
        # the state rows are not needed until the card is done
        futs = {(name, s): self._io.submit(tier.read, uq)
                for name, tiers in self.tiers.items()
                for s, tier in tiers.items() if s != "param"}

        flat = flatten_params(state.params)
        leaves = {k: p.detach().requires_grad_(True) for k, p in flat}
        params = map_leaves(lambda k, _p: leaves[k], state.params)
        rows_leaf, rows = self._expand(stack, uidx, perm, uidx_sorted, batch,
                                       dev, grad=True)
        tb = to_device({k: batch[k] for k in ("wts", "label")}, dev)
        logits = self.model.apply_rows(params, rows, tb["wts"], train=True)
        lw, ld = self.model.loss(params, logits, tb["label"])
        sens = float(getattr(self.model.config, "loss_scale", 1.0))
        grads = torch.autograd.grad(ld * sens, [*leaves.values(), rows_leaf],
                                    allow_unused=True)

        # dense updates on the card (ordinary leaf updates)
        opt_w, opt_d = dict(state.opt_w), dict(state.opt_d)
        new = {}
        with torch.no_grad():
            for (key, p), g in zip(flat, grads[:-1]):
                g = torch.zeros_like(p) if g is None else g
                opt, st = (self.opt_w, opt_w) if is_wide_key(key) else (self.opt_d, opt_d)
                new[key], st[key] = opt.update_leaf(g, st[key], p)
        params2 = map_leaves(lambda k, _p: new[k], state.params)

        # the row optimiser on the host (the reference's target="CPU")
        g_rows = grads[-1][: uq.size].double().cpu().numpy()
        writes, off = [], 0
        for name, (_path, spec, opt) in self.tables.items():
            d = spec.emb_dim
            g = g_rows[:, off: off + d]
            off += d
            tiers, h = self.tiers[name], opt.hyper
            if opt.kind == "ftrl":
                out = _np_ftrl(g, w_rows[name], futs[name, "accum"].result(),
                               futs[name, "linear"].result(), h["learning_rate"],
                               h["l1"], h["l2"], h["loss_scale"])
                names = ("param", "accum", "linear")
            else:  # adam / lazy_adam
                self._adam_steps[name] += 1
                out = _np_adam(g, w_rows[name], futs[name, "m"].result(),
                               futs[name, "v"].result(), self._adam_steps[name],
                               h["learning_rate"], h["b1"], h["b2"], h["eps"],
                               h["loss_scale"])
                names = ("param", "m", "v")
            writes += [self._io.submit(tiers[t].write, uq, r)
                       for t, r in zip(names, out)]
        for f in writes:
            f.result()
        state = state._replace(params=params2, opt_w=opt_w, opt_d=opt_d,
                               step=state.step + 1)
        return state, (lw.detach(), ld.detach())

    def read_rows(self, table_name: str, ids) -> np.ndarray:
        """The tier's current rows of ``ids`` ``[n, D]``."""
        return self.tiers[table_name]["param"].read(np.asarray(ids, np.int64))

    # -- eval ----------------------------------------------------------

    @torch.no_grad()
    def eval_step(self, dense_params, batch):
        """(probs, labels) with the rows read from the tiers."""
        dev = flatten_params(dense_params)[0][1].device
        ids = np.asarray(batch["ids"], np.int64).reshape(-1)
        uq, uidx, perm, uidx_sorted = sort_ids(ids)
        stack, _ = self._rows_stack(uq)
        _, rows = self._expand(stack, uidx, perm, uidx_sorted, batch, dev,
                               grad=False)
        wts = to_device({"wts": batch["wts"]}, dev)["wts"]
        logits = self.model.apply_rows(dense_params, rows, wts, train=False)
        return torch.sigmoid(logits), batch["label"]


def init_dense_state(model, seed: int, opt_w, opt_d, device="cuda") -> TrainState:
    """A ``TrainState`` over the dense parameters only: the tables are
    never built (``model.init(tables=False)``), so they never reach the
    device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dense = model.init(gen, device=device, tables=False)
    flat = flatten_params(dense)
    return TrainState(
        params=dense,
        opt_w={k: opt_w.init_leaf(p) for k, p in flat if is_wide_key(k)},
        opt_d={k: opt_d.init_leaf(p) for k, p in flat if not is_wide_key(k)},
        step=torch.zeros((), dtype=torch.int32, device=device),
        rng=prng.key(seed, device),
    )
