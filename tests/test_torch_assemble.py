"""The multitable model's group entry (``apply_groups_batch``) and the
feature assembly's plain version (``ops/kernels/assemble.py``), on the
groups' rows the sparse step hands over: two tiny groups (indicator,
emb64_single) and two sorted ones (emb128 at width 256, multi), ids over
every fold sub-row, masks all ones, prefixes or all zeros.

With the bf16 MLP the entry assembles the MLP's input from the groups'
rows (the kernels' plain version on the CPU); against
``apply_rows_batch`` over ``table_rows``' slices (the float32 route, and
the eval and dense steps' arithmetic) it must give the same MLP input and
gradients bit for bit, and logits within float32 rounding of the wide
sum, which it adds in another order.  The step through either route is
held to the JAX reference as ``test_torch_multitable.py`` holds it.
"""

import numpy as np
import pytest
import torch

from mindrec_tpu_torch.data.outbrain import to_device
from mindrec_tpu_torch.models import multitable
from mindrec_tpu_torch.ops import kernels
from mindrec_tpu_torch.ops.group_rows import table_rows
from mindrec_tpu_torch.train.step import init_train_state, make_train_step
from mindrec_tpu.train import step as jstep
from test_torch_multitable import (  # noqa: F401  (_interpret_kernels: autouse)
    KW, _batches, _compare, _interpret_kernels, _setup,
)

MASKS = ("ones", "prefix", "zeros")


def _masked(batch, kind, rng):
    """The batch with its multi-hot masks set to ``kind``."""
    out = dict(batch)
    for name in multitable.MULTI_FIELDS:
        m = batch[f"multi_{name}_mask"]
        if kind == "ones":
            m = np.ones_like(m)
        elif kind == "zeros":
            m = np.zeros_like(m)
        else:  # a prefix of 1..L hot entries per sample
            n = rng.integers(1, m.shape[1] + 1, size=(m.shape[0], 1))
            m = (np.arange(m.shape[1])[None, :] < n).astype(m.dtype)
        out[f"multi_{name}_mask"] = m
    return out


def _handed_groups(kind):
    """(model, params, device batch, the groups the sparse step hands to
    ``apply_groups_batch``) of one bf16 step on the CPU."""
    cfg = multitable.MultiTableConfig(**{**KW, "use_mixed_precision": True})
    model = multitable.MultiTableWideDeepModel(cfg)
    from mindrec_tpu_torch.train import optim
    opts = (optim.ftrl(loss_scale=1000.0), optim.lazy_adam(loss_scale=1000.0))
    state = init_train_state(model, 0, *opts, device="cpu")
    rng = np.random.default_rng(5)
    host = _batches(1, seed=6)[0]
    # ids over every fold sub-row in each group
    for key in ("indicator_id", "emb_128_id", "emb_64_single_id",
                *(f"multi_{n}_id" for n in multitable.MULTI_FIELDS)):
        host[key] = host[key].copy()
        host[key].reshape(-1)[:8] = np.arange(8, dtype=host[key].dtype)
    batch = to_device(_masked(host, kind, rng), "cpu")
    seen = {}
    entry = model.apply_groups_batch

    def spy(params, groups, b, **kw):
        seen.update(params=params, groups=groups)
        return entry(params, groups, b, **kw)

    model.apply_groups_batch = spy
    make_train_step(model, *opts, donate=False)(state, batch)
    del model.apply_groups_batch
    return model, seen["params"], batch, seen["groups"]


def _run(route, model, params, batch, groups, upstream):
    """Logits, each group's row gradient and the MLP's input under
    ``route``."""
    fresh = {g: gr._replace(rows=gr.rows.detach().clone().requires_grad_(True))
             for g, gr in groups.items()}
    mlp, seen = model._mlp, []

    def spy(mlp_params, x, *a, **k):
        seen.append(x.detach())
        return mlp(mlp_params, x, *a, **k)

    model._mlp = spy
    try:
        with torch.enable_grad():
            if route == "entry":
                logits = model.apply_groups_batch(params, fresh, batch,
                                                  train=True)
            elif route == "table_rows":
                logits = model.apply_rows_batch(
                    params, table_rows(model.table_specs, fresh), batch,
                    train=True)
            else:
                logits = model.apply_assembled(params, fresh, batch,
                                               train=True)
            grads = torch.autograd.grad((logits * upstream).sum(),
                                        [gr.rows for gr in fresh.values()])
    finally:
        del model._mlp
    return logits.detach(), grads, seen[0]


@pytest.mark.parametrize("masks", MASKS)
def test_entry_and_assembly_match_table_rows(masks):
    """On the rows one real step hands over: the entry == the assembled
    route bit for bit (``assemble`` on CPU tensors: its plain version, no
    launch), which gives the MLP the bf16 of
    ``apply_rows_batch(table_rows(...))``'s float32 input bit for bit, the
    same row gradients bit for bit (zeros outside the tables' lanes and
    in the sublanes a position does not own, and in a fully masked
    group), and logits within float32 rounding."""
    model, params, batch, groups = _handed_groups(masks)
    assert [gr.layout.tiny for gr in groups.values()] == [True, False, True,
                                                          False]
    for gr in groups.values():
        assert gr.rows.dtype == torch.bfloat16
        assert set(torch.remainder(gr.ids, 8).tolist()) == set(range(8))
    up = torch.from_numpy(np.random.default_rng(1).normal(
        size=(KW["batch_size"], 1)).astype(np.float32))
    want, want_g, want_x = _run("table_rows", model, params, batch, groups, up)
    kernels.reset_launches()
    got, got_g, got_x = _run("entry", model, params, batch, groups, up)
    asm, asm_g, asm_x = _run("assembled", model, params, batch, groups, up)
    assert not any(kernels.LAUNCHES.values())
    assert torch.equal(got, asm) and torch.equal(got_x, asm_x)
    for a, b in zip(got_g, asm_g):
        assert torch.equal(a, b)
    assert asm_x.dtype == torch.bfloat16
    assert torch.equal(asm_x, want_x.to(torch.bfloat16))
    torch.testing.assert_close(asm, want, rtol=1e-6, atol=1e-7)
    for (g, gr), a, b in zip(groups.items(), asm_g, want_g):
        assert torch.equal(a, b)
        lay = gr.layout
        live = torch.zeros(a.shape[1], dtype=torch.bool)
        for name in lay.tables:
            live[lay.offs[name]: lay.offs[name] + lay.lanes[name]] = True
        assert not a[:, ~live].any()
        wide = lay.tables[1]
        owned = torch.remainder(gr.ids, 8)
        w = a[:, lay.offs[wide]: lay.offs[wide] + 8]
        other = torch.ones_like(w, dtype=torch.bool)
        other[torch.arange(len(owned)), owned.long()] = False
        assert not w[other].any()
        if "mask_keys" in model.table_groups[g]:
            assert a.any() == (masks != "zeros")


@pytest.mark.parametrize("route", ["entry", "table_rows"])
def test_step_through_entry_matches_jax(route):
    """Two bf16 steps through ``apply_groups_batch`` (the assembly, on
    the CPU its plain version) or through ``apply_rows_batch`` over
    ``table_rows``' slices against the JAX reference, with
    ``test_multitable_step_matches_jax_mixed_precision``'s tolerances."""
    jm, js, jo, tm, ts, to = _setup(mixed=True)
    if route == "table_rows":
        def entry(p, groups, batch, train=False, rng=None, use_kernels=True):
            return tm.apply_rows_batch(
                p, table_rows(tm.table_specs, groups), batch, train, rng)

        tm.apply_groups_batch = entry
    j_fn = jstep.make_train_step(jm, *jo, jit=True, donate=False,
                                 use_pallas=True, row_layout=True)
    t_fn = make_train_step(tm, *to)
    for b in _batches(2, seed=2):
        js, (_, jld) = j_fn(js, b)
        ts, (_, tld) = t_fn(ts, to_device(b, "cpu"))
        np.testing.assert_allclose(float(tld), float(jld), rtol=1e-5)
    _compare(js, ts, rtol=0, atol=5e-5, only=["[0]"])  # parameters
    tables = [f"/{p[1]}']" for p, _ in tm.table_specs.values()]
    _compare(js, ts, rtol=2e-2, atol=0.0, of_max=2.0**-7, only=tables)
