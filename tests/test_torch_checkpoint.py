"""The port's checkpoints (``mindrec_tpu_torch/io/checkpoint.py``)
against the JAX package's on the CPU.

States are made in JAX, every leaf filled from a seeded numpy generator
(bf16 leaves rounded from float32 draws), and carried into the port by
``convert.state_from_jax``.  Files written by one side are read by the
other: reference save -> port restore (bf16 moments included, which the
reference's own restore cannot read back, and a checkpoint saved sliced
on the 8-device mesh), port save -> reference restore (f32 states), and
for bf16 states the raw npz entries of both sides, key for key.  Every
comparison is exact.  Then the file names, retention, async saves, the
callback's global-step numbering and resume through ``RecModel``: k
steps, restore, N - k steps equal N steps straight, bit for bit, with
dropout on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mindrec_tpu.io import checkpoint as jckpt
from mindrec_tpu.models import deepfm as jfm
from mindrec_tpu.models import multitable as jmt
from mindrec_tpu.models import wide_deep as jwd
from mindrec_tpu.train import optim as jopt
from mindrec_tpu.train import step as jstep
from mindrec_tpu_torch import RecModel, convert
from mindrec_tpu_torch.data.criteo import SyntheticCriteo
from mindrec_tpu_torch.io import checkpoint
from mindrec_tpu_torch.models import wide_deep
from mindrec_tpu_torch.train import optim
from mindrec_tpu_torch.train.callbacks import CheckpointCallback

WD = dict(batch_size=16, field_size=4, vocab_size=3000, emb_dim=16,
          deep_layer_dim=(8, 8), sparse=True, use_mixed_precision=True)
FM = dict(batch_size=16, field_size=5, vocab_size=2000, emb_dim=8,
          deep_layer_dim=(8,), sparse=True, table_layout="feature_major")
MT = dict(batch_size=32, continue_field_size=4, indicator_field_size=2,
          emb128_field_size=2, emb64_single_field_size=2,
          multi_hot_sizes=(3, 4, 3, 2, 2, 3), emb_128_size=3000,
          emb64_single_size=50, emb64_multi_size=2500, indicator_size=16,
          deep_layer_dim=(32, 16), loss_scale=1000.0, sparse=True,
          use_mixed_precision=False)


def _jax_state(kind: str, state_dtype=jnp.bfloat16, seed: int = 0):
    """A JAX TrainState of ``kind`` with every leaf drawn from a seeded
    generator (the key kept), as numpy."""
    if kind == "wd":
        jm = jwd.WideDeepModel(jwd.WideDeepConfig(**WD))
    elif kind == "deepfm":
        jm = jfm.DeepFMModel(jfm.DeepFMConfig(**FM))
    else:
        jm = jmt.MultiTableWideDeepModel(jmt.MultiTableConfig(**MT))
    opts = (jopt.ftrl(), jopt.lazy_adam(state_dtype=state_dtype))
    js = jstep.init_train_state(jm, jax.random.PRNGKey(seed), *opts)
    rng = np.random.default_rng(seed + 1)

    def fill(x):
        a = np.asarray(x)
        if a.dtype == np.uint32:  # the key
            return a
        if a.dtype.kind == "i":
            return rng.integers(0, 50, a.shape).astype(a.dtype)
        return rng.normal(size=a.shape).astype(np.float32).astype(a.dtype)

    return jax.tree.map(fill, js)


def _port_state(js):
    """The port's counterpart of a numpy JAX state, the key carried as
    its two words."""
    ts = convert.state_from_jax(js.params, js.opt_w, js.opt_d,
                                np.asarray(js.step), device="cpu")
    return ts._replace(rng=torch.from_numpy(
        np.asarray(js.rng).astype(np.int64)))


def _assert_equal(a, b):
    fa, fb = checkpoint.flatten_state(a), checkpoint.flatten_state(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.device == y.device, k
        assert torch.equal(x, y), k


def _zeros_like(ts):
    """A template with the state's structure, dtypes and devices."""
    return checkpoint._rebuild(
        ts, iter(torch.zeros_like(t) for _k, t in checkpoint.flatten_state(ts)))


@pytest.mark.parametrize("kind", ["wd", "deepfm", "multitable"])
def test_reference_save_port_restore(kind, tmp_path):
    js = _jax_state(kind)
    path = jckpt.save_checkpoint(tmp_path, js, step=7)
    want = _port_state(js)
    got = checkpoint.restore_checkpoint(path, _zeros_like(want))
    _assert_equal(got, want)


def test_reference_sliced_save_port_restore(tmp_path, mesh8):
    """A checkpoint the reference saved sliced across the 8-device mesh
    (tables row-sharded, the rest replicated) restores whole."""
    js = _jax_state("wd")
    rows = NamedSharding(mesh8, P("data", None))
    rep = NamedSharding(mesh8, P())
    sharded = jax.tree.map(
        lambda a: jax.device_put(a, rows if a.ndim == 2 and a.shape[0] % 4 == 0
                                 else rep), js)
    path = jckpt.save_checkpoint(tmp_path, sharded, step=3, force_sliced=True)
    names = np.load(path).files
    assert any("@@shard" in n for n in names)
    want = _port_state(js)
    got = checkpoint.restore_checkpoint(path, _zeros_like(want))
    _assert_equal(got, want)
    merged = checkpoint.merge_sliced([path], _zeros_like(want))
    _assert_equal(merged, want)


@pytest.mark.parametrize("kind", ["wd", "deepfm", "multitable"])
def test_port_save_reference_restore_f32(kind, tmp_path):
    js = _jax_state(kind, state_dtype=jnp.float32)
    ts = _port_state(js)
    path = checkpoint.save_checkpoint(tmp_path, ts, step=5)
    like = jax.tree.map(np.zeros_like, js)
    back = jckpt.restore_checkpoint(path, like)
    params, opt_w, opt_d, step = convert.state_to_jax(ts)
    want = jstep.TrainState(params, opt_w, opt_d, step, np.asarray(js.rng))
    got_l = jax.tree_util.tree_flatten_with_path(back)[0]
    want_l = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (p, g), (_, w) in zip(got_l, want_l):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w), p


@pytest.mark.parametrize("kind", ["wd", "deepfm", "multitable"])
def test_port_bf16_entries_equal_reference(kind, tmp_path):
    """The same bf16 state saved by each side: the same file name, keys
    in the same order, and every entry (the index included) equal in
    dtype, shape and bytes."""
    js = _jax_state(kind)
    ref = jckpt.save_checkpoint(tmp_path / "ref", js, step=12)
    got = checkpoint.save_checkpoint(tmp_path / "port", _port_state(js),
                                     step=12)
    assert ref.rsplit("/", 1)[1] == got.rsplit("/", 1)[1] == \
        "ckpt-0000000012-r0.npz"
    zr, zg = np.load(ref), np.load(got)
    assert zr.files == zg.files
    assert any(zr[k].dtype == np.dtype("V2") for k in zr.files)
    for k in zr.files:
        a, b = zr[k], zg[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def test_retention_and_latest_match_reference(tmp_path):
    js = _jax_state("wd", state_dtype=jnp.float32)
    ts = _port_state(js)
    for step in (3, 1, 4, 2):
        jckpt.save_checkpoint(tmp_path / "ref", js, step=step, keep_max=2)
        checkpoint.save_checkpoint(tmp_path / "port", ts, step=step,
                                   keep_max=2)
    names = [sorted(f.name for f in (tmp_path / d).iterdir())
             for d in ("ref", "port")]
    # the two highest steps stay, whatever the order of the saves
    assert names[0] == names[1] == ["ckpt-0000000003-r0.npz",
                                    "ckpt-0000000004-r0.npz"]
    lr = jckpt.latest_checkpoint(tmp_path / "ref")
    lp = checkpoint.latest_checkpoint(tmp_path / "port")
    assert lr[1] == lp[1] == 4
    assert checkpoint.latest_checkpoint(tmp_path / "none") == (None, -1)


def test_async_equals_sync(tmp_path):
    ts = _port_state(_jax_state("wd"))
    sync = checkpoint.save_checkpoint(tmp_path / "sync", ts, step=2)
    with checkpoint.AsyncCheckpointer() as ac:
        fut = ac.save(tmp_path / "async", ts, step=2)
        # the snapshot is taken: changing the state now changes no file
        ts.params["deep"]["table"].add_(1.0)
        path = ac.wait_until_finished()
    assert fut.result() == path
    za, zs = np.load(path), np.load(sync)
    assert za.files == zs.files
    for k in za.files:
        assert za[k].tobytes() == zs[k].tobytes(), k


def test_unported_options_raise(tmp_path):
    ts = _port_state(_jax_state("wd", state_dtype=jnp.float32))
    with pytest.raises(NotImplementedError, match="item 9"):
        checkpoint.save_checkpoint(tmp_path, ts, step=0, force_sliced=True)
    path = checkpoint.save_checkpoint(tmp_path, ts, step=0)
    with pytest.raises(NotImplementedError, match="item 9"):
        checkpoint.restore_checkpoint(path, ts, shardings=object())
    bad = ts._replace(step=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\.step"):
        checkpoint.restore_checkpoint(path, bad)


# ---------------------------------------------------------------------------
# the callback and resume through RecModel
# ---------------------------------------------------------------------------

SMALL = dict(batch_size=16, field_size=4, vocab_size=500, emb_dim=8,
             deep_layer_dim=(16, 8), use_mixed_precision=False)


def _rec(kind: str, seed: int) -> RecModel:
    if kind == "dense_dropout":
        m = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(
            **SMALL, dropout_flag=True, keep_prob=0.9))
        return RecModel(m, seed=seed, device="cpu")
    m = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**SMALL, sparse=True))
    return RecModel(m, optim.ftrl(), optim.lazy_adam(
        state_dtype=torch.bfloat16), seed=seed, unique_bucket=64,
        device="cpu")


@pytest.mark.parametrize("kind", ["dense_dropout", "sparse_bucket"])
def test_resume_through_rec_model_is_bit_identical(kind, tmp_path):
    """N steps straight == k steps, a checkpoint, a fresh RecModel (another
    seed) restored from it, N - k steps; the sparse model runs the
    host-prep pipeline, whose bucket restarts fresh after the restore."""
    batches = list(SyntheticCriteo(16, 4, 500, steps=6, seed=3))
    straight = _rec(kind, 0)
    straight.train(1, batches)
    first = _rec(kind, 0)
    cb = CheckpointCallback(str(tmp_path), save_steps=3, async_save=True)
    first.train(1, batches[:3], callbacks=[cb])
    path, step = checkpoint.latest_checkpoint(tmp_path)
    assert step == 3 and cb.saved == [path]
    resumed = _rec(kind, 1)
    resumed.state = checkpoint.restore_checkpoint(path, resumed.state)
    resumed.train(1, batches[3:])
    _assert_equal(resumed.state, straight.state)


def test_checkpoint_callback_numbers_by_global_step(tmp_path):
    """Files are named by the state's step (here from a restored state at
    step 10), retention keeps ``keep_max``, and one async callback serves
    two ``train`` calls."""
    rm = _rec("sparse_bucket", 0)
    rm.state = rm.state._replace(step=torch.tensor(10, dtype=torch.int32))
    batches = list(SyntheticCriteo(16, 4, 500, steps=4, seed=5))
    cb = CheckpointCallback(str(tmp_path), save_steps=1, keep_max=3,
                            async_save=True)
    rm.train(1, batches[:2], callbacks=[cb])
    rm.train(1, batches[2:], callbacks=[cb])
    names = sorted(f.name for f in tmp_path.iterdir())
    assert names == [f"ckpt-{s:010d}-r0.npz" for s in (12, 13, 14)]
    assert [p.rsplit("-", 2)[1] for p in cb.saved] == [
        f"{s:010d}" for s in (11, 12, 13, 14)]
    back = checkpoint.restore_checkpoint(str(tmp_path / names[-1]), rm.state)
    _assert_equal(back, rm.state)
