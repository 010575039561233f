"""The overflow guard (``check_overflow=True``) runs on the device: the
guarded step makes no host read, and after an ``inf`` batch its state
equals the JAX guarded step's (``_guard``: parameters and all optimizer
state kept, the step advanced)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindrec_tpu.models import wide_deep as jwd
from mindrec_tpu.ops.pallas import stream_update
from mindrec_tpu.train import optim as jopt
from mindrec_tpu.train import step as jstep
from mindrec_tpu_torch import convert
from mindrec_tpu_torch.data.criteo import SyntheticCriteo, to_device
from mindrec_tpu_torch.models import wide_deep
from mindrec_tpu_torch.train import optim
from mindrec_tpu_torch.train.step import make_train_step

KW = dict(batch_size=64, field_size=4, vocab_size=4000, emb_dim=16,
          deep_layer_dim=(32, 32), sparse=True, loss_scale=1024.0,
          use_mixed_precision=False)
HOST_READS = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__",
              "__index__")


@pytest.fixture(autouse=True)
def _interpret_kernels():
    stream_update.INTERPRET = True
    try:
        yield
    finally:
        stream_update.INTERPRET = False


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    """Every way a tensor's value reaches Python raises while open."""
    with monkeypatch.context() as m:
        for name in HOST_READS:
            def read(*_a, _name=name, **_k):
                raise AssertionError(f"host read: Tensor.{_name}")
            m.setattr(torch.Tensor, name, read)
        yield


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x, np.float32))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("bad", [np.inf, np.nan])
def test_guarded_step_reads_nothing_on_host_and_matches_jax(bad, monkeypatch):
    jm = jwd.WideDeepModel(jwd.WideDeepConfig(**KW))
    tm = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**KW))
    jo = (jopt.ftrl(loss_scale=1024.0), jopt.lazy_adam(loss_scale=1024.0))
    to = (optim.ftrl(loss_scale=1024.0), optim.lazy_adam(loss_scale=1024.0))
    js = jstep.init_train_state(jm, jax.random.PRNGKey(0), *jo)
    host = jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d))
    ts = convert.state_from_jax(*host, np.asarray(js.step), device="cpu")
    j_fn = jstep.make_train_step(jm, *jo, jit=True, donate=False,
                                 use_pallas=True, matmul_dtype=jnp.float32,
                                 check_overflow=True)
    t_fn = make_train_step(tm, *to, matmul_dtype=torch.float32,
                           check_overflow=True)
    data = SyntheticCriteo(64, 4, 4000, seed=8)
    for i in range(3):
        b = data.get_batch(i)
        if i == 1:
            b["wts"][3, 2] = bad
            before = convert.state_to_jax(ts)
        js, _ = j_fn(js, b)
        tb = to_device(b, "cpu")
        with _no_host_reads(monkeypatch):
            with pytest.raises(AssertionError, match="host read"):
                bool(tb["wts"].isfinite().all())  # the patch holds
            ts, _ = t_fn(ts, tb)
        if i == 1:  # every leaf kept, Adam's table step included
            after = convert.state_to_jax(ts)
            for (k, x), (_, y) in zip(_leaves(before[:3]), _leaves(after[:3])):
                np.testing.assert_array_equal(x, y, err_msg=k)
            ref = _leaves(jax.tree.map(np.asarray,
                                       (js.params, js.opt_w, js.opt_d)))
            for (k, x), (_, y) in zip(ref, _leaves(after[:3])):
                np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-8,
                                           err_msg=k)
    assert int(ts.step) == int(js.step) == 3
    assert int(ts.opt_d["deep/table"]["step"]) == 2
    ref = _leaves(jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d)))
    for (k, x), (_, y) in zip(ref, _leaves(convert.state_to_jax(ts)[:3])):
        np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-8, err_msg=k)
