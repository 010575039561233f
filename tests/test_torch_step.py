"""The port's sparse Wide&Deep step (and the modules it runs) against
the JAX package on the same inputs.

The JAX side runs the streamed Pallas path in interpret mode
(``use_pallas=True``, never the generic ``use_pallas=False`` path,
whose packed update drops rows at some vocab sizes).  State is made
once in JAX and carried into the port by ``convert.state_from_jax``.
"""

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindrec_tpu.data import criteo as jcriteo
from mindrec_tpu.data import pipeline as jpipeline
from mindrec_tpu.models import wide_deep as jwd
from mindrec_tpu.ops.pallas import stream_update
from mindrec_tpu.train import optim as jopt
from mindrec_tpu.train import step as jstep
from mindrec_tpu_torch import convert
from mindrec_tpu_torch.data import criteo, pipeline
from mindrec_tpu_torch.data.criteo import SyntheticCriteo, to_device
from mindrec_tpu_torch.models import multitable, wide_deep
from mindrec_tpu_torch.train import optim
from mindrec_tpu_torch.train.step import (
    BucketOverflow, CapturedStep, make_batch_sort, make_eval_step,
    make_train_step, param_keys,
)

REPO = Path(__file__).resolve().parents[1]
KW = dict(batch_size=64, field_size=4, vocab_size=4000, emb_dim=16,
          deep_layer_dim=(32, 32), sparse=True, loss_scale=1024.0)


@pytest.fixture(autouse=True)
def _interpret_kernels():
    stream_update.INTERPRET = True
    yield
    stream_update.INTERPRET = False


def _setup(mixed: bool, **cfg_kw):
    """(jax model, jax state, jax opts, port model, port state, port opts)
    from one JAX init."""
    kw = {**KW, "use_mixed_precision": mixed, **cfg_kw}
    jm = jwd.WideDeepModel(jwd.WideDeepConfig(**kw))
    tm = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**kw))
    sd = "bfloat16" if mixed else "float32"
    jo = (jopt.ftrl(loss_scale=1024.0),
          jopt.lazy_adam(loss_scale=1024.0, state_dtype=getattr(jnp, sd)))
    to = (optim.ftrl(loss_scale=1024.0),
          optim.lazy_adam(loss_scale=1024.0, state_dtype=getattr(torch, sd)))
    js = jstep.init_train_state(jm, jax.random.PRNGKey(0), *jo)
    host = jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d))
    ts = convert.state_from_jax(*host, np.asarray(js.step), device="cpu")
    return jm, js, jo, tm, ts, to


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x, np.float32))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _compare(js, ts, rtol, atol, only=None):
    ref = _leaves(jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d)))
    got = _leaves(convert.state_to_jax(ts)[:3])
    assert [k for k, _ in ref] == [k for k, _ in got]
    for (k, a), (_, b) in zip(ref, got):
        if only is None or any(s in k for s in only):
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("prep", ["device_sort", "host_prep", "host_minimal"])
def test_step_matches_jax_f32(prep):
    """Three float32 steps: losses within rtol 1e-5; every parameter and
    optimizer leaf within rtol 1e-4 / atol 1e-8 (XLA and PyTorch sum the
    MLP's products and the batch means in other orders, ~1e-7 relative,
    which Adam's m/sqrt(v) can amplify a little)."""
    jm, js, jo, tm, ts, to = _setup(mixed=False)
    j_fn = jstep.make_train_step(jm, *jo, jit=True, donate=False,
                                 use_pallas=True, matmul_dtype=jnp.float32)
    t_fn = make_train_step(tm, *to, matmul_dtype=torch.float32)
    prep_fn = (None if prep == "device_sort"
               else make_batch_sort(4, minimal=prep == "host_minimal"))
    data = SyntheticCriteo(64, 4, 4000, seed=3)
    for i in range(3):
        b = data.get_batch(i)
        js, (jlw, jld) = j_fn(js, b)
        tb = to_device(prep_fn(b) if prep_fn else b, "cpu")
        ts, (tlw, tld) = t_fn(ts, tb)
        np.testing.assert_allclose(float(tlw), float(jlw), rtol=1e-5)
        np.testing.assert_allclose(float(tld), float(jld), rtol=1e-5)
    assert int(ts.step) == 3 and int(ts.opt_d["deep/table"]["step"]) == 3
    _compare(js, ts, rtol=1e-4, atol=1e-8)


def test_step_matches_jax_with_bucket():
    """An explicit unique bucket below the lossless B*F (the bench's
    shape) gives the reference's result."""
    jm, js, jo, tm, ts, to = _setup(mixed=False, batch_size=640)
    j_fn = jstep.make_train_step(jm, *jo, jit=True, donate=False,
                                 use_pallas=True, matmul_dtype=jnp.float32,
                                 unique_bucket=2048)
    t_fn = make_train_step(tm, *to, matmul_dtype=torch.float32,
                           unique_bucket=2048)
    data = SyntheticCriteo(640, 4, 4000, seed=5)
    for i in range(2):
        b = data.get_batch(i)
        js, (_, jld) = j_fn(js, b)
        ts, (_, tld) = t_fn(ts, to_device(b, "cpu"))
        np.testing.assert_allclose(float(tld), float(jld), rtol=1e-5)
    _compare(js, ts, rtol=1e-4, atol=1e-8)


def test_step_matches_jax_mixed_precision():
    """The production precision: bf16 MLP, bf16 rows and gradients
    (matmul_dtype bf16 on both sides), bf16 Adam moments.  Losses still
    agree to rtol 1e-5.  The states agree less closely, for two reasons:
    the bf16 gradient sums of the MLP are reduced in other orders by XLA
    and PyTorch (8-bit mantissas, with cancellation), and the reference
    rounds each summed table gradient to bf16 inside its one-hot matmul
    where the port keeps float32.  So weights are held to atol 5e-5 (a
    seventh of one Adam step of 3.5e-4) and the tables' optimizer state
    to rtol 2e-2 (a few bf16 roundings) with atol 1e-6."""
    jm, js, jo, tm, ts, to = _setup(mixed=True)
    j_fn = jstep.make_train_step(jm, *jo, jit=True, donate=False,
                                 use_pallas=True)
    t_fn = make_train_step(tm, *to)
    data = SyntheticCriteo(64, 4, 4000, seed=3)
    for i in range(3):
        b = data.get_batch(i)
        js, (jlw, jld) = j_fn(js, b)
        ts, (tlw, tld) = t_fn(ts, to_device(b, "cpu"))
        np.testing.assert_allclose(float(tld), float(jld), rtol=1e-5)
    assert ts.opt_d["deep/table"]["m"].dtype == torch.bfloat16
    _compare(js, ts, rtol=0, atol=5e-5, only=["['table']", "['w']", "['b']",
                                              "['bias']"])
    _compare(js, ts, rtol=2e-2, atol=1e-6,
             only=["'deep/table']['m']", "'deep/table']['v']",
                   "'wide/table']['accum']", "'wide/table']['linear']"])


def test_step_matches_jax_bf16_tables():
    """The reference's bf16-table bench extra (``table_dtype="bfloat16"``)
    at float32 precision, three steps: both sides round the same float32
    update into the bf16 tables, so the tables are equal bit for bit; the
    losses agree within 1 ulp and every other leaf within 1e-8."""
    jm, js, jo, tm, ts, to = _setup(mixed=False, table_dtype="bfloat16")
    assert ts.params["deep"]["table"].dtype == torch.bfloat16
    j_fn = jstep.make_train_step(jm, *jo, jit=True, donate=False,
                                 use_pallas=True, matmul_dtype=jnp.float32)
    t_fn = make_train_step(tm, *to, matmul_dtype=torch.float32)
    data = SyntheticCriteo(64, 4, 4000, seed=3)
    for i in range(3):
        b = data.get_batch(i)
        js, (jlw, jld) = j_fn(js, b)
        ts, (tlw, tld) = t_fn(ts, to_device(b, "cpu"))
        for t, j in ((tlw, jlw), (tld, jld)):
            np.testing.assert_array_max_ulp(np.float32(float(t)),
                                            np.float32(float(j)), maxulp=1)
    assert int(ts.step) == 3
    _compare(js, ts, rtol=0, atol=0, only=["['table']"])
    ref = _leaves(jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d)))
    got = _leaves(convert.state_to_jax(ts)[:3])
    for (k, a), (_, b) in zip(ref, got):
        if "['table']" not in k:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-8, err_msg=k)


def test_step_matches_jax_sgd_tables():
    """SGD on both tables (a scatter-add of the lane-expanded update; no
    kernel) gives the reference's result."""
    kw = {**KW, "use_mixed_precision": False}
    jm = jwd.WideDeepModel(jwd.WideDeepConfig(**kw))
    tm = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**kw))
    jo = (jopt.sgd(loss_scale=1024.0), jopt.sgd(loss_scale=1024.0))
    to = (optim.sgd(loss_scale=1024.0), optim.sgd(loss_scale=1024.0))
    js = jstep.init_train_state(jm, jax.random.PRNGKey(2), *jo)
    host = jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d))
    ts = convert.state_from_jax(*host, np.asarray(js.step), device="cpu")
    j_fn = jstep.make_train_step(jm, *jo, jit=True, donate=False,
                                 use_pallas=True, matmul_dtype=jnp.float32)
    t_fn = make_train_step(tm, *to, matmul_dtype=torch.float32)
    data = SyntheticCriteo(64, 4, 4000, seed=6)
    for i in range(2):
        b = data.get_batch(i)
        js, (_, jld) = j_fn(js, b)
        ts, (_, tld) = t_fn(ts, to_device(b, "cpu"))
        np.testing.assert_allclose(float(tld), float(jld), rtol=1e-5)
    _compare(js, ts, rtol=1e-4, atol=1e-8)


def test_plain_step_equals_kernel_step_on_cpu():
    """use_kernels=False calls the plain versions directly; on the CPU
    the wrappers take the same plain versions, so the states are equal."""
    *_, tm, ts, to = _setup(mixed=False)
    ts2 = convert.state_from_jax(*convert.state_to_jax(ts), device="cpu")
    a = make_train_step(tm, *to)
    b = make_train_step(tm, *to, use_kernels=False)
    data = SyntheticCriteo(64, 4, 4000, seed=9)
    for i in range(2):
        batch = to_device(data.get_batch(i), "cpu")
        ts, la = a(ts, batch)
        ts2, lb = b(ts2, batch)
        assert float(la[1]) == float(lb[1])
    for (_, x), (_, y) in zip(_leaves(convert.state_to_jax(ts)),
                              _leaves(convert.state_to_jax(ts2))):
        np.testing.assert_array_equal(x, y)


def test_check_overflow_keeps_state():
    """A non-finite gradient skips the update but advances the step (the
    reference's loss-scale overflow guard)."""
    *_, tm, ts, to = _setup(mixed=False)
    before = convert.state_to_jax(ts)
    fn = make_train_step(tm, *to, check_overflow=True)
    b = SyntheticCriteo(64, 4, 4000, seed=1).get_batch(0)
    b["wts"][0, 0] = np.inf
    ts, _ = fn(ts, to_device(b, "cpu"))
    after = convert.state_to_jax(ts)
    assert int(after[3]) == 1
    for (_, x), (_, y) in zip(_leaves(before[:3]), _leaves(after[:3])):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("change,ctor_kw", [
    ({"deep_table_slice_mode": "table_column_slice"}, {}),
    ({"deep_table_slice_mode": "table_row_slice"}, {}),
    ({}, {"row_layout": False}),  # row_packed tables on the column path
    ({"multitable": True, "sparse": True}, {"row_layout": False}),  # groups
])
def test_unported_branches_raise(change, ctor_kw):
    """A multi-group model on the feature-major streamed path raises.
    Row_packed tables under ``row_layout=False`` warn and take the
    generic path, as the reference does (``tests/test_torch_generic.py``
    holds it).  A sliced table without a mesh takes the plain streamed
    path, as in the reference; on a mesh ``jit=True`` captures it
    (``tests/test_torch_sharded_stream.py`` runs the mesh)."""
    change = dict(change)
    if change.pop("multitable", False):
        model = multitable.MultiTableWideDeepModel(
            multitable.MultiTableConfig(**change))
    else:
        model = wide_deep.WideDeepModel(
            wide_deep.WideDeepConfig(**{**KW, **change}))
    if "deep_table_slice_mode" in change:
        from mindrec_tpu_torch.parallel.mesh import Mesh

        assert model.deep_spec.feature_major
        fn = make_train_step(model, optim.ftrl(), optim.adam(), **ctor_kw)
        assert fn.__name__ == "step_rows"
        model.mesh = Mesh(2, 2)
        step = make_train_step(model, optim.ftrl(), optim.adam(), jit=True)
        assert isinstance(step, CapturedStep)
        assert step.step.__name__ == "step_rows"
        return
    if not change:
        with pytest.warns(UserWarning, match="generic path"):
            fn = make_train_step(model, optim.ftrl(), optim.adam(), **ctor_kw)
        assert fn.__name__ == "step_generic"
        return
    with pytest.raises(NotImplementedError):
        make_train_step(model, optim.ftrl(), optim.adam(), **ctor_kw)


def test_batch_sort_matches_reference():
    b = SyntheticCriteo(64, 4, 4000, seed=2).get_batch(0)
    want = jstep.make_batch_sort(4, native=False)(b)
    got = make_batch_sort(4)(b)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(BucketOverflow):
        make_batch_sort(4, unique_bucket=10)(b)


def test_eval_step_matches_jax():
    jm, js, _, tm, ts, _ = _setup(mixed=True)
    b = SyntheticCriteo(64, 4, 4000, seed=4).get_batch(0)
    jp, _ = jstep.make_eval_step(jm)(js.params, b)
    tp, lab = make_eval_step(tm)(ts.params, to_device(b, "cpu"))
    # bf16 MLP: XLA and PyTorch round the bf16 products' sums alike to
    # within a few bf16 ulps of the logits
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=2e-3)
    np.testing.assert_array_equal(lab.numpy(), b["label"])


@pytest.mark.parametrize("sparse", [True, False])
def test_forward_and_loss_match_jax(sparse):
    """apply_rows and loss, including the l2 term when not sparse."""
    jm, js, _, tm, ts, _ = _setup(mixed=False, sparse=sparse)
    rng = np.random.default_rng(0)
    wide = rng.normal(size=(64, 4, 1)).astype(np.float32)
    deep = rng.normal(size=(64, 4, 16)).astype(np.float32)
    wts = rng.uniform(size=(64, 4)).astype(np.float32)
    label = (rng.uniform(size=(64, 1)) > 0.5).astype(np.float32)
    jl = jm.apply_rows(js.params, {"wide": wide, "deep": deep}, wts)
    tl = tm.apply_rows(ts.params, {"wide": torch.from_numpy(wide),
                                   "deep": torch.from_numpy(deep)},
                       torch.from_numpy(wts))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-7)
    jloss = jm.loss(js.params, jl, label)
    tloss = tm.loss(ts.params, tl, torch.from_numpy(label))
    np.testing.assert_allclose([float(x) for x in tloss],
                               [float(x) for x in jloss], rtol=1e-5)
    assert param_keys(ts.params) == jstep.param_keys(js.params)


@pytest.mark.parametrize("kind", ["ftrl", "adam_float32", "adam_bfloat16", "sgd"])
def test_dense_optimizer_matches_jax(kind):
    rng = np.random.default_rng(1)
    p = rng.normal(size=(8, 5)).astype(np.float32)
    g = rng.normal(size=(8, 5)).astype(np.float32) * 100
    if kind == "ftrl":
        jo, to = jopt.ftrl(loss_scale=8.0), optim.ftrl(loss_scale=8.0)
    elif kind == "sgd":
        jo, to = jopt.sgd(loss_scale=8.0), optim.sgd(loss_scale=8.0)
    else:
        sd = kind.split("_")[1]
        jo = jopt.adam(loss_scale=8.0, state_dtype=getattr(jnp, sd))
        to = optim.adam(loss_scale=8.0, state_dtype=getattr(torch, sd))
    js, ts = jo.init_leaf(jnp.asarray(p)), to.init_leaf(torch.from_numpy(p))
    jp, tp = jnp.asarray(p), torch.from_numpy(p)
    for _ in range(3):
        jp, js = jo.update_leaf(jnp.asarray(g), js, jp)
        tp, ts = to.update_leaf(torch.from_numpy(g), ts, tp)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)
    assert sorted(ts) == sorted(js) if ts else js == ()
    for k in ts:
        np.testing.assert_allclose(ts[k].float().numpy(),
                                   np.asarray(js[k], np.float32), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
    assert jo.kind == to.kind and set(jo.hyper) <= set(to.hyper)


@pytest.mark.parametrize("fields", ["criteo", "uniform"])
def test_synthetic_criteo_and_bucket_match_reference(fields):
    np.testing.assert_array_equal(criteo.criteo_field_sizes(5_860_000),
                                  jcriteo.criteo_field_sizes(5_860_000))
    mine = SyntheticCriteo(128, 39, 100_000, seed=7, fields=fields)
    ref = jcriteo.SyntheticCriteo(128, 39, 100_000, seed=7, fields=fields)
    batches = [mine.get_batch(s) for s in range(2)]
    for s, b in enumerate(batches):
        want = ref.get_batch(s)
        for k in want:
            np.testing.assert_array_equal(b[k], want[k])
    got = pipeline.AdaptiveBucket.from_sample(batches).bucket
    want = jpipeline.AdaptiveBucket.from_sample(batches, log=lambda *a, **k: None).bucket
    assert got == want and pipeline.round_bucket(2049) == jpipeline.round_bucket(2049)


def test_convert_round_trip_keeps_dtypes():
    _, js, _, _, ts, _ = _setup(mixed=True)
    assert ts.opt_d["deep/table"]["v"].dtype == torch.bfloat16
    assert ts.opt_d["deep/table"]["step"].dtype == torch.int32
    back = convert.state_to_jax(ts)
    ref = jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d))
    for x, y in zip(jax.tree.leaves(back[:3]), jax.tree.leaves(ref)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_port_imports_no_jax():
    """Neither the package nor chip_smoke.py imports jax or mindrec_tpu:
    by source text, and by the modules a fresh interpreter has loaded
    after importing every module of the package and the script.  No file
    of either names the JAX package's native directory or its table
    server's binary (the port builds and runs its own server).  The
    package's launch scripts and yaml files name neither jax nor the JAX
    package, and their commands run the port's own drivers, never a
    file under the reference's ``examples/``."""
    port = REPO / "mindrec_tpu_torch"
    for f in sorted([*port.rglob("*.sh"), *port.rglob("*.yaml")]):
        text = f.read_text()
        assert not re.search(r"\bjax\b", text), f"{f} names jax"
        assert not re.search(r"\bmindrec_tpu\b(?!_torch)", text), \
            f"{f} names the JAX package"
        for line in text.splitlines():
            if not line.lstrip().startswith("#"):
                assert "examples/" not in line, f"{f}: {line}"
    for f in [REPO / "chip_smoke.py", *sorted(
            p for p in port.rglob("*") if p.is_file()
            and "_build" not in p.relative_to(port).parts
            and p.suffix in (".py", ".cc", ".h", ".cu", ".cuh"))]:
        text = f.read_text()
        for name in ("mindrec_tpu/native", "mindrec_table_server"):
            assert name not in text, f"{f} names {name}"
    files = sorted((REPO / "mindrec_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert not mod.startswith("jax"), f"{f}: {s}"
                assert mod.split(".")[0] != "mindrec_tpu", f"{f}: {s}"
    code = (
        "import importlib, pkgutil, runpy, sys\n"
        "import mindrec_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mindrec_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
