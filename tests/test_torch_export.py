"""The port's serving exports against the JAX package's on the CPU:
MREC1 (``io/export.py``), the C++ client (``serving/infer_client.cc``,
built here with g++), ONNX (``io/onnx.py``) and its runner
(``serving/onnx_ref.py``), ``records2bin`` and ``ExportCallback``.

Parameters are made in JAX and carried into the port by
``convert.state_from_jax``.  Files are compared byte for byte.  For
row_packed and feature-major models the reference's MREC1 writes the
storage layout (its client then reads a packed table 128 wide), so the
port's file is held against the reference's export of the same params
with each table replaced by the reference's ``from_storage`` output.
Float comparisons: the client prints 6 significant digits and sums in
its own order (1e-5); the ONNX runners run the same float32 ops (1e-6).
"""

import jax
import numpy as np
import pytest
import torch

from mindrec_tpu.data import criteo as jcriteo
from mindrec_tpu.io import export as jexport
from mindrec_tpu.io import onnx as jonnx
from mindrec_tpu.models import dcn as jdcn
from mindrec_tpu.models import deepfm as jfm
from mindrec_tpu.models import multitable as jmt
from mindrec_tpu.models import wide_deep as jwd
from mindrec_tpu.ops import embedding as jemb
from mindrec_tpu.serving import onnx_ref as jonnx_ref
from mindrec_tpu.serving import records2bin as jr2b
from mindrec_tpu_torch import RecModel, convert
from mindrec_tpu_torch.data.criteo import SyntheticCriteo
from mindrec_tpu_torch.io import export, onnx
from mindrec_tpu_torch.models import dcn, deepfm, multitable, wide_deep
from mindrec_tpu_torch.ops.embedding import to_storage
from mindrec_tpu_torch.serving import client, onnx_ref, records2bin
from mindrec_tpu_torch.train.callbacks import ExportCallback
from test_onnx_export import _make, det_params

F32 = dict(use_mixed_precision=False)
CONFIGS = {
    # (kind, reference module, port module, config class, model class, kw)
    "wd_dense": ("wide_deep", jwd, wide_deep, "WideDeepConfig",
                 "WideDeepModel", dict(batch_size=8, field_size=5,
                                       vocab_size=300, emb_dim=8,
                                       deep_layer_dim=(16, 8), **F32)),
    "wd_packed": ("wide_deep", jwd, wide_deep, "WideDeepConfig",
                  "WideDeepModel", dict(batch_size=8, field_size=5,
                                        vocab_size=1000, emb_dim=16,
                                        deep_layer_dim=(8,), sparse=True,
                                        **F32)),
    "deepfm_dense": ("deepfm", jfm, deepfm, "DeepFMConfig", "DeepFMModel",
                     dict(batch_size=8, field_size=5, vocab_size=300,
                          emb_dim=6, deep_layer_dim=(8,), **F32)),
    "deepfm_fm": ("deepfm", jfm, deepfm, "DeepFMConfig", "DeepFMModel",
                  dict(batch_size=8, field_size=5, vocab_size=700, emb_dim=8,
                       deep_layer_dim=(8,), sparse=True,
                       table_layout="feature_major", **F32)),
    "dcn_dense": ("dcn", jdcn, dcn, "DCNConfig", "DCNModel",
                  dict(batch_size=8, field_size=5, vocab_size=300, emb_dim=6,
                       deep_layer_dim=(8, 8), cross_layer_num=3)),
    "multitable": ("multitable", jmt, multitable, "MultiTableConfig",
                   "MultiTableWideDeepModel",
                   dict(batch_size=8, continue_field_size=4,
                        indicator_field_size=2, emb128_field_size=1,
                        emb64_single_field_size=2,
                        multi_hot_sizes=(2, 3, 2, 2, 2, 2), emb_128_size=100,
                        emb64_single_size=50, emb64_multi_size=60,
                        deep_layer_dim=(16, 8), sparse=True, **F32)),
}
CRITEO = [k for k in CONFIGS if k != "multitable"]


def _models(name, seed=3):
    """(kind, JAX model, numpy params, port model, port params)."""
    kind, jmod, tmod, cfg, cls, kw = CONFIGS[name]
    jm = getattr(jmod, cls)(getattr(jmod, cfg)(**kw))
    tm = getattr(tmod, cls)(getattr(tmod, cfg)(**kw))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    return kind, jm, jp, tm, _port(jp)


def _port(jp):
    return convert.state_from_jax(jp, {}, {}, 0, device="cpu").params


def _batch(name, B=8, seed=0):
    rng = np.random.default_rng(seed)
    c = CONFIGS[name][-1]
    if name != "multitable":
        F, V = c["field_size"], c["vocab_size"]
        return {"ids": rng.integers(0, V, (B, F)).astype(np.int32),
                "wts": rng.uniform(0.5, 1.5, (B, F)).astype(np.float32)}
    b = {"continue_val": rng.uniform(size=(B, 4)).astype(np.float32),
         "indicator_id": rng.integers(0, 16, (B, 2)).astype(np.int32),
         "emb_128_id": rng.integers(0, 100, (B, 1)).astype(np.int32),
         "emb_64_single_id": rng.integers(0, 50, (B, 2)).astype(np.int32)}
    for f, L in zip(multitable.MULTI_FIELDS, c["multi_hot_sizes"]):
        b[f"multi_{f}_id"] = rng.integers(0, 60, (B, L)).astype(np.int32)
        lens = rng.integers(1, L + 1, B)
        b[f"multi_{f}_mask"] = (np.arange(L)[None, :] < lens[:, None]
                                ).astype(np.float32)
    return b


def _predict(tm, tp, name, batch):
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    if name == "multitable":
        return tm.predict(tp, t).numpy().reshape(-1)
    return tm.predict(tp, t["ids"], t["wts"]).numpy().reshape(-1)


def _ref_logical(jm, jp):
    """The reference's params with every table as its ``from_storage``."""
    out = jax.tree.map(lambda x: x, jp)
    for path, spec in jm.table_specs.values():
        node = out
        for h in path[:-1]:
            node = node[h]
        node[path[-1]] = np.asarray(jemb.from_storage(spec, node[path[-1]]))
    return out


# ---------------------------------------------------------------------------
# MREC1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CRITEO)
def test_mrec1_bytes_match_reference(name, tmp_path):
    kind, jm, jp, tm, tp = _models(name)
    got = export.export_model(tmp_path / "port.mrec", kind, tp, tm)
    packed = any(s.row_packed or s.feature_major
                 for _p, s in jm.table_specs.values())
    ref_params = _ref_logical(jm, jp) if packed else jp
    ref = jexport.export_model(tmp_path / "ref.mrec", kind, ref_params)
    assert open(got, "rb").read() == open(ref, "rb").read()
    zg, zr = np.load(got + ".npz"), np.load(ref + ".npz")
    assert zg.files == zr.files
    for k in zg.files:
        assert zg[k].dtype == zr[k].dtype and zg[k].tobytes() == zr[k].tobytes()
    k2, tensors = export.load_model(got)
    assert k2 == kind
    for _name, (path, spec) in tm.table_specs.items():
        assert tensors["/".join(path)].shape == (spec.padded_vocab,
                                                 spec.emb_dim)


def _fault2_model():
    """W&D sparse=True (row_packed, vocab 1,000, emb 16, MLP (8,), f32):
    deep table N(0, 1), wide table zero, MLP x10."""
    kind, jm, jp, tm, _tp = _models("wd_packed", seed=0)
    spec = tm.table_specs["deep"][1]
    rng = np.random.default_rng(7)
    logical = torch.from_numpy(
        rng.normal(size=(spec.padded_vocab, spec.emb_dim)).astype(np.float32))
    jp["deep"]["table"] = to_storage(spec, logical).numpy()
    jp["wide"]["table"] = np.zeros_like(jp["wide"]["table"])
    for layer in jp["deep"]["mlp"]:
        layer["w"] = layer["w"] * 10.0
        layer["b"] = layer["b"] * 10.0
    return kind, jp, tm, _port(jp)


def test_client_agrees_with_predict_on_packed_tables(tmp_path):
    """The port's export of a row_packed model serves through the client
    within 1e-5 of ``predict``; the reference's export of the same model
    gives the client the storage layout and misses by far more."""
    kind, jp, tm, tp = _fault2_model()
    b = _batch("wd_packed", B=64, seed=4)
    want = _predict(tm, tp, "wd_packed", b)
    port_file = export.export_model(tmp_path / "port.mrec", kind, tp, tm)
    got, ms = client.run_client(port_file, b["ids"], b["wts"])
    assert np.abs(got - want).max() < 1e-5 and ms >= 0.0
    ref_file = jexport.export_model(tmp_path / "ref.mrec", kind, jp)
    off, _ = client.run_client(ref_file, b["ids"], b["wts"])
    assert np.abs(off - want).max() > 1e-2


@pytest.mark.parametrize("name", ["wd_dense", "deepfm_fm", "deepfm_dense",
                                  "dcn_dense"])
def test_client_agrees_with_predict(name, tmp_path):
    kind, _jm, _jp, tm, tp = _models(name)
    b = _batch(name, B=32, seed=5)
    path = export.export_model(tmp_path / "m.mrec", kind, tp, tm)
    got, _ = client.run_client(path, b["ids"], b["wts"])
    np.testing.assert_allclose(got, _predict(tm, tp, name, b), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# ONNX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_onnx_bytes_and_runner_match_reference(name, tmp_path):
    kind, jm, jp, tm, tp = _models(name)
    got = open(onnx.export_onnx(tmp_path / "p.onnx", kind, tm, tp), "rb").read()
    ref = open(jonnx.export_onnx(tmp_path / "r.onnx", kind, jm, jp),
               "rb").read()
    assert got == ref
    b = _batch(name)
    out = onnx_ref.run_onnx(got, b, device="cpu")["prob"]
    assert out.device.type == "cpu" and out.shape == (8, 1)
    want = jonnx_ref.run_onnx(ref, b)["prob"]
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.numpy().reshape(-1),
                               _predict(tm, tp, name, b), rtol=0, atol=1e-6)
    m = onnx_ref.load_onnx(got)
    assert m["opset"] == 11 and m["outputs"] == ["prob"]


@pytest.mark.parametrize("kind", ["wide_deep", "deepfm", "dcn"])
def test_onnx_matches_golden(kind, tmp_path):
    """The committed goldens of ``tests/test_onnx_export.py``
    (deterministic parameters) from the port's writer."""
    import pathlib

    jm = _make(kind)
    jp = jax.tree.map(np.asarray, det_params(jm))
    tm = {"wide_deep": wide_deep.WideDeepModel, "deepfm": deepfm.DeepFMModel,
          "dcn": dcn.DCNModel}[kind]
    cfg_cls = type(jm.config).__name__
    tmod = {"wide_deep": wide_deep, "deepfm": deepfm, "dcn": dcn}[kind]
    kw = {f: getattr(jm.config, f) for f in ("batch_size", "field_size",
                                            "vocab_size", "emb_dim",
                                            "deep_layer_dim",
                                            "use_mixed_precision")}
    if kind == "dcn":
        kw["cross_layer_num"] = jm.config.cross_layer_num
    model = tm(getattr(tmod, cfg_cls)(**kw))
    data = open(onnx.export_onnx(tmp_path / "g.onnx", kind, model,
                                 _port(jp)), "rb").read()
    golden = pathlib.Path(__file__).parent / "golden" / f"{kind}.onnx"
    assert data == golden.read_bytes()


# ---------------------------------------------------------------------------
# records2bin and ExportCallback
# ---------------------------------------------------------------------------


def test_records2bin_matches_reference(tmp_path):
    n = records2bin.convert(SyntheticCriteo(1000, 39, 200000, steps=2,
                                            seed=999), tmp_path / "port")
    jr2b.convert(jcriteo.SyntheticCriteo(1000, 39, 200000, steps=2, seed=999),
                 tmp_path / "ref")
    records2bin.main(["--synthetic", "--out", str(tmp_path / "pm"),
                      "--batch-size", "100", "--max-batches", "2"])
    jr2b.main(["--synthetic", "--out", str(tmp_path / "rm"),
               "--batch-size", "100", "--max-batches", "2"])
    assert n == 2
    for a, b in (("port", "ref"), ("pm", "rm")):
        names = sorted(f.name for f in (tmp_path / a).iterdir())
        assert names == sorted(f.name for f in (tmp_path / b).iterdir())
        assert names == ["ids_0.bin", "ids_1.bin", "labels.txt",
                         "wts_0.bin", "wts_1.bin"]
        for f in names:
            assert (tmp_path / a / f).read_bytes() == \
                (tmp_path / b / f).read_bytes(), f
    # --data reads packed shards (tests/test_torch_formats.py converts
    # shards against the reference's); a directory without shards raises
    with pytest.raises(FileNotFoundError, match="part-"):
        records2bin.main(["--data", str(tmp_path), "--out",
                          str(tmp_path / "x")])


def test_export_callback(tmp_path):
    """MREC1 + sidecar + ONNX every step, named by the global step, the
    newest two kept, ``-latest`` pointing at the newest; the latest file
    serves through the client like ``predict``."""
    kw = {**CONFIGS["wd_packed"][-1], "batch_size": 16}
    model = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**kw))
    rm = RecModel(model, device="cpu")
    cb = ExportCallback(str(tmp_path), "wide_deep", export_steps=1,
                        keep_max=2, onnx_model=model)
    rm.train(1, list(SyntheticCriteo(16, 5, 1000, steps=3, seed=1)),
             callbacks=[cb])
    names = sorted(f.name for f in tmp_path.iterdir())
    assert names == [f"model-{s:010d}.{ext}" for s in (2, 3)
                     for ext in ("mrec", "mrec.npz", "onnx")] + [
        "model-latest"]
    latest = tmp_path / "model-latest"
    assert latest.is_symlink() and latest.resolve().name == \
        "model-0000000003.mrec"
    b = _batch("wd_packed", B=16, seed=6)
    want = _predict(model, rm.state.params, "wd_packed", b)
    got, _ = client.run_client(latest, b["ids"], b["wts"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # MREC1 alone: the model gives the tables' specs, no ONNX is written
    only = ExportCallback(str(tmp_path / "mrec"), "wide_deep",
                          export_steps=1, model=model)
    rm.train(1, [SyntheticCriteo(16, 5, 1000, steps=1, seed=2).get_batch(0)],
             callbacks=[only])
    assert sorted(f.name for f in (tmp_path / "mrec").iterdir()) == [
        "model-0000000004.mrec", "model-0000000004.mrec.npz", "model-latest"]
    with pytest.raises(ValueError, match="model="):
        ExportCallback(str(tmp_path), "wide_deep")
