"""The port's drivers (``mindrec_tpu_torch/examples/``) on the CPU at a
tiny width: each ``main(argv)`` with ``--device cpu`` through every
single-card branch of ``train_criteo`` (dense, sparse, the dynamic,
cache and host-target regimes, device prep, DeepFM, DCN), checkpoints,
``--resume``, ``FaultInjector``, ``--save_graphs`` and
``--enable_profiling``; ``eval_criteo`` on ``train_criteo``'s
checkpoint; the Outbrain, TB-scale, online, Kafka-producer and accuracy
drivers; the launch scripts through bash; the multi-card branches
(``run_distribute_train.sh`` with 4 gloo ranks on a (2, 2) mesh, sliced
checkpoints and ``--resume``, ``field_slice``, the Outbrain driver on 2
ranks) and what still raises naming ROADMAP.md section 1 item 9 (the
placement regimes on several workers)."""

import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mindrec_tpu_torch.examples import (
    accuracy_run, eval_criteo, kafka_producer, online_train, train_criteo,
    train_outbrain, train_terabyte,
)

REPO = Path(__file__).resolve().parents[1]
LAUNCH = REPO / "mindrec_tpu_torch" / "examples"
TINY = ["--device", "cpu", "--batch_size", "32", "--vocab_size", "2000",
        "--emb_dim", "8", "--deep_layer_dim", "[16, 8]", "--epochs", "1",
        "--steps_per_epoch", "2"]


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    """Every driver writes its logs, checkpoints and spill files into the
    test's own directory."""
    monkeypatch.chdir(tmp_path)
    for k in ("MR_WORKER_NUM", "MR_SCHED_HOST", "MR_SERVER_HOSTS",
              "MINDREC_CRASH_AT_STEP", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)


def _auc_ok(metrics):
    return 0.0 <= metrics["auc"] <= 1.0 and math.isfinite(metrics["auc"])


@pytest.mark.parametrize("extra", [
    [], ["--sparse", "1"], ["--dynamic_embedding", "1"],
    ["--sparse", "1", "--vocab_cache_size", "1024"],
    ["--parameter_server", "1"],
    ["--sparse", "1", "--unique_bucket", "256", "--prep_placement", "device"],
    ["--model", "deepfm", "--sparse", "1"], ["--model", "dcn"],
], ids=["dense", "sparse", "dynamic", "cache", "host_target", "device_prep",
        "deepfm", "dcn"])
def test_train_criteo_branches(extra, capsys):
    metrics = train_criteo.main(TINY + extra)
    assert _auc_ok(metrics)
    out = capsys.readouterr().out
    assert "final metrics" in out and "epoch: 1, auc:" in out
    assert "auc" in Path("eval.log").read_text()
    if "--dynamic_embedding" in extra:  # plain specs: the generic path
        assert "step=step_generic" in out


def test_train_criteo_checkpoints_resume_and_eval(capsys):
    """Checkpoints every step, the ``--save_graphs`` dump and a profiler
    trace; ``--resume`` picks the latest file; ``eval_criteo`` on it
    reports the AUC training ended with."""
    want = train_criteo.main(TINY + ["--ckpt_interval", "1", "--save_graphs",
                                     "--enable_profiling"])
    assert sorted(p.name for p in Path("ckpt").iterdir()) == [
        "ckpt-0000000001-r0.npz", "ckpt-0000000002-r0.npz"]
    ops = Path("graphs/train_step.ops.txt").read_text()
    assert "aten::" in ops
    assert Path("profiler_data/trace.json").stat().st_size > 0
    got = eval_criteo.main(["--ckpt", "ckpt"] + TINY)
    assert got == want
    assert "EvalCallBack metric" in Path("eval.log").read_text()
    train_criteo.main(TINY + ["--resume"])
    assert "resumed from ckpt/ckpt-0000000002-r0.npz (step 2)" in \
        capsys.readouterr().out


def test_train_criteo_fault_injector(monkeypatch):
    monkeypatch.setenv("MINDREC_CRASH_AT_STEP", "2")
    with pytest.raises(RuntimeError, match="simulated crash at step 2"):
        train_criteo.main(TINY)


@pytest.mark.parametrize("argv,env", [
    (["--mesh_model", "2"], {}),
    (["--deep_table_slice_mode", "table_row_slice"], {}),
    (["--field_slice", "true"], {}),
    ([], {"MR_WORKER_NUM": "2"}),
], ids=["mesh_model", "table_slice", "field_slice", "workers"])
def test_multi_card_options_raise_item_9(argv, env, monkeypatch):
    """The multi-card options in one process: a model axis needs the
    ranks to form it, field_slice needs a model axis, a sliced table
    without a mesh trains whole, and MR_WORKER_NUM without a scheduler
    joins no group.  What stays unported, the placement regimes on
    several workers, raises naming item 9 (``test_distribute_launcher``)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if argv[:1] == ["--mesh_model"]:
        with pytest.raises(ValueError, match="needs 2 ranks"):
            train_criteo.main(TINY + argv)
    elif argv[:1] == ["--field_slice"]:
        with pytest.raises(ValueError, match="model axis"):
            train_criteo.main(TINY + argv)
    else:
        assert _auc_ok(train_criteo.main(TINY + ["--sparse", "1"] + argv))
    mesh = type("Mesh", (), {"size": 2})()
    cfg = type("Cfg", (), {"vocab_cache_size": 1024})()
    with pytest.raises(NotImplementedError, match="section 1 item 9"):
        train_criteo.check_regimes(cfg, mesh)


def test_outbrain_driver_and_its_item_9_raise():
    """One card, then 2 gloo ranks with the emb128 table row-sliced over
    them; ``--mesh_model 2`` in one process has no ranks to slice over."""
    small = ["--device", "cpu", "--synthetic", "--batch_size", "32",
             "--steps_per_epoch", "2", "--emb128_size", "1000",
             "--deep_layers", "16", "8"]
    metrics = train_outbrain.main(small)
    assert _auc_ok(metrics) and 0.0 <= metrics["map12"] <= 1.0
    with pytest.raises(ValueError, match="needs 2 ranks"):
        train_outbrain.main(small + ["--mesh_model", "2"])
    from mindrec_tpu_torch.parallel import launch

    outs = launch.run_ranks(
        [sys.executable, "-m", "mindrec_tpu_torch.examples.train_outbrain",
         *small, "--mesh_model", "2"], 2, timeout=110,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    finals = [line for o in outs for line in o.splitlines()
              if line.startswith("final metrics")]
    assert len(finals) == 2 and finals[0] == finals[1]


def _distribute(n, *argv, timeout=200):
    env = {k: v for k, v in os.environ.items() if not k.startswith("MR_")}
    env.update(PYTHON=sys.executable, MR_SCHED_PORT=str(_port()))
    return subprocess.run(["bash", str(LAUNCH / "run_distribute_train.sh"),
                           str(n), *argv], env=env, capture_output=True,
                          text=True, timeout=timeout)


def _port():
    from mindrec_tpu_torch.parallel.launch import free_port

    return free_port()


def test_distribute_launcher():
    """``run_distribute_train.sh 4`` on the CPU: 4 gloo ranks, a (2, 2)
    mesh with the deep table row-sliced, every rank's sliced checkpoint,
    ``--resume`` from all of them, and the same final AUC on every rank;
    ``field_slice`` on 2 ranks; a failing rank (the cache regime, still
    item 9 on several workers) stops the others and the script fails."""
    mesh = TINY + ["--sparse", "1", "--mesh_model", "2",
                   "--deep_table_slice_mode", "table_row_slice",
                   "--ckpt_interval", "2"]
    r = _distribute(4, *mesh)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    logs = [Path(f"dp_logs/worker_{i}.log").read_text() for i in range(4)]
    finals = {line for log in logs for line in log.splitlines()
              if line.startswith("final metrics")}
    assert len(finals) == 1
    assert "'process_count': 4" in logs[0] and "backend: gloo" in logs[0]
    assert sorted(p.name for p in Path("ckpt").iterdir()) == [
        f"ckpt-0000000002-r{i}.npz" for i in range(4)]
    r = _distribute(4, *mesh, "--resume")
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "resumed from ckpt/ckpt-0000000002-r3.npz (step 2)" in \
        Path("dp_logs/worker_3.log").read_text()
    r = _distribute(2, *TINY, "--sparse", "1", "--mesh_model", "2",
                    "--field_slice", "true", "--vocab_size", "200000")
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    r = _distribute(2, *TINY, "--sparse", "1", "--vocab_cache_size", "1024")
    assert r.returncode != 0
    assert "section 1 item 9" in Path("dp_logs/worker_0.log").read_text()


def test_terabyte_driver(capsys):
    lw, ld = train_terabyte.main([
        "--device", "cpu", "--cache-rows", "4096", "--emb-dim", "16",
        "--batch-size", "32", "--field-size", "4", "--deep-layers", "16",
        "--steps", "2", "--ram-gb", "0.001", "--spill-dir", "spill"])
    assert np.isfinite([lw, ld]).all()
    assert "demo complete" in capsys.readouterr().out


def test_online_driver_with_its_producer():
    state = online_train.main([
        "--device", "cpu", "--batch-size", "32", "--field-size", "4",
        "--vocab", "2000", "--emb-dim", "8", "--deep-layers", "16",
        "--steps", "3", "--ckpt-interval", "2"])
    assert int(state.step) == 3
    assert [p.name for p in Path("online_ckpt").iterdir()] == [
        "ckpt-0000000002-r0.npz"]


def test_kafka_producer_into_the_stub_broker_then_online_train():
    """The producer process sends a TSV's rows to the stub broker in
    messages of 50 rows; ``online_train --kafka`` replays them and stops
    when the topic goes idle: one step per message."""
    from mindrec_tpu_torch.data import kafka_stub, preprocess, realistic, streaming

    files = realistic.write_tsv(realistic.RealisticCriteo(vocab_scale=0.001),
                                "tsv", 200, rows_per_file=200)
    stats = preprocess.collect_stats(files, workers=1)
    Path("stats.pkl").write_bytes(pickle.dumps(stats))
    with kafka_stub.StubKafkaBroker() as bootstrap:
        streaming.create_topic("criteo_stream", 1, bootstrap_servers=bootstrap)
        kafka_producer.main(["--file", files[0], "--topic", "criteo_stream",
                             "--partitions", "1", "--bootstrap", bootstrap,
                             "--rows-per-msg", "50"])
        state = online_train.main([
            "--device", "cpu", "--kafka", "--topic", "criteo_stream",
            "--bootstrap", bootstrap, "--stats", "stats.pkl",
            "--batch-size", "50", "--emb-dim", "8", "--deep-layers", "16",
            "--idle-timeout-ms", "1500", "--earliest"])
    assert int(state.step) == 4


def test_accuracy_driver():
    out = accuracy_run.main([
        "--device", "cpu", "--batch-size", "64", "--emb-dim", "8",
        "--deep-layers", "16", "--train-batches", "2", "--eval-batches", "1",
        "--epochs", "1", "--vocab-scale", "0.001"])
    assert out["event"] == "final" and 0.0 <= out["auc"] <= 1.0
    assert 0.5 < out["bayes_auc"] <= 1.0 and math.isfinite(out["loss"])


@pytest.mark.parametrize("script", ["run_standalone_train.sh",
                                    "run_dynamic_embedding_train.sh"])
def test_launch_scripts(script, tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("MR_")}
    env["PYTHON"] = sys.executable
    r = subprocess.run(["bash", str(LAUNCH / script), *TINY], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "final metrics" in r.stdout
