"""BENCHMARK.json against the benchmark's contract, and every cell's
files found by name."""

import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = [x["name"] for part in ("configs", "workloads", "end_to_end",
                                    "per_layer") for x in BENCH[part]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_metric_keys_and_sources():
    from portbench import harness

    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    measured = harness.end_to_end(2, 1, 1.0, [1.0, 2.0], 1.0)
    assert all(harness.base_name(n) in measured for n in e2e)
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        mod = importlib.import_module(
            f"portbench.metrics.{harness.base_name(m['name'])}")
        assert callable(mod.read), m["name"]


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_what_the_contract_asks(cell):
    """``setup_s``, another end-to-end metric and a per-layer one; each
    per-layer metric only where its end-to-end metric is reported; each
    metric measured or read by its base name."""
    from portbench import harness

    e2e = [m for m in BENCH["end_to_end"] if _reports(m, cell)]
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = [m for m in BENCH["per_layer"] if _reports(m, cell)]
    assert layer
    for m in layer:
        assert m["moves"] in names, (m["name"], cell)
    measured = harness.end_to_end(2, 1, 1.0, [1.0, 2.0], 1.0)
    for m in e2e:
        assert harness.base_name(m["name"]) in measured
    for m in layer:
        mod = importlib.import_module(
            f"portbench.metrics.{harness.base_name(m['name'])}")
        assert callable(mod.read)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_by_name(cell):
    from portbench import harness

    cd = harness.load_cell(cell, ROOT)
    assert cd["config"]["name"] == cd["cell"]["config"]
    gen = importlib.import_module(
        f"portbench.sources.{cd['traffic']['generator']}")
    assert callable(gen.make_source)
    from portbench.checks import NUMBERS
    from portbench.optimizers import optimizer

    for spec in cd["config"]["optimizers"].values():
        opt = optimizer(spec)
        for fn in ("build", "init_state", "update", "state_inits",
                   "grad_from_state"):
            assert callable(getattr(opt, fn)), (spec["kind"], fn)

    assert set(cd["limits"]) == set(NUMBERS)
    assert cd["limits"]["untouched_moved"] == 0
    compared = [k for k, v in cd["limits"].items() if v is not None]
    assert len(compared) >= 2
    assert all(cd["limits"][k] >= 0 for k in compared)
    assert cd["per_layer"] and len(cd["end_to_end"]) >= 2
    model = cd["config"]["model"]
    ref = importlib.import_module(f"portbench.reference.{model}")
    assert callable(ref.leaves) and ref.TABLES and ref.Reference
    plan = importlib.import_module(f"portbench.yardstick.steps.{model}")
    assert callable(plan.step_bound_ms)
    assert set(cd["config"]["program"]) == {"model", "config"}
    small = ROOT / "portbench" / "tests" / "small" / f"{model}.json"
    assert set(json.loads(small.read_text())) >= {"config", "traffic"}


def test_config_files_are_the_configs():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
