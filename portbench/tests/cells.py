"""Small cells for the harness's CPU tests: each configuration of
``BENCHMARK.json`` cut to sizes a test run holds by the file of its
model, ``portbench/tests/small/<model>.json`` (``config`` and
``traffic``: the keys it changes), with one warm-up step and no
settling.  The small MLP carries its own bfloat16 rounding, so the small
cells have limits of their own, set from CPU readings of the port (loss
gaps up to 1.2e-4, worst-leaf gaps up to 3.6e-2, median-leaf gaps under
1e-2 over seeds 3-7) with room."""

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())


def _json(*parts):
    return json.loads(HERE.joinpath(*parts).read_text())


def small_cell(workload: str) -> dict:
    """The cell's data (as ``harness.load_cell`` gives it) at its
    model's small sizes, with the small limits and no per-layer
    metric."""
    cell = {w["name"]: w for w in BENCH["workloads"]}[workload]
    cfg = copy.deepcopy(_json("configs", f"{cell['config']}.json"))
    tr = copy.deepcopy(_json("traffic", f"{cell['traffic']}.json"))
    small = _json("tests", "small", f"{cfg['model']}.json")
    cfg.update(small["config"])
    tr.update(small["traffic"])
    tr.update(warmup_steps=1, trace_steps=3, settle_s=0)
    e2e = [m for m in BENCH["end_to_end"]
           if workload in m.get("workloads", [workload])]
    return {"cell": {"chips": 1}, "config": cfg, "traffic": tr,
            "limits": SMALL_LIMITS, "end_to_end": e2e, "per_layer": []}


SMALL_LIMITS = {"loss_gap": 1e-3, "grad_gap": 0.1, "change_gap": 0.1,
                "grad_gap_median": 0.03, "change_gap_median": 0.03,
                "table_grad_gap": 0.03, "table_grad_err": 0.12,
                "untouched_moved": 0}

_FIRST = {}  # configuration -> its first cell in BENCHMARK.json
for _w in BENCH["workloads"]:
    _FIRST.setdefault(_w["config"], _w["name"])
CONFIG_CELLS = list(_FIRST.values())  # one cell of each configuration
