"""The check's control on the card, at each cell's own size: the
program's readings inside every limit, and the float8 control, the
half-batch fault and the frozen state each outside at least one, on
three seeds.  Needs a
CUDA card (``-m cuda``); skips without one.  Takes several minutes (the
multitable cell's set-up and float32 reference at batch 131072)."""

import json
from pathlib import Path

import pytest

from portbench import checks, control, harness

BENCH = json.loads((Path(__file__).resolve().parents[2]
                    / "BENCHMARK.json").read_text())
SEEDS = [2**31 + 101, 2**31 + 102, 2**31 + 103]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_and_fault_fail_at_the_cells_size(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cd = harness.load_cell(cell)
    rows = control.readings(cd, SEEDS, SEEDS, "cuda")
    for r in rows:
        ok = checks.verdict({k: (r[k], "") for k in checks.NUMBERS},
                            cd["limits"])
        assert ok == (r["who"] == "program"), r
