"""The harness's check on the CPU at small sizes, for one cell of each
configuration ``BENCHMARK.json`` names: the plain reference against the
port's CPU path (the same seed, weights and batches), and the same run
with the timed path broken underneath, which must come out not correct.
The program runs eagerly on the CPU with its kernels' plain versions;
the harness's look for a card is skipped."""

import time

import pytest
import torch

from portbench import checks, control, harness
from portbench.tests.cells import CONFIG_CELLS, small_cell

SEED = 2**31 + 7  # larger than 32 signed bits hold


def run(cell, seed=SEED, tamper=None):
    res, lines = harness.run_cell("small", seed, 0.5, False,
                                  time.perf_counter(), device="cpu",
                                  tamper=tamper, cell_data=cell)
    return res, lines


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", CONFIG_CELLS)
def test_reference_matches_the_port(workload):
    cell = small_cell(workload)
    res, lines = run(cell)
    assert res["correct"], lines
    assert set(res["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    assert res["checks"]["untouched_moved"]["value"] == 0
    assert res["attempted"] > 0 and res["failed"] == 0


def _frozen(program):
    """A step that computes on a copy and returns the state unchanged."""
    from mindrec_tpu_torch.train.step import _clone_state

    real = program.rec.train_step

    def step(state, batch):
        _new, losses = real(_clone_state(state), batch)
        return state, losses

    step.takes_device_batches = True
    program.rec.train_step = step


def _half_batch(program):
    """The loss's mean over the first half of the batch, the rest left
    out."""
    real = program.model.loss

    def loss(params, logits, label):
        h = logits.shape[0] // 2
        return real(params, logits[:h], label[:h])

    program.model.loss = loss


@pytest.mark.parametrize("fault", [_frozen, _half_batch],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("workload", CONFIG_CELLS)
def test_a_broken_step_is_not_correct(workload, fault):
    res, lines = run(small_cell(workload), tamper=fault)
    assert not res["correct"], lines


@pytest.mark.parametrize("workload", CONFIG_CELLS)
def test_stand_ins_read_above_the_limits(workload):
    """The float8 control, the half-batch fault and the frozen state in
    the program's place (``portbench/control.py``'s stand-ins), on three
    seeds: not correct at every seed, as on the card at each cell's own
    size (``test_portbench_card.py``)."""
    cell = small_cell(workload)
    rows = control.readings(cell, [], [5, 6, 7], "cpu")
    assert len(rows) == 9
    for r in rows:
        assert not checks.verdict({k: (r[k], "") for k in checks.NUMBERS},
                                  cell["limits"]), r
