"""A generator, an optimizer and a model's hooks that the harness reaches
only by name: a probe module put in ``sys.modules`` under the name a
file would have, and the port's SGD, which no cell uses, through a run
of the harness on a small W&D cut."""

import copy
import sys
import time
import types

import pytest
import torch

from portbench import harness
from portbench.sources import make_source
from portbench.tests.cells import small_cell
from portbench.weights import make_weights
from portbench.yardstick.flops import matmul_flops_per_step


@pytest.fixture
def probe_module():
    """Puts a module at a dotted name for one test."""
    names = []

    def put(name, **attrs):
        sys.modules[name] = types.SimpleNamespace(**attrs)
        names.append(name)

    yield put
    for name in names:
        sys.modules.pop(name)


def test_a_generator_is_found_by_its_name(probe_module):
    seen = []

    def make(config, traffic, seed):
        seen.append((config, traffic, seed))
        return "probe source"

    probe_module("portbench.sources.probe_mix", make_source=make)
    traffic = {"generator": "probe_mix", "rate": 3}
    assert make_source({"batch_size": 4}, traffic, 2**31 + 5) == "probe source"
    assert seen == [({"batch_size": 4}, traffic, 2**31 + 5)]


def test_a_models_init_std_and_matmul_count_are_found_by_name(probe_module):
    probe_module(
        "portbench.reference.probe_model",
        leaves=lambda c: [("deep/cross/0/u", (6, 2)), ("deep/mlp/0/w", (6, 1))],
        TABLES=(),
        init_std=lambda c, key, shape: 0.0 if "/mlp/" in key else 3.0,
        matmul_flops_per_step=lambda c: 12345)
    config = {"model": "probe_model", "batch_size": 8, "init_std": 0.01}
    w = make_weights(config, 7, "cpu")
    assert float(w["deep/cross/0/u"].std()) > 1.0
    assert not w["deep/mlp/0/w"].any()
    assert matmul_flops_per_step(config) == 12345.0


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_sgd_is_found_by_its_name_and_checks_correct(two_threads):
    """The deep side trained by ``portbench/optimizers/sgd.py`` (the
    port's ``optim.sgd``: no state, its first gradient from the weight's
    change) is correct against the reference's SGD, and a run whose
    step returns the state unchanged is not."""
    cell = copy.deepcopy(small_cell("wd_bench.criteo"))
    cell["config"]["optimizers"]["deep"] = {"kind": "sgd",
                                            "learning_rate": 0.05}
    res, lines = harness.run_cell("small", 2**31 + 11, 0.5, False,
                                  time.perf_counter(), device="cpu",
                                  cell_data=cell)
    assert res["correct"], lines
    assert res["checks"]["untouched_moved"]["value"] == 0

    from portbench.tests.test_portbench_reference import _frozen

    res, lines = harness.run_cell("small", 2**31 + 11, 0.5, False,
                                  time.perf_counter(), device="cpu",
                                  tamper=_frozen, cell_data=cell)
    assert not res["correct"], lines
