"""What the existing cells read does not move when the harness changes:
sha256 digests of the small CPU cuts' ring batches, initial weights and
plain-reference readings at two seeds, the matmul count of each full
configuration and the W&D step's kernel bounds, recorded from the tree
before the harness found generators, optimizers, matmul counts and
initial weights by name.  One CPU thread: with more, the reference's
scatter-add of duplicate ids sums in another order from run to run."""

import hashlib
import struct

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.program import Program
from portbench.sources import make_source
from portbench.tests.cells import small_cell
from portbench.weights import make_weights
from portbench.yardstick.flops import matmul_flops_per_step
from portbench.yardstick.kernel_bytes import step_bound_ms

PINNED = {
    ("wd_bench.criteo", 2**31 + 7): (
        "3c51c0e2c0b6e58ec1e56db8de3c038cf7f27019f783be06311bf06ef60c2601",
        "9102fa0c9e170496218d0448e06d17c64b63cbd073911a0b6032f1b224a54407",
        "771b86a6286cab26cb81fe1a7413457090de8f72e6fed1bb6659e1160e0b2554"),
    ("wd_bench.criteo", 3): (
        "2c056959168b29e0f8b80733a964b2f8b8749ce16b949ae83330bb371b383802",
        "b2b5bb8e3d74c2901a59348f53f04b7a9a98a4393538cc7533f3eec2b5eae5c3",
        "ed2e026d206e20540179fcf65b1279f3a18bbf41047f78df17ecc807d4d02795"),
    ("mt_outbrain.lossless", 2**31 + 7): (
        "6a0494c6afb8688e43650511d487fbc85ecf862ebae8861d6cdfb2714bbcfca5",
        "113e9e70514b0c0065e6a9fdb223af911f1f8379ce63c9c273cee9a65c3a9852",
        "7a8a098ad7d065c04bced90ef75d438dc482a97c1ce12ce0488e83b6197c8290"),
    ("mt_outbrain.lossless", 3): (
        "986a409faaa26546b68f6e07f9de29a34159e07f5bdb3e263a172ef4009b2834",
        "6c335b1fd1f30a3f580fc104931483eb722eade7b753d6fb537e217c97032c41",
        "ef79d5192e6520e7e897ec350b6930a9356fc8f42cba0837e215076d6cbd4076"),
}
FLOPS = {"wd_bench.criteo": 665419776000.0,
         "mt_outbrain.lossless": 4922837827584.0}
WD_BOUNDS_SEED_5 = [0.0005478626865671641, 0.0005485898507462686,
                    0.0005477588059701492, 0.0005483820895522388]


def _update(h, x):
    if isinstance(x, dict):
        for k in sorted(x):
            h.update(repr(k).encode())
            _update(h, x[k])
    elif isinstance(x, (list, tuple)):
        h.update(b"[%d" % len(x))
        for v in x:
            _update(h, v)
    elif isinstance(x, np.ndarray):
        h.update(str(x.dtype).encode() + repr(x.shape).encode())
        h.update(np.ascontiguousarray(x).tobytes())
    elif isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        h.update(str(x.dtype).encode() + repr(tuple(x.shape)).encode())
        h.update(x.reshape(-1).view(torch.uint8).numpy().tobytes())
    elif isinstance(x, float):
        h.update(struct.pack("<d", x))
    elif isinstance(x, int):
        h.update(struct.pack("<q", x))
    else:
        raise TypeError(type(x))


def digest(x) -> str:
    h = hashlib.sha256()
    _update(h, x)
    return h.hexdigest()


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload,seed", sorted(PINNED))
def test_ring_weights_and_reference_are_pinned(workload, seed):
    cell = small_cell(workload)
    cfg, tr = cell["config"], cell["traffic"]
    raw = [make_source(cfg, tr, seed).get_batch(i) for i in range(tr["ring"])]
    weights = make_weights(cfg, seed, "cpu")
    ref = harness.reference(cfg, seed, torch.device("cpu"), raw)
    assert (digest(raw), digest(weights), digest(ref)) == PINNED[workload, seed]


@pytest.mark.parametrize("workload", sorted(FLOPS))
def test_matmul_count_is_pinned(workload):
    cd = harness.load_cell(workload)
    assert matmul_flops_per_step(cd["config"]) == FLOPS[workload]


def test_wide_deep_kernel_bounds_are_pinned():
    """The W&D step calls no column update, so its bounds stay."""
    cell = small_cell("wd_bench.criteo")
    cfg, tr = cell["config"], cell["traffic"]
    raw = [make_source(cfg, tr, 5).get_batch(i) for i in range(tr["ring"])]
    staged = Program(cfg, make_weights(cfg, 5, "cpu"), "cpu").stage(
        raw, tr["unique_bucket"])
    assert [step_bound_ms(cfg, b) for b in staged] == WD_BOUNDS_SEED_5
