"""``ops/sparse.py`` (``unique_pad``, ``segment_sum_rows``) against the
JAX package's on the same numpy inputs: ids all equal, all distinct,
colliding with the fill value, cut to a smaller size, in 2-D; sums over
rows of several shapes with ids outside the segment range.  The card's
route of the sum, ``segment_sum_sorted`` (a sort and a segmented scan),
runs here too, on the same inputs and on hot segments that span many of
its blocks and levels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindrec_tpu.ops import sparse as jsparse
from mindrec_tpu_torch.ops.sparse import (
    segment_sum_rows, segment_sum_sorted, unique_pad,
)

FILL = 99


def _ids(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "all-equal":
        return np.full(40, 7, np.int32)
    if kind == "all-distinct":
        return rng.permutation(60).astype(np.int32)
    if kind == "fill-colliding":  # the fill value is also a live id
        return rng.choice(np.array([3, 17, FILL, 42], np.int32), 50)
    if kind == "2d":
        return rng.integers(0, 30, (8, 5)).astype(np.int32)
    return rng.integers(0, 1000, 64).astype(np.int32)  # "random"


@pytest.mark.parametrize("extra", [0, 5])
@pytest.mark.parametrize("kind", ["all-equal", "all-distinct",
                                  "fill-colliding", "2d", "random"])
def test_unique_pad_matches_reference(kind, extra):
    """ids, inverse and count equal the reference's, at the lossless size
    and above it."""
    ids = _ids(kind)
    size = ids.size + extra
    want = jsparse.unique_pad(jnp.asarray(ids), size, FILL)
    got = unique_pad(torch.from_numpy(ids), size, FILL)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.inverse.numpy(), np.asarray(want.inverse))
    assert got.inverse.shape == ids.shape and got.ids.dtype == torch.int32
    assert int(got.count) == int(want.count)


def test_unique_pad_cut_to_a_smaller_size_matches_reference():
    """More distinct ids than ``size``: the smallest kept, and the cut
    ids' inverse past the last slot, as the reference's."""
    ids = _ids("random")
    want = jsparse.unique_pad(jnp.asarray(ids), 20, FILL)
    got = unique_pad(torch.from_numpy(ids), 20, FILL)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.inverse.numpy(), np.asarray(want.inverse))
    assert int(got.count) == int(want.count) == 20


@pytest.mark.parametrize("shape", [(50,), (50, 3), (50, 2, 4)])
@pytest.mark.parametrize("kind", ["all-equal", "all-distinct",
                                  "fill-colliding"])
def test_segment_sum_rows_matches_reference(kind, shape):
    """The sum per segment of the inverse ids (float32 sums of values
    that are multiples of 1/8 below 32, exact in any order), ids outside
    ``[0, num_segments)`` dropped."""
    rng = np.random.default_rng(len(shape))
    ids = np.resize(_ids(kind), shape[0])
    seg = np.asarray(jsparse.unique_pad(jnp.asarray(ids), 50, FILL).inverse)
    seg = seg.copy()
    seg[::9] = -1
    seg[4::11] = 50
    vals = (np.round(rng.normal(size=shape) * 40) / 8).astype(np.float32)
    want = jsparse.segment_sum_rows(jnp.asarray(vals), jnp.asarray(seg), 50)
    got = segment_sum_rows(torch.from_numpy(vals), torch.from_numpy(seg), 50)
    assert tuple(got.shape) == (50, *shape[1:]) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,segments,hot", [
    (1, 5, 0), (31, 40, 0), (32, 3, 32), (33, 40, 20), (1000, 50, 0),
    (5000, 7, 4000), (70_000, 3000, 40_000), (40_000, 2, 39_990),
], ids=["one-row", "below-a-block", "one-block-one-segment", "past-a-block",
        "spread", "hot", "hot-over-levels", "nearly-all-one"])
def test_segment_sum_sorted_matches_reference(n, segments, hot):
    """The card's route: equal to the reference's sum (values exact in
    float32 in any order), ids outside the range dropped, a hot segment
    crossing many blocks of 32 rows and two levels of carries."""
    rng = np.random.default_rng(n)
    seg = rng.integers(-2, segments + 2, n)
    seg[rng.permutation(n)[:hot]] = segments // 2
    vals = (np.round(rng.normal(size=(n, 2, 3)) * 40) / 8).astype(np.float32)
    want = jsparse.segment_sum_rows(jnp.asarray(vals), jnp.asarray(seg),
                                    segments)
    got = segment_sum_sorted(torch.from_numpy(vals), torch.from_numpy(seg),
                             segments)
    assert tuple(got.shape) == (segments, 2, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
