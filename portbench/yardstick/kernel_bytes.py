"""The least time of each of the port's kernel calls in a step, frozen.

Bound = the larger of bytes / 3.35 TB/s and operations / 67 TFLOP/s
(float32), where the bytes count every input the call needs read once
and every output written once, and an update reads and writes each
touched element's weight and state once.  The byte counts are copies of
the arithmetic behind the kernel table of ``PERF.md`` (``chip_smoke.py``:
``bound`` at ``:524-527``, ``segsum_sorted`` at ``:651-652``,
``adam_rows`` at ``:761-762``, ``ftrl_rows`` at ``:790-791``,
``segsum_unsorted`` at ``:1117`` and its presence counts at
``:1135-1136``, ``gather_rows`` at ``:1264-1274``, ``ftrl_cols`` at
``:1313-1327``, ``adam_cols`` at ``:1404-1411``), one function per
kernel; the column updates' inputs as the in-place kernels read them
(``mindrec_tpu_torch/csrc/update_cols.cu``'s header: the columns, each
live slot's ``dp`` sums where the segment sum left them, its fold
sub-row and its gate).

:func:`step_bound_ms` sums the calls one step makes, as each model's
plan in ``portbench/yardstick/steps/<model>.py`` lays them out.
"""

from __future__ import annotations

import importlib

from portbench.yardstick.peaks import F32_FLOPS, HBM_BYTES_PER_S

QUANTUM = 2048  # slots and id bounds are rounded up to this


def bound_ms(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3


def round_up(n: int, q: int = QUANTUM) -> int:
    """``n`` rounded up to a multiple of ``q``."""
    return -(-int(n) // q) * q


def segsum_sorted(n: int, d: int, n_out: int, g_elt: int = 2,
                  perm_elt: int = 4) -> float:
    """Rows of ``g`` read through ``perm`` (a permutation: each once),
    ``perm`` and ``uidx`` once, the ``[d, n_out]`` float32 sums once."""
    return bound_ms(n * d * g_elt + n * perm_elt + n * 4 + d * n_out * 4,
                    n * d)


def segsum_unsorted(n: int, d: int, n_out: int, g_elt: int = 2) -> float:
    return bound_ms(n * d * g_elt + n * 4 + d * n_out * 4, n * d)


def adam_rows(slots: int, valid: int, dim: int, w_elt=4, m_elt=4,
              v_elt=4) -> float:
    """Every slot's row and sub-row ids; each live slot's gradient, and
    its weight and moments read and written."""
    return bound_ms(slots * 8 + valid * dim * (4 + 2 * (w_elt + m_elt + v_elt)),
                    valid * dim * 12)


def ftrl_rows(slots: int, valid: int, dim: int, w_elt=4) -> float:
    return bound_ms(slots * 8 + valid * dim * (4 + 2 * (w_elt + 8)),
                    valid * dim * 16)


def gather_rows(slots: int, distinct: int, valid: int, dp: int,
                elt: int = 4) -> float:
    """Every slot's column, each distinct live column's ``dp`` values, and
    the ``dp`` lanes of each live slot written once."""
    return bound_ms(slots * 4 + distinct * dp * elt + valid * dp * 4, 0)


def _cols_io(slots: int, valid: int, dp: int, sub: bool, gate: bool) -> int:
    """Every slot's int32 column; each live slot's ``dp`` float32 sums
    (read in place, at their slot stride: each once), its int32 fold
    sub-row (``sub``: fold > 1) and its float32 gate (``gate``: a gate
    of one value per slot, a tiny group's presence)."""
    return slots * 4 + valid * (dp * 4 + 4 * sub + 4 * gate)


def adam_cols(slots, valid, touched, dp, sub=False, gate=False, w_elt=4,
              m_elt=4, v_elt=4) -> float:
    """The column, sums, sub-row and gate of the slots (:func:`_cols_io`),
    and each ``touched`` element's weight and moments read and written
    (fold 1: ``dp`` per distinct column; fold 8: one per live slot; a
    tiny group's update gated to its present ids: those)."""
    return bound_ms(_cols_io(slots, valid, dp, sub, gate)
                    + touched * (w_elt + m_elt + v_elt) * 2, touched * 12)


def ftrl_cols(slots, valid, touched, dp, sub=False, gate=False,
              w_elt=4) -> float:
    return bound_ms(_cols_io(slots, valid, dp, sub, gate)
                    + touched * (w_elt + 8) * 2, touched * 16)


def step_bound_ms(config: dict, batch: dict) -> float:
    """Sum of the bounds of every kernel call one step makes on a staged
    batch (its host-prep keys on the device), by the model's plan of
    calls in ``portbench/yardstick/steps/<model>.py``."""
    plan = importlib.import_module(
        f"portbench.yardstick.steps.{config['model']}")
    return plan.step_bound_ms(config, batch)
