"""Profiling hooks and the sparse step's speed-of-light floor.

Port of ``mindrec_tpu/utils/profiling.py``:

* :class:`Profiler` / :func:`profile`: ``torch.profiler`` over the CPU
  and, where there is one, the CUDA device, started at construction and
  stopped at :meth:`Profiler.analyse`, which writes a Chrome trace
  (``<output_path>/trace.json``, readable by ``chrome://tracing`` and
  Perfetto);
* :func:`step_annotation`: a named range ``<name>#<step>`` in that trace;
* :func:`sparse_step_floor`: the analytic lower bound on the sparse
  train step's time from static byte and FLOP counts, the reference's
  model with this card's constants.

Not ported yet: ``dump_ir`` (``ROADMAP.md`` section 1 item 10).
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch

# NVIDIA H100 SXM (data sheet, dense rates): HBM3 at 3.35 TB/s, 989
# TFLOP/s bf16 on the tensor cores; HBM moves whole 32-byte sectors, so a
# scattered read costs at least one sector.  A card held below its 700 W
# limit runs slower under load.
HBM_GBPS = 3350.0
MXU_TFLOPS = 989.0
SECTOR_BYTES = 32


class Profiler:
    """Start the profiler now, stop it and write the trace at
    :meth:`analyse` (the reference's ``Profiler`` shape)."""

    def __init__(self, output_path: str = "./profiler_data"):
        self.output_path = Path(output_path)
        self.output_path.mkdir(parents=True, exist_ok=True)
        self.trace_path = self.output_path / "trace.json"
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._started = True

    def analyse(self) -> str:
        """Stop and write the Chrome trace; returns its path."""
        if self._started:
            self._started = False
            self._prof.__exit__(None, None, None)
            self._prof.export_chrome_trace(str(self.trace_path))
        return str(self.trace_path)


@contextlib.contextmanager
def profile(output_path: str = "./profiler_data"):
    p = Profiler(output_path)
    try:
        yield p
    finally:
        p.analyse()


def step_annotation(name: str, step: int):
    """A per-step range in the trace, named ``<name>#<step>``."""
    return torch.profiler.record_function(f"{name}#{step}")


# ---------------------------------------------------------------------------
# speed-of-light floor
# ---------------------------------------------------------------------------


def _dsize(dtype_name: str) -> int:
    return 2 if "16" in str(dtype_name) else 4


def sparse_step_floor(model, batch_size: int, *, unique_bucket=None,
                      hbm_gbps: float = HBM_GBPS,
                      mxu_tflops: float = MXU_TFLOPS) -> dict:
    """Analytic LOWER BOUND on the sparse train step's time from static
    byte and FLOP counts (the reference's model):

    * the gather streams every sparse table's touched storage once and
      writes the ``[U, width]`` unique-row buffer;
    * the two order crossings move ``N`` random rows each way, at least
      one ``SECTOR_BYTES`` read per row;
    * the optimizer update reads and writes the table and two state
      arrays; per table the traffic is at least ``min(whole array,
      touched rows or columns at sector granularity)``;
    * the MLP does ``6 * B * sum(in * out)`` FLOPs (forward 2, backward
      4) at the bf16 tensor-core rate.

    Terms left out (elementwise epilogues, the segment sum, host work)
    only make the real step slower.  Returns the byte and FLOP breakdown,
    ``floor_ms`` and ``floor_samples_per_sec``.
    """
    specs = getattr(model, "table_specs", {})
    cfg = model.config
    n_positions = batch_size * int(getattr(cfg, "field_size", 0) or 0)
    u = int(unique_bucket) if unique_bucket else n_positions

    table_bytes = 0
    width = 0
    for _name, (_path, spec) in specs.items():
        rows, cols = spec.storage_shape
        dt = _dsize(getattr(spec, "dtype", "float32"))
        tb = rows * cols * dt
        if getattr(spec, "row_packed", False):
            # packed layout: at least one storage row per touched unique
            touched = min(tb, u * max(SECTOR_BYTES, cols * dt))
            width += spec.emb_dim
        else:
            # feature-major: per touched column, its bytes in sectors
            touched = min(tb, u * max(SECTOR_BYTES, rows * dt))
            width += rows
        gather = touched
        # adam/ftrl: 3 arrays read + 3 written (state at table width)
        update = 6 * touched
        table_bytes += gather + update
    lane_width = max(128, -(-width // 128) * 128)
    buf_bytes = u * lane_width * 4  # the [U, width] f32 buffer write

    # order crossings: batch -> sorted and sorted -> batch, N random rows
    # each (sector-granular reads + bf16 row writes)
    row_write = lane_width * 2
    crossing_bytes = (
        2 * n_positions * (SECTOR_BYTES + row_write) if n_positions else 0
    )

    mlp_flops = 0
    dims = getattr(model, "mlp_dims", None)
    if dims:
        mlp_flops = 6 * batch_size * sum(i * o for i, o in dims)

    hbm_bytes = table_bytes + buf_bytes + crossing_bytes
    hbm_ms = hbm_bytes / (hbm_gbps * 1e6)
    mxu_ms = mlp_flops / (mxu_tflops * 1e9)
    floor_ms = hbm_ms + mxu_ms
    return {
        "table_bytes": int(table_bytes),
        "crossing_bytes": int(crossing_bytes),
        "buffer_bytes": int(buf_bytes),
        "hbm_bytes": int(hbm_bytes),
        "mlp_flops": int(mlp_flops),
        "hbm_ms": round(hbm_ms, 3),
        "mxu_ms": round(mxu_ms, 3),
        "floor_ms": round(floor_ms, 3),
        "floor_samples_per_sec": (
            round(batch_size / (floor_ms / 1e3)) if floor_ms else None
        ),
        "hbm_gbps": hbm_gbps,
        "mxu_tflops": mxu_tflops,
    }
