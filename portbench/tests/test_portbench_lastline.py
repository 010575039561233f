"""The result line's keys, and the trace reader on a made-up trace."""

import json
from types import SimpleNamespace

import pytest

from torch.autograd import DeviceType

from portbench import harness
from portbench.trace import WINDOW, Trace, port_kernel_names


def test_untraced_line_has_the_five_keys_and_checks_last():
    out = harness.result_line(
        True, 10, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
        {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 1},
        None, {"loss_gap": (1e-6, 1e-4), "untouched_moved": (0, 0)})
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["checks"]["loss_gap"] == {"value": 1e-6, "limit": 1e-4}
    json.dumps(out)


def test_traced_line_adds_breakdown():
    out = harness.result_line(
        False, 3, 1, {}, {"platform": "gpu"},
        {"device_ops": [["k", 0.1]], "idle_gaps": []},
        {"grad_gap": (float("inf"), 0.1)})
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert out["checks"]["grad_gap"]["value"] == "inf"
    json.dumps(out)


def ev(name, a, b, dev=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=a, end=b))


def test_trace_classes_busy_and_gaps():
    events = [
        ev(WINDOW, 0.0, 1000.0, DeviceType.CPU),
        ev(WINDOW, 0.0, 1000.0),  # the span mirrored on the device
        ev("_Z16adam_rows_kernelPfS_", 960.0, 980.0),
        ev("cudaGraphLaunch", 0.0, 90.0, DeviceType.CPU),
        ev("void sorted_chunk_sum<128>(float const*, int)", 100.0, 200.0),
        ev("nvjet_hsh_256x128_64x4_1x2_h_bz_coopA_NTT", 150.0, 400.0),
        ev("void at::native::vectorized_elementwise_kernel<4>()", 600.0,
           700.0),
        ev("Memcpy DtoD (Device -> Device)", 900.0, 950.0),
        ev("sorted_chunk_sum", 1100.0, 1200.0),  # outside the window
    ]
    tr = Trace(SimpleNamespace(events=lambda: events),
               {"sorted_chunk_sum", "adam_rows_kernel"}, steps=2)
    assert tr.window_s == 1e-3
    # 100..400, 600..700, 900..950, 960..980
    assert abs(tr.busy_s - 470e-6) < 1e-12
    assert abs(tr.device_ms_per_step("kernels") - 0.06) < 1e-12
    assert tr.device_ms_per_step("gemm") == 0.125
    assert abs(tr.device_ms_per_step("glue") - 0.075) < 1e-12
    gaps = tr.idle_gaps()
    assert gaps[0][1] == 200e-6 and len(gaps) == 5
    assert ["cudaGraphLaunch", 100e-6] in gaps
    assert tr.top_ops(1)[0][0].startswith("nvjet")
    assert abs(tr.steps_s - 880e-6) < 1e-12  # first operation to last


def test_steps_time_leaves_out_the_profilers_own_gaps():
    events = [
        ev(WINDOW, 0.0, 1000.0, DeviceType.CPU),
        ev("Activity Buffer Request", 250.0, 450.0, DeviceType.CPU),
        ev("cudaGraphLaunch", 500.0, 520.0, DeviceType.CPU),
        ev("void at::native::vectorized_elementwise_kernel<4>()", 100.0,
           300.0),
        ev("void at::native::vectorized_elementwise_kernel<4>()", 400.0,
           600.0),
        ev("nvjet_hsh_256x128_64x4_1x2_h_bz_coopA_NTT", 700.0, 900.0),
    ]
    tr = Trace(SimpleNamespace(events=lambda: events), set(), steps=1)
    # 100..900 less the buffer request's idle 300..400; 600..700 counts
    assert abs(tr.steps_s - 700e-6) < 1e-12
    assert abs(tr.busy_s - 600e-6) < 1e-12
    run = SimpleNamespace(trace=tr, flops_per_step=1e9)
    from portbench.metrics import device_idle_pct, step_mfu_pct

    assert abs(device_idle_pct.read(run) - 100.0 / 7.0) < 1e-9
    assert abs(step_mfu_pct.read(run)
               - 100.0 * 1e9 / (700e-6 * 989e12)) < 1e-9


def test_port_kernel_names_are_read_from_the_sources():
    names = port_kernel_names(harness.ROOT)
    assert {"sorted_chunk_sum", "adam_rows_kernel", "ftrl_rows_kernel",
            "gather_rows_wide", "adam_cols_kernel"} <= names


def test_span_marks_are_a_class_of_their_own():
    """The program's span marks are ``__global__`` functions of its
    sources too; they count as ``span``, not as the port's kernels."""
    events = [
        ev(WINDOW, 0.0, 1000.0, DeviceType.CPU),
        ev("span_mark(long*, int, int, int)", 100.0, 102.0),
        ev("_Z9span_markPliii", 300.0, 304.0),
        ev("void sorted_chunk_sum<128>(float const*, int)", 110.0, 200.0),
    ]
    tr = Trace(SimpleNamespace(events=lambda: events),
               {"sorted_chunk_sum", "span_mark"}, steps=2)
    assert abs(tr.device_ms_per_step("span") - 0.003) < 1e-12
    assert abs(tr.device_ms_per_step("kernels") - 0.045) < 1e-12
    assert "span_mark" in port_kernel_names(harness.ROOT)


@pytest.mark.parametrize("span", ["inputs", "meta", "expand", "forward", "mlp",
                                  "backward", "segsum", "update"])
def test_span_readers_read_their_span(span):
    import importlib

    read = importlib.import_module(f"portbench.metrics.{span}_span_ms").read
    assert read(SimpleNamespace(spans={span: 0.25, "between_steps": 9.0})) == 0.25
    assert read(SimpleNamespace(spans={})) is None
