"""The operation and byte counters on hand-worked shapes, the profiler
arithmetic on hand-made events, and the percentile."""
import math

import pytest
import torch

from harness import counts, peaks, trace
from harness.record import Record, nearest_rank


def test_conv_call_by_hand():
    c = counts.ConvCall(v_in=10, v_out=8, taps=27, cin=16, cout=32,
                        pairs=100, first=False)
    assert c.flops() == 2 * 100 * 16 * 32
    assert c.fwd_bytes() == (10 * 16 * 4 + 8 * 27 * (4 + 1) +
                             27 * 16 * 32 * 4 + 32 * 4 + 8 + 8 * 32 * 4)
    assert c.dgrad_bytes() == (8 * 32 * 4 + 10 * 27 * (4 + 1) +
                               27 * 16 * 32 * 4 + 10 * 16 * 4)


def test_bound_is_the_larger_side():
    assert peaks.bound_s(3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(0, 989e12) == pytest.approx(1.0)
    assert peaks.bound_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)
    assert peaks.bound_s(0, 67e12, "f32") == pytest.approx(1.0)


def test_gather_gemm_bound_counts_dgrad_in_training_only():
    a = counts.ConvCall(1000, 1000, 27, 16, 16, 5000, first=True)
    b = counts.ConvCall(1000, 500, 27, 16, 32, 4000, first=False)
    fwd = sum(peaks.bound_s(c.fwd_bytes(), c.flops()) for c in (a, b))
    dgrad = peaks.bound_s(b.dgrad_bytes(), b.flops())
    assert counts.Counts(conv_calls=[a, b]).gather_gemm_bound_s(peaks) == \
        pytest.approx(fwd)
    assert counts.Counts(conv_calls=[a, b], train=True) \
        .gather_gemm_bound_s(peaks) == pytest.approx(fwd + dgrad)


def test_nn_search_bound():
    c = counts.Counts(nn_calls=[(1e6, 1e3)])
    assert c.nn_search_bound_s(peaks) == pytest.approx(9e6 / 67e12)


def test_dense_flops_from_shapes():
    """FlopCounterMode counts a 3x3 conv as 2 * Cout * H * W * Cin * 9."""
    from torch.utils.flop_counter import FlopCounterMode
    x = torch.zeros(1, 4, 8, 8)
    w = torch.zeros(6, 4, 3, 3)
    with FlopCounterMode(display=False) as fc:
        torch.nn.functional.conv2d(x, w, padding=1)
    assert fc.get_total_flops() == 2 * 6 * 8 * 8 * 4 * 9


def test_trace_summary_by_hand():
    ev = [("k1", True, 0, 100), ("k2", True, 50, 150), ("k3", True, 300, 400),
          ("k1", True, 1000, 1100), ("outer", False, 0, 2000),
          ("inner", False, 140, 320), ("late", False, 420, 900)]
    s = trace.summarize(ev, 2, 2e-6)
    assert s.busy_s == pytest.approx(350e-9)
    assert s.n_device_ops == 4
    assert s.kernel_n["k1"] == 2
    assert s.kernel_seconds(("k1",)) == pytest.approx(200e-9)
    # gaps: 150-300 (inner), 400-1000 (outer: "late" starts after 400)
    assert dict(s.idle_gaps) == pytest.approx({"outer": 600e-9,
                                               "inner": 150e-9})
    b = s.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(200e-9)]
    assert b["idle_gaps"][0][0] == "outer"


def test_nearest_rank():
    v = list(range(1, 101))
    assert nearest_rank(v, 0.95) == 95
    assert nearest_rank([3.0], 0.95) == 3.0
    assert nearest_rank(list(range(1, 21)), 0.95) == 19


def test_readers_return_nothing_without_device_work():
    from harness import manifest
    rec = Record(kind="train", steps=4, window_s=1.0)
    rec.trace = trace.summarize([("aten::x", False, 0, 10)], 1, 1.0)
    rec.counts = counts.Counts(model_flops=1e9, train=True)
    for name in ("device_ops.train", "idle_pct.train", "mfu_pct.train",
                 "gather_gemm_roofline.train", "nn_search_roofline",
                 "peak_mem_mib.train", "device_ms_per_step"):
        assert manifest.reader(name).read(rec) is None, name
    assert math.isclose(manifest.reader("step_ms.host").read(rec), 250.0)


def test_window_readers_by_hand():
    from harness import manifest
    rec = Record(kind="stream", steps=4, window_s=0.1, window_busy_s=0.02)
    assert math.isclose(manifest.reader("device_ms_per_scan").read(rec),
                        5.0)
    assert manifest.reader("device_ms_per_step").read(rec) is None


def test_union_of_intervals():
    starts = [300, 0, 50, 1000, 120]
    ends = [400, 100, 150, 1100, 130]
    assert trace.union_ns(starts, ends) == 350
    assert trace.union_ns([5], [5]) == 0
