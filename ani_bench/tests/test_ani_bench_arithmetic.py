"""Rate, idle-union and roofline arithmetic on hand-worked
inputs."""

import pytest

from ani_bench.lib import roofline, stats, trace


def test_rate():
    assert stats.rate(30, 10.0, 12.5) == pytest.approx(12.0)
    with pytest.raises(ValueError):
        stats.rate(1, 2.0, 2.0)


def test_trace_busy_idle_and_gap_tags():
    ms = 1_000_000
    host = [(0, 100 * ms, "ani_bench/triangle"),
            (10 * ms, 40 * ms, "pyskani_tpu_torch/chain"),
            (50 * ms, 60 * ms, "pyskani_tpu_torch/screen")]
    device = [(5 * ms, 20 * ms, "k1"), (15 * ms, 30 * ms, "k2"),
              (70 * ms, 80 * ms, "k1"), (-5 * ms, 2 * ms, "k0")]
    s = trace.summarize(device, host)
    assert s.window_s == pytest.approx(0.1)
    # union: [0,2] + [5,30] + [70,80] = 2 + 25 + 10 ms
    assert s.busy_s == pytest.approx(0.037)
    assert s.by_name["k1"] == pytest.approx(0.025)
    assert s.by_name["k0"] == pytest.approx(0.002)
    # gaps: [2,5] (triangle), [30,70] mid 50 (screen), [80,100] (triangle)
    assert s.idle_by_range["ani_bench/triangle"] == pytest.approx(0.023)
    assert s.idle_by_range["pyskani_tpu_torch/screen"] == pytest.approx(0.040)
    top = s.top(s.idle_by_range, 1)
    assert top == [["pyskani_tpu_torch/screen", pytest.approx(0.040)]]


def test_trace_needs_a_benchmark_span():
    with pytest.raises(ValueError):
        trace.summarize([(0, 1, "k")], [(0, 1, "pyskani_tpu_torch/chain")])


def test_roofline_hand_worked():
    # a row of 30 anchors: tests 0+1+...+25 + 4*25 = 325 + 100 = 425
    assert roofline.tests_in_row(30) == 425
    assert roofline.tests_in_row(26) == 325
    assert roofline.tests_in_row(3) == 3
    # 60 anchors in 2 rows: both rows of 30
    assert roofline.pair_tests(60, 2) == 850
    # convex: any split of 60 anchors over 2 rows needs at least that
    assert roofline.tests_in_row(20) + roofline.tests_in_row(40) >= 850
    t, bound = roofline.least_time([(60, 2), (0, 5)])
    by_ops = 850 * 20 / 67e12
    by_bytes = 60 * 20 / 3.35e12
    assert (t, bound) == (pytest.approx(max(by_ops, by_bytes)),
                          "operations" if by_ops > by_bytes else "bytes")
    # few anchors per row: the bytes bound
    assert roofline.least_time([(10, 10)])[1] == "bytes"
