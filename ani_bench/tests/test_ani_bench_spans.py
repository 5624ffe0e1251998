"""Device and host time by program span (``lib/spans.py``) on
hand-worked inputs, the five readers of the program's spans and
counters, and a short traced triangle on the card reporting them."""

import pytest
import torch

from conftest import tiny_cell
from ani_bench.lib import harness, spans, trace

MS = 1_000_000
HOST = [(0, 100 * MS, "ani_bench/triangle"),
        (10 * MS, 60 * MS, "pyskani_tpu_torch/triangle"),
        (20 * MS, 30 * MS, "pyskani_tpu_torch/chain/post"),
        (40 * MS, 50 * MS, "pyskani_tpu_torch/chain/post"),
        (70 * MS, 80 * MS, "pyskani_tpu_torch/sketch")]


def test_device_by_range_places_activity_by_its_launch():
    device = [
        # launched in chain/post, run after it ended: chain/post's
        (32 * MS, 36 * MS, "index_add", 25 * MS),
        # launched in triangle between its children
        (35 * MS, 37 * MS, "sort", 35 * MS),
        # launched at the second chain/post's start
        (45 * MS, 46 * MS, "index_add", 40 * MS),
        # launched in the benchmark's span only: outside every program span
        (61 * MS, 63 * MS, "copy", 61 * MS),
        # launched before the window, clipped to it
        (-4 * MS, 1 * MS, "k0", -5 * MS),
        # launched at a span's end: outside it
        (81 * MS, 82 * MS, "k", 80 * MS),
        # wholly past the window: left out
        (101 * MS, 105 * MS, "late", 99 * MS)]
    got = spans.device_by_range(device, HOST)
    assert got == {
        "pyskani_tpu_torch/chain/post": pytest.approx(0.005),
        "pyskani_tpu_torch/triangle": pytest.approx(0.002),
        "outside any range": pytest.approx(0.004)}
    # the busy union of lib/trace.py is unchanged by the launch times
    s = trace.summarize([d[:3] for d in device], HOST)
    assert s.busy_s == pytest.approx(0.001 + 0.004 + 0.001 + 0.001 +
                                     0.002 + 0.001)


def test_host_by_range_sums_each_span_name_in_the_window():
    host = HOST + [(-10 * MS, 5 * MS, "pyskani_tpu_torch/register")]
    got = spans.host_by_range(host)
    assert got == {"ani_bench/triangle": pytest.approx(0.1),
                   "pyskani_tpu_torch/triangle": pytest.approx(0.05),
                   "pyskani_tpu_torch/chain/post": pytest.approx(0.02),
                   "pyskani_tpu_torch/sketch": pytest.approx(0.01),
                   "pyskani_tpu_torch/register": pytest.approx(0.005)}
    with pytest.raises(ValueError):
        spans.host_by_range([(0, 1, "pyskani_tpu_torch/chain")])


def test_from_profiler_reads_ranges_on_the_cpu():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("ani_bench/triangle"):
            with torch.profiler.record_function("pyskani_tpu_torch/chain"):
                torch.ones(8).sum()
    device, host = spans.from_profiler(prof)
    assert device == []
    assert sorted(name for _, _, name in host) == [
        "ani_bench/triangle", "pyskani_tpu_torch/chain"]
    assert set(spans.host_by_range(host)) == {"ani_bench/triangle",
                                              "pyskani_tpu_torch/chain"}


def _window(unit, program, busy=1.0, units=2000, bases=None):
    w = harness.Window(unit=unit, start=0.0, calls=[(0.0, 1.0, units)],
                       setup_s=1.0, facts={} if bases is None else
                       {"bases": bases})
    w.trace = trace.Summary(window_s=2.0, busy_s=busy, by_name={},
                            idle_by_range={})
    w.program = program
    return w


NEW = ["host_syncs_per_kpair", "chain_join_device_ms_per_kpair",
       "chain_post_device_ms_per_kpair", "host_syncs_per_genome",
       "sketch_pack_ms_per_gbp"]


@pytest.mark.parametrize("name", NEW)
def test_new_readers_return_none_without_their_span_or_counter(name):
    read = harness.load_reader(name)
    # a program without the spans and the counter (profiling of a parent
    # commit, or a CPU run: no host_syncs)
    bare = {"counters": {"bases_sketched": 1.0}, "timers_s": {"sketch": 1.0},
            "calls": {"sketch": 1}}
    for unit in ("pairs", "genomes"):
        assert read(_window(unit, bare, bases=4e9)) is None
        assert read(_window(unit, None, bases=4e9)) is None
    # the spans timed but no device activity traced: no device number
    timed = {"counters": {}, "timers_s": {"chain/join": 1.0,
                                          "chain/post": 1.0,
                                          "sketch/pack": 1.0}, "calls": {}}
    for unit in ("pairs", "genomes"):
        assert read(_window(unit, timed, busy=0.0, bases=4e9)) is None


def test_new_readers_hand_worked(capsys):
    program = {"counters": {"host_syncs": 700.0, "host_syncs/-": 100.0,
                            "host_syncs/triangle/merge": 400.0,
                            "host_syncs/triangle/stack": 200.0},
               "timers_s": {"chain/join": 0.05, "chain/post": 0.18,
                            "sketch/pack": 0.6}, "calls": {}}
    pairs = _window("pairs", program, units=2000)
    genomes = _window("genomes", program, units=300, bases=1.5e9)
    read = {n: harness.load_reader(n) for n in NEW}
    # 600 syncs inside the program's spans over 2,000 pairs
    assert read["host_syncs_per_kpair"](pairs) == pytest.approx(300.0)
    assert read["chain_join_device_ms_per_kpair"](pairs) == \
        pytest.approx(25.0)
    assert read["chain_post_device_ms_per_kpair"](pairs) == \
        pytest.approx(90.0)
    assert read["host_syncs_per_genome"](genomes) == pytest.approx(2.0)
    assert read["sketch_pack_ms_per_gbp"](genomes) == pytest.approx(400.0)
    # each reads only its own cell's unit
    assert read["host_syncs_per_kpair"](genomes) is None
    assert read["sketch_pack_ms_per_gbp"](pairs) is None
    err = capsys.readouterr().err
    assert "host syncs by scope: triangle/merge: 400, triangle/stack: " \
        "200, -: 100" in err


@pytest.mark.cuda
def test_traced_triangle_on_the_card_reports_the_span_metrics():
    """A short traced run of the triangle cell on the card reports the
    three species metrics that read the program's spans and counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's DP kernel is CUDA only")
    out = harness.run(tiny_cell("derep_triangle-species"), 2**31 + 11, 1.0,
                      True, "cuda:0", 0.0, log=lambda s: None)
    assert out["correct"]
    for name in ("host_syncs_per_kpair", "chain_join_device_ms_per_kpair",
                 "chain_post_device_ms_per_kpair", "device_ms_per_kpair"):
        assert out["metrics"][name]["value"] > 0, name
