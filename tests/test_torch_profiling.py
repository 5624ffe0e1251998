"""The port's profiling scopes, counters and derived rates vs the JAX
package's (``utils/profiling.py`` in each).

``tests/test_profiling.py``'s two cases on the port; the same
``sketch``, ``sketch_many`` and ``query`` calls leave the same counters
and calls of the JAX package's scopes in both packages, and the port's
own spans beside them; the CLI's ``stats:`` line; the environment
switch; a ``torch.profiler`` trace holding the scopes; the spans of the
triangle, of ``sketch_many`` and of a streamed store, counted as their
inputs imply; the host-sync counter fed torch's warning by hand; the
disabled path; the bound on pending CUDA event pairs.
"""

import contextlib
import json
import os
import subprocess
import sys
import tracemalloc
import warnings

import numpy as np
import pytest
import torch

import pyskani_tpu
import pyskani_tpu_torch
from conftest import mutate, random_genome
from pyskani_tpu import cli as jax_cli
from pyskani_tpu.utils import profiling as jax_profiling
from pyskani_tpu_torch import cli
from pyskani_tpu_torch.database import _chain_cfg_for
from pyskani_tpu_torch.engine.batch import triangle
from pyskani_tpu_torch.ops.chain import chain_pairs
from pyskani_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ("bases_sketched", "refs_screened", "screen_passed", "pairs_chained")
SKETCH_SPANS = {"sketch/pack", "sketch/copy", "sketch/kernel",
                "sketch/counts"}
CHAIN_SPANS = {"chain/join", "chain/grid", "chain/dp", "chain/post"}
HIT_COUNTERS = ("hits_corrected", "correct_batches", "hits_returned")
# the text torch warns with at a synchronising CUDA operation
SYNC_TEXT = ("called a synchronizing CUDA operation (Triggered internally "
             "at /pytorch/c10/cuda/CUDAFunctions.cpp:162.)")


def _genome(rng, n=4000):
    return rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n).tobytes()


@pytest.fixture(autouse=True)
def _profiling_off():
    yield
    profiling.disable()
    profiling.reset_stats()
    jax_profiling.disable()
    jax_profiling.reset_stats()


def test_disabled_scope_is_noop():
    profiling.disable()
    profiling.reset_stats()
    with profiling.scope("sketch"):
        pass
    with profiling.scope("chain", "cpu"):
        pass
    snap = profiling.stats().snapshot()
    assert snap["timers_s"] == {}
    assert snap["counters"] == {}
    assert snap["calls"] == {}


def test_stats_collected_through_database():
    rng = np.random.default_rng(7)
    base = np.frombuffer(_genome(rng, 20000), np.uint8).copy()
    mut = base.copy()
    idx = rng.integers(0, len(mut), 200)
    mut[idx] = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=len(idx))

    profiling.enable()
    profiling.reset_stats()
    db = pyskani_tpu_torch.Database(device="cpu")
    db.sketch("ref", base.tobytes())
    db.query("query", mut.tobytes(), learned_ani=False)
    snap = profiling.stats().snapshot()

    assert snap["counters"]["bases_sketched"] == 40000
    assert snap["counters"]["refs_screened"] == 1
    assert snap["calls"]["sketch"] == 2
    assert snap["calls"]["screen"] == 1
    assert snap["timers_s"]["sketch"] > 0
    # derived rates appear when their inputs are present
    assert "sketch_mbp_per_s" in snap["counters"]
    assert 0.0 <= snap["counters"]["screen_pass_rate"] <= 1.0


def _query_spans(queries, merges):
    """Calls of ``query``'s host spans: a shortlist and a correction per
    screened query, a merge per chained partition."""
    return {"query/shortlist": queries, "query/merge": merges,
            "query/correct": queries}


def _drive(mod, **kw):
    """sketch, sketch_many and three queries (one hitting two
    references, one screened out, one on an empty shortlist's store)."""
    rng = np.random.default_rng(8)
    base = random_genome(rng, 40_000)
    db = mod.Database(**kw)
    db.sketch("a", mutate(rng, base, 0.01), b"ACGT" * 10)
    db.sketch_many([("b", [mutate(rng, base, 0.02)]),
                    ("c", [random_genome(rng, 30_000)]),
                    ("d", [mutate(rng, base[:20_000], 0.01),
                           mutate(rng, base[20_000:], 0.01)])])
    hits = [db.query("q", mutate(rng, base, 0.015), learned_ani=False),
            db.query("x", random_genome(rng, 25_000), learned_ani=False)]
    mod.Database(**kw).query("empty", base)
    return hits


def test_counters_and_calls_equal_jax():
    for prof in (profiling, jax_profiling):
        prof.enable()
        prof.reset_stats()
    want_hits = _drive(pyskani_tpu)
    got_hits = _drive(pyskani_tpu_torch, device="cpu")
    want = jax_profiling.stats().snapshot()
    got = profiling.stats().snapshot()
    assert [len(h) for h in got_hits] == [len(h) for h in want_hits] == [3, 0]
    for key in BASE:
        assert got["counters"][key] == want["counters"][key], key
    assert got["counters"]["screen_pass_rate"] == \
        want["counters"]["screen_pass_rate"]
    # the JAX package's scopes, by the names its snapshot holds
    jax_scopes = set(want["calls"])
    assert {k: got["calls"][k] for k in jax_scopes} == want["calls"] == \
        {"sketch": 5, "screen": 2, "chain": 2}
    # the port's own counters: the hits of the two queries that reached
    # the correction, none corrected (learned_ani=False), and the one
    # chained query's one chain_block call
    assert set(got["counters"]) == set(want["counters"]) | \
        set(HIT_COUNTERS) | {"chain_calls"}
    assert {k: got["counters"][k] for k in HIT_COUNTERS} == \
        {"hits_corrected": 0, "correct_batches": 0, "hits_returned": 3}
    assert got["counters"]["chain_calls"] == 1
    assert jax_scopes == set(want["timers_s"])
    assert set(got["timers_s"]) == set(got["calls"])
    assert all(got["timers_s"][k] > 0 for k in jax_scopes)
    # the port's own spans: every sketch call's four stages, one register
    # per stored genome, the one chained query's chain stages and merge,
    # and both screened queries' shortlist and correction
    assert {k: v for k, v in got["calls"].items() if k not in jax_scopes} \
        == {**dict.fromkeys(SKETCH_SPANS, 5), "register": 4,
            **dict.fromkeys(CHAIN_SPANS, 1), **_query_spans(2, 1)}


def test_cli_prints_stats_as_jax(tmp_path, capsys):
    rng = np.random.default_rng(9)
    base = random_genome(rng, 40_000)
    paths = []
    for name, g in (("r", base), ("q", mutate(rng, base, 0.02))):
        paths.append(str(tmp_path / f"{name}.fa"))
        with open(paths[-1], "wb") as f:
            f.write(b">" + name.encode() + b"\n" + g + b"\n")
    argv = ["dist", "-q", paths[1], "-r", paths[0], "--learned-ani", "no"]
    stats = []
    for main, prof, extra in ((jax_cli.main, jax_profiling, []),
                              (cli.main, profiling, ["--device", "cpu"])):
        prof.enable()
        prof.reset_stats()
        assert main(argv + extra) == 0
        err = capsys.readouterr().err
        lines = [ln for ln in err.splitlines() if ln.startswith("stats: ")]
        assert len(lines) == 1
        stats.append(json.loads(lines[0][len("stats: "):]))
    want, got = stats
    assert set(got) == {"counters", "timers_s", "calls"}
    assert {k: got["counters"][k] for k in BASE} == \
        {k: want["counters"][k] for k in BASE}
    assert {k: got["calls"][k] for k in want["calls"]} == want["calls"]
    # the port's own spans: the reference's and the query's sketches, the
    # reference's registration and the query's chain stages and host spans
    assert {k: v for k, v in got["calls"].items() if k not in want["calls"]} \
        == {**dict.fromkeys(SKETCH_SPANS, 2), "register": 1,
            **dict.fromkeys(CHAIN_SPANS, 1), **_query_spans(1, 1)}
    profiling.disable()
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert "stats: " not in capsys.readouterr().err


def test_environment_switch():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from pyskani_tpu_torch.utils import profiling\n"
            "print(profiling.enabled())\n" % REPO)
    for value, want in (("1", "True"), ("0", "False")):
        env = dict(os.environ, PYSKANI_TORCH_PROFILE=value,
                   OMP_NUM_THREADS="1")
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == want


def test_trace_holds_the_scopes(tmp_path):
    profiling.enable()
    profiling.start_trace(str(tmp_path))
    db = pyskani_tpu_torch.Database(device="cpu")
    db.sketch("a", _genome(np.random.default_rng(10), 5000))
    path = profiling.stop_trace()
    assert path == str(tmp_path / "trace.json")
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "pyskani_tpu_torch/sketch" in names
    assert profiling.stop_trace() is None


def test_disabled_scope_is_the_shared_null_context(monkeypatch):
    """Off, ``scope()`` returns one shared null context, allocates nothing
    and records nothing, and no sync-debug mode or filter is set."""
    modes = []
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    profiling.disable()
    profiling.reset_stats()
    filters, show = list(warnings.filters), warnings.showwarning
    null = profiling.scope("triangle")
    assert isinstance(null, contextlib.nullcontext)
    assert profiling.scope("chain/post", "cpu") is null
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(2000):
            with profiling.scope("triangle/cross", "cpu"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == profiling.__file__ and
             d.size_diff > 0]
    assert grown == []
    snap = profiling.stats().snapshot()
    assert snap == {"counters": {}, "timers_s": {}, "calls": {}}
    assert modes == [] and warnings.filters == filters and \
        warnings.showwarning is show


def _family(n=10, length=60_000):
    rng = np.random.default_rng(11)
    base = random_genome(rng, length)
    return [(f"g{i}", [mutate(rng, base, 0.005 * (i + 1))]) for i in range(n)]


def _calls_of(fn):
    profiling.enable()
    profiling.reset_stats()
    fn()
    calls = profiling.stats().snapshot()["calls"]
    profiling.disable()
    return calls


def test_sketch_many_and_triangle_spans():
    db = pyskani_tpu_torch.Database(device="cpu")
    items = _family()
    # ten genomes: stacks of 8 and 2
    calls = _calls_of(lambda: db.sketch_many(items))
    assert calls == {"sketch": 1, **dict.fromkeys(SKETCH_SPANS, 2),
                     "register": 10}

    sketches = [db._storage.load(name) for name, _ in items]
    group, block = 4, 2
    sizes = [len(range(a, min(a + group, 10))) for a in range(0, 10, group)]
    groups = sum(g >= 2 for g in sizes)
    tiles = sum(-(-sizes[a] // block) * -(-sizes[b] // block)
                for a in range(len(sizes)) for b in range(a + 1, len(sizes)))
    assert (groups, tiles) == (3, 8)
    calls = _calls_of(lambda: triangle(sketches, cfg=db._chain_cfg,
                                       group=group, block=block))
    assert calls == {"triangle": 1, "triangle/stack": 1,
                     "triangle/group": groups, "triangle/cross": tiles,
                     "triangle/merge": 1,
                     **dict.fromkeys(CHAIN_SPANS, groups + tiles)}


def test_chain_pairs_spans():
    from pyskani_tpu_torch.engine.batch import default_budgets, \
        stack_sketches, take_sketch
    db = pyskani_tpu_torch.Database(device="cpu")
    items = _family(3, 40_000)
    db.sketch_many(items)
    sketches = [db._storage.load(name) for name, _ in items]
    batch = stack_sketches(sketches)
    budgets = default_budgets(sketches, batch, db._chain_cfg)
    ref, qry = (take_sketch(batch, torch.tensor(i)) for i in ([0, 1], [1, 2]))
    calls = _calls_of(lambda: chain_pairs(ref, qry, cfg=db._chain_cfg,
                                          budgets=budgets))
    # per pair its join, grid and post-DP; one DP launch for both
    assert calls == {"chain/join": 2, "chain/grid": 2, "chain/dp": 1,
                     "chain/post": 2}


def test_streamed_store_spans(tmp_path):
    items = _family(3, 40_000)
    db = pyskani_tpu_torch.Database(device="cpu")
    db.sketch_many(items)
    calls = _calls_of(lambda: db.save(tmp_path, format="separated"))
    assert calls == {"storage/encode": 3}
    store = pyskani_tpu_torch.Database.open(tmp_path, device="cpu")
    query = mutate(np.random.default_rng(12), items[0][1][0], 0.01)
    hits = []
    calls = _calls_of(lambda: hits.extend(
        store.query("q", query, learned_ani=False)))
    # three shortlisted references: one chunk, three decodes
    assert len(hits) == 3
    assert calls == {"sketch": 1, **dict.fromkeys(SKETCH_SPANS, 1),
                     "screen": 1, "chain": 1, "stream/load": 1,
                     "storage/decode": 3, "stream/stage": 1,
                     "stream/chain": 1, **dict.fromkeys(CHAIN_SPANS, 1),
                     **_query_spans(1, 1)}


def _fake_cuda(monkeypatch):
    mode = {"now": 0}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.update(now=m))
    return mode


def test_sync_counter_counts_every_repeat_under_the_innermost_scope(
        monkeypatch):
    mode = _fake_cuda(monkeypatch)
    shown = []
    with warnings.catch_warnings():
        # Python's default shows a line's warning once
        warnings.simplefilter("default")
        warnings.showwarning = \
            lambda msg, cat, fn, ln, file=None, line=None: \
            shown.append(str(msg))
        filters, show = list(warnings.filters), warnings.showwarning
        profiling.reset_stats()
        profiling.enable()
        assert mode["now"] == "warn"
        with profiling.scope("triangle"):
            with profiling.scope("triangle/merge"):
                for _ in range(3):
                    warnings.warn(SYNC_TEXT)
            warnings.warn(SYNC_TEXT)
            warnings.warn("another warning")
        warnings.warn(SYNC_TEXT)
        snap = profiling.stats().snapshot()
        profiling.disable()
        assert mode["now"] == 0
        assert warnings.filters == filters
        assert warnings.showwarning is show
    assert snap["counters"] == {"host_syncs": 5.0,
                                "host_syncs/triangle/merge": 3.0,
                                "host_syncs/triangle": 1.0,
                                "host_syncs/-": 1.0}
    assert shown == ["another warning"]


def test_sync_counter_needs_cuda_and_is_off_when_disabled(monkeypatch):
    filters, show = list(warnings.filters), warnings.showwarning
    profiling.enable()           # CUDA is not initialised here
    with profiling.scope("sketch"):
        pass
    assert warnings.filters == filters and warnings.showwarning is show
    profiling.disable()
    mode = _fake_cuda(monkeypatch)
    mode["now"] = 1                      # someone else's mode is kept
    profiling.enable()
    assert mode["now"] == "warn" and warnings.filters != filters
    profiling.disable()
    assert mode["now"] == 1 and warnings.filters == filters and \
        warnings.showwarning is show
    profiling.disable()
    assert mode["now"] == 1


class _Event:
    def __init__(self, done=True):
        self.done = done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return 2.0


def test_pending_event_pairs_stay_bounded():
    stats = profiling.Stats()
    for _ in range(3 * profiling.PENDING_LIMIT):
        stats.time_events("chain/dp", _Event(), _Event())
        assert len(stats.pending) < profiling.PENDING_LIMIT
    # pairs the device has not passed wait for the snapshot
    stats.time_events("chain/post", _Event(), _Event(done=False))
    snap = stats.snapshot()
    assert stats.pending == []
    assert snap["calls"] == {"chain/dp": 3 * profiling.PENDING_LIMIT,
                             "chain/post": 1}
    assert snap["timers_s"]["chain/dp"] == \
        pytest.approx(3 * profiling.PENDING_LIMIT * 2e-3)


@pytest.mark.parametrize("learned", [True, False])
def test_query_host_spans_and_hit_counters(learned):
    """``query``'s host stages each time one call of a span per query
    (a merge per chained partition), ``hits_corrected`` counts the rows
    through ``apply_model_batch`` (one per shortlisted reference, none
    without the learned correction), ``correct_batches`` its calls (one
    per corrected query) and ``hits_returned`` the hits."""
    from pyskani_tpu_torch import regression
    rng = np.random.default_rng(13)
    base = random_genome(rng, 40_000)
    db = pyskani_tpu_torch.Database(device="cpu")
    db.sketch_many([("a", [mutate(rng, base, 0.01)]),
                    ("b", [mutate(rng, base, 0.02)]),
                    ("c", [random_genome(rng, 30_000)])])
    applied = []
    apply_model_batch = regression.apply_model_batch

    def counted(model, ani, *a, **kw):
        applied.append(len(ani))
        return apply_model_batch(model, ani, *a, **kw)

    profiling.enable()
    profiling.reset_stats()
    try:
        regression.apply_model_batch = counted
        hits = db.query("q", mutate(rng, base, 0.015), learned_ani=learned)
        missed = db.query("x", random_genome(rng, 25_000),
                          learned_ani=learned)
    finally:
        regression.apply_model_batch = apply_model_batch
    snap = profiling.stats().snapshot()
    assert len(hits) == 2 and missed == []
    # the query with hits corrects its 2 shortlisted references in one
    # batch; the one whose screen passes nothing has no rows to correct
    assert applied == ([2] if learned else [])
    assert {k: snap["counters"][k] for k in HIT_COUNTERS} == \
        {"hits_corrected": sum(applied), "correct_batches": len(applied),
         "hits_returned": 2}
    spans = _query_spans(2, 1)
    assert {k: snap["calls"][k] for k in spans} == spans
    # host stages, on the host clock
    assert all(snap["timers_s"][k] > 0 for k in spans)


def test_query_spans_and_counters_off_when_disabled():
    profiling.disable()
    profiling.reset_stats()
    rng = np.random.default_rng(14)
    base = random_genome(rng, 30_000)
    db = pyskani_tpu_torch.Database(device="cpu")
    db.sketch("a", mutate(rng, base, 0.01))
    assert len(db.query("q", mutate(rng, base, 0.01))) == 1
    snap = profiling.stats().snapshot()
    assert snap == {"counters": {}, "timers_s": {}, "calls": {}}
