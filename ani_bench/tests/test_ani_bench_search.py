"""The search cell ``strain_search-isolates``: found by name with its
five per-layer metrics, their readers on hand-worked windows and on a
program without the query's spans, a shrunken CPU run of the entry that
comes out correct, and the control and a program that drops one hit,
sampled or not, that do not."""

import json

import pytest

from ani_bench.lib import harness, trace

CELL = "strain_search-isolates"
LAYER = ["device_idle_share.search", "search_device_ms_per_kpair",
         "query_correct_ms_per_kpair", "screen_ms_per_query",
         "host_syncs_per_query"]


def tiny_cell() -> harness.Cell:
    """The cell with two species of five stored genomes and one query of
    150-300 kbp, every stored genome sampled."""
    cell = harness.find_cell(harness.load_benchmark(), CELL)
    cell.config["population"].update(roots=2, children=6,
                                     root_bp=[150000, 200000, 300000],
                                     contigs=[1, 5])
    cell.config.update(store_per_species=5, queries_per_species=1)
    cell.traffic.update(sample_block=4)
    return cell


def test_registry_finds_the_cell_and_its_metrics():
    cell = harness.find_cell(harness.load_benchmark(), CELL)
    assert cell.chips == 1 and cell.traffic["entry"] == "search"
    assert {m["name"] for m in cell.metrics_e2e} == {"setup_s",
                                                     "pairs_per_s"}
    assert [m["name"] for m in cell.metrics_layer] == LAYER
    for m in cell.metrics_layer:
        assert m["moves"] == "pairs_per_s" and m["workloads"] == [CELL]
        assert callable(harness.load_reader(m["name"]))
    assert set(cell.traffic["limits"]) == {"hits_differ", "ani_gap",
                                           "af_gap", "hits_count_gap"}
    conf = cell.config
    assert conf["population"]["children"] == \
        conf["store_per_species"] + conf["queries_per_species"]


def _window(program, calls=4, units=512, busy=0.5):
    w = harness.Window(unit="pairs", start=0.0,
                       calls=[(float(i), i + 1.0, units)
                              for i in range(calls)],
                       setup_s=1.0, facts={"hits": calls * units})
    w.trace = trace.Summary(window_s=4.0, busy_s=busy, by_name={},
                            idle_by_range={})
    w.program = program
    return w


def test_readers_hand_worked(capsys):
    program = {"counters": {"host_syncs": 100.0, "host_syncs/-": 20.0,
                            "host_syncs/query/merge": 80.0},
               "timers_s": {"query/correct": 8.192, "screen": 0.02},
               "calls": {}}
    w = _window(program)
    read = {n: harness.load_reader(n) for n in LAYER}
    assert read["device_idle_share.search"](w) == pytest.approx(0.875)
    # 0.5 s busy over 2,048 pairs
    assert read["search_device_ms_per_kpair"](w) == \
        pytest.approx(500 / 2.048)
    assert read["query_correct_ms_per_kpair"](w) == pytest.approx(4000.0)
    assert read["screen_ms_per_query"](w) == pytest.approx(5.0)
    assert read["host_syncs_per_query"](w) == pytest.approx(20.0)
    assert "query/merge: 80" in capsys.readouterr().err


@pytest.mark.parametrize("name", LAYER)
def test_readers_return_none_without_their_span_or_counter(name):
    """A program without the query's spans and the sync counter (a parent
    commit's, or a CPU run) reads as nothing for the program's metrics."""
    read = harness.load_reader(name)
    bare = {"counters": {"pairs_chained": 512.0}, "timers_s": {},
            "calls": {}}
    if name in ("query_correct_ms_per_kpair", "screen_ms_per_query",
                "host_syncs_per_query"):
        assert read(_window(bare)) is None
        assert read(_window(None)) is None
    w = _window(bare)
    w.trace = None
    assert read(w) is None
    # another cell's window (no search facts) reads as nothing
    tri = _window({"counters": {"host_syncs": 3.0},
                   "timers_s": {"screen": 1.0}, "calls": {}})
    tri.facts = {}
    assert read(tri) is None


@pytest.mark.parametrize("traced", [False, True])
def test_shrunken_run_is_correct(traced):
    cell = tiny_cell()
    out = harness.run(cell, 2**31 + 29, 0.5, traced, "cpu", 0.0,
                      log=lambda s: None)
    line = json.loads(json.dumps(out))
    assert line["correct"] is True and line["failed"] == 0
    # whole cycles of one call a species, 5 pairs a call
    assert line["attempted"] > 0 and line["attempted"] % (2 * 5) == 0
    if not traced:
        assert set(line["metrics"]) == {"setup_s", "pairs_per_s"}
    else:
        assert set(line["metrics"]) <= set(LAYER)
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def _entry(seed=2**31 + 31):
    cell = tiny_cell()
    entry = harness.load_entry("search").Entry(cell.config, cell.traffic,
                                               seed, "cpu")
    entry.setup()
    for _ in range(2):
        entry.call()
    entry.release()
    return cell, entry


def test_reference_agrees_and_control_fails():
    cell, entry = _entry()
    limits = cell.traffic["limits"]
    got = entry.check()
    assert all(got[k] <= limits[k] for k in limits), got
    control = entry.check(control=True)
    assert any(control[k] > limits[k] for k in limits), control


def test_a_dropped_hit_is_not_correct(monkeypatch):
    import pyskani_tpu_torch
    query = pyskani_tpu_torch.Database.query

    def drop_one(self, *a, **kw):
        return query(self, *a, **kw)[1:]

    monkeypatch.setattr(pyskani_tpu_torch.Database, "query", drop_one)
    out = harness.run(tiny_cell(), 2**31 + 33, 0.5, False, "cpu", 0.0,
                      log=lambda s: None)
    assert out["checks"]["hits_differ"]["value"] >= 1
    assert out["checks"]["hits_count_gap"]["value"] >= 1
    assert out["correct"] is False


def test_a_dropped_hit_outside_the_sample_is_not_correct(monkeypatch):
    """The sample misses the dropped hit; the count of every call's hits
    does not."""
    import pyskani_tpu_torch
    query = pyskani_tpu_torch.Database.query
    cell = tiny_cell()
    cell.traffic.update(sample_per_species=2)
    sampled = set()

    def drop_unsampled(self, *a, **kw):
        hits = query(self, *a, **kw)
        out = [h for h in hits if h.reference_name in sampled]
        return out + [h for h in hits if h.reference_name not in sampled][1:]

    Entry = harness.load_entry("search").Entry
    setup = Entry.setup

    def setup_and_note(self):
        setup(self)
        sampled.update(self.sample_names)

    monkeypatch.setattr(Entry, "setup", setup_and_note)
    monkeypatch.setattr(pyskani_tpu_torch.Database, "query", drop_unsampled)
    out = harness.run(cell, 2**31 + 35, 0.5, False, "cpu", 0.0,
                      log=lambda s: None)
    assert out["checks"]["hits_differ"]["value"] == 0
    assert out["checks"]["hits_count_gap"]["value"] >= 1
    assert out["correct"] is False
