"""The MAG dereplication cell ``mag_derep-mixed`` and the small-cluster
cell ``derep_triangle-small``: the drafts hold GTDB's quality floor, the
clusters their quarter of complete genomes and a wide draft, members and
counts do not change with the seed, both cells are found by name, the
readers read hand-worked windows, and a shrunken CPU run routes the
complete genome's pairs to ``pairs_ani``, agrees with the reference and
has a bfloat16 control that does not."""

import numpy as np
import pytest

from conftest import tiny_cell
from ani_bench.entries import triangle_mags, triangle_small
from ani_bench.lib import drafts, harness, trace
from ani_bench.lib import genomes as gm

BENCH = harness.load_benchmark()
MIXED, SMALL = "mag_derep-mixed", "derep_triangle-small"
# the triangle readers both cells report, and this cell's own
TRIANGLE = ["device_idle_share.triangle", "device_ms_per_kpair",
            "chain_dp_roofline", "host_syncs_per_kpair",
            "chain_join_device_ms_per_kpair", "chain_post_device_ms_per_kpair"]
NEW = ["pairs_ani_ms_per_kpair", "per_pair_share", "chain_calls_per_kpair"]


def _cell():
    return harness.find_cell(BENCH, MIXED)


def _pool(config, seed):
    """The cell's pool without its sequences: which members are complete
    and their contig counts, for roots and children ranked from
    ``seed`` as ``lib/population.py`` ranks them."""
    pop, d = config["population"], config["drafts"]
    N, M = int(pop["roots"]), int(pop["children"])
    rng = np.random.default_rng(seed)
    length_rank = rng.permutation(N)
    div_order = np.stack([rng.permutation(M) for _ in range(N)])
    complete, plan_of = drafts.layout(pop, d, length_rank, div_order)
    counts = np.array([1 if p is None else p.count for p in plan_of])
    return drafts.Pool(genomes=[], complete=complete, n_contigs=counts,
                       length_rank=length_rank, div_order=div_order)


def test_drafts_hold_the_gtdb_floor():
    """Every draft, cut from members 0.3% shorter and longer than its
    root: completeness >= 0.5, contamination <= 0.05 of the kept bases,
    fewer than 1,000 contigs, N50 >= 5 kbp, contigs >= 1,500 bp."""
    config = _cell().config
    pop, d = config["population"], config["drafts"]
    root_len = np.sort(gm.log_spread(*pop["root_bp"], int(pop["roots"])))
    rng = np.random.default_rng(3)
    plans = drafts.plans(pop, d)
    assert len(plans) == 4 * 48
    for scale in (0.997, 1.003):
        raws = [rng.choice(np.frombuffer(b"ACGT", np.uint8),
                           int(L * scale)).tobytes() for L in root_len]
        for (r, _), p in plans.items():
            contigs = drafts.draft(raws[r], p, rng, 0.5)
            lengths = np.array([len(c) for c in contigs])
            kept = drafts.scaled(p.pieces, len(raws[r]))[p.kept].sum()
            assert len(contigs) == p.count and p.count < 1000
            assert lengths.min() >= 1500 and drafts.n50(lengths) >= 5000
            assert kept / len(raws[r]) >= 0.5
            assert p.contamination.sum() <= 0.05 * kept
            assert lengths.sum() == kept + p.contamination.sum()
    counts = sorted(p.count for p in plans.values())
    assert counts[0] >= 90 and counts[-1] <= 999
    assert sum(c > 512 for c in counts) >= 4 * 8


def test_every_cluster_holds_a_quarter_complete_and_a_wide_draft():
    cell = _cell()
    pool = _pool(cell.config, 11)
    cl = triangle_mags.clusters(pool, cell.traffic)
    sizes = sorted(len(c) for c in cl)
    assert sizes == sorted(s for s, n in cell.traffic["cycle"]
                           for _ in range(n))
    pairs = touching = 0
    for members in cl:
        n = len(members)
        assert len(set(members.tolist())) == n
        assert pool.complete[members].sum() == n // 4
        assert (pool.n_contigs[members] > 512).any()
        # one species a cluster
        assert len({m // pool.div_order.shape[1] for m in members}) == 1
        pairs += n * (n - 1) // 2
        touching += n * (n - 1) // 2 - (n - n // 4) * (n - n // 4 - 1) // 2
    assert (len(cl), pairs, touching) == (15, 3712, 1648)


def test_members_and_counts_equal_for_two_seeds():
    cell = _cell()
    a, b = (_pool(cell.config, s) for s in (5, 2**31 + 77))
    ca, cb = (triangle_mags.clusters(p, cell.traffic) for p in (a, b))

    def ranks(pool, members):
        M = pool.div_order.shape[1]
        div_rank = np.argsort(pool.div_order, axis=1)
        return [(int(pool.length_rank[m // M]), int(div_rank[m // M][m % M]))
                for m in members]

    assert [ranks(a, m) for m in ca] == [ranks(b, m) for m in cb]
    assert [a.n_contigs[m].tolist() for m in ca] == \
        [b.n_contigs[m].tolist() for m in cb]


def _tiny(cell):
    """The mixed cell at a CPU's size: one species of 8 members of ~600
    kbp, 2 complete, and a cluster of 4 a cycle whose wide draft (past
    4,096 contigs of >= 100 bp) puts the packed range at 2^19 bp."""
    cell.config["population"].update(roots=1, children=8, min_contig_bp=100,
                                     root_bp=[600000, 610000, 620000])
    cell.config["drafts"].update(complete=2, completeness=[0.9, 1.0],
                                 contigs=[2000, 4900], max_contigs=5000,
                                 min_contig_bp=100, min_n50_bp=0)
    cell.traffic.update(cycle=[[4, 1]], wide_draft=4096, sample=6)
    return cell


def test_tiny_pools_equal_for_two_seeds_but_their_sequences():
    config = _tiny(_cell()).config
    a, b = (drafts.make(config["population"], config["drafts"], s, "cpu")
            for s in (2**31 + 1, 9))
    # the members by divergence rank: complete or not, contig counts
    by_rank = [[(bool(p.complete[c]), int(p.n_contigs[c]))
                for c in p.div_order[0]] for p in (a, b)]
    assert by_rank[0] == by_rank[1]
    assert a.genomes[0].contigs != b.genomes[0].contigs
    assert max(a.n_contigs) > 4096


def test_registry_finds_both_cells():
    mixed, small = _cell(), harness.find_cell(BENCH, SMALL)
    assert (mixed.chips, small.chips) == (1, 1)
    assert mixed.traffic["entry"] == "triangle_mags"
    assert small.traffic["entry"] == "triangle_small"
    for cell in (mixed, small):
        assert {m["name"] for m in cell.metrics_e2e} == {"setup_s",
                                                         "pairs_per_s"}
        assert cell.traffic["limits"] == {"ani_gap": 1e-5, "af_gap": 1e-6,
                                          "anchors_gap": 0}
        assert harness.load_entry(cell.traffic["entry"]).Entry
    assert [m["name"] for m in mixed.metrics_layer] == TRIANGLE + NEW
    assert [m["name"] for m in small.metrics_layer] == \
        TRIANGLE + ["chain_calls_per_kpair"]
    assert mixed.config["max_cluster"] == 64 and \
        mixed.config["reduced"].keys() == {"max_cluster"}


def _done(entry_mod, traffic, clusters):
    """An entry of ``entry_mod`` whose log holds one completed call of
    every cluster of the cycle."""
    entry = entry_mod.Entry({}, traffic, 2**31 + 5, "cpu")
    entry.clusters = clusters
    entry.log = [(c, {}) for c in range(len(clusters))]
    return entry


def test_small_sample_reaches_every_call_of_the_cycle():
    """256 pairs over the 60 calls of ``small``: the 32 pairs of the
    calls of 2 all, the rest evenly over the sizes of 4, 8 and 16, and
    each size's share dealt evenly over its calls."""
    traffic = harness.find_cell(BENCH, SMALL).traffic
    clusters = [np.arange(size) for size, n in traffic["cycle"]
                for _ in range(n)]
    items = _done(triangle_small, traffic, clusters)._sample()
    assert len(items) == len(set(items)) == 256
    per_call = np.bincount([c for c, _ in items], minlength=len(clusters))
    by_size = {}
    for c, n in enumerate(per_call):
        by_size.setdefault(len(clusters[c]), []).append(int(n))
    assert {s: sum(n) for s, n in by_size.items()} == \
        {2: 32, 4: 74, 8: 75, 16: 75}
    for n in by_size.values():
        assert min(n) >= 1 and max(n) - min(n) <= 1
    for c, p in items:
        size = len(clusters[c])
        assert 0 <= p < size * (size - 1) // 2


def test_mixed_sample_halves_and_reaches_every_call():
    cell = _cell()
    pool = _pool(cell.config, 11)
    entry = _done(triangle_mags, cell.traffic,
                  triangle_mags.clusters(pool, cell.traffic))
    entry.complete = pool.complete
    items = entry._sample()
    assert len(items) == len(set(items)) == 256
    touch = [bool(entry._touches(c)[p]) for c, p in items]
    assert sum(touch) == 128
    assert {c for c, _ in items} == set(range(len(entry.clusters)))


def _window(program, units=4000, busy=0.5, window_s=4.0):
    w = harness.Window(unit="pairs", start=0.0,
                       calls=[(0.0, 1.0, units // 2), (1.0, 2.0, units // 2)],
                       setup_s=1.0, facts={})
    w.trace = trace.Summary(window_s=window_s, busy_s=busy, by_name={},
                            idle_by_range={})
    w.program = program
    return w


def test_readers_hand_worked(capsys):
    read = {name: harness.load_reader(name) for name in TRIANGLE + NEW}
    program = {"counters": {"pairs_ani_pairs": 1776.0, "triangle_giants": 4.0,
                            "chain_calls": 600.0},
               "timers_s": {"triangle/pairs_ani": 3.0}}
    w = _window(program)
    assert read["device_idle_share.triangle"](w) == pytest.approx(0.875)
    assert read["device_ms_per_kpair"](w) == pytest.approx(125.0)
    assert read["per_pair_share"](w) == pytest.approx(0.444)
    assert read["chain_calls_per_kpair"](w) == pytest.approx(150.0)
    assert read["pairs_ani_ms_per_kpair"](w) == pytest.approx(3000 / 1.776)
    assert "triangle/pairs_ani 3 s of a 4 s window" in capsys.readouterr().err
    # a program without the counters (the parent's) reads nothing
    bare = _window({"counters": {}, "timers_s": {"triangle/pairs_ani": 3.0}})
    for name in ("per_pair_share", "chain_calls_per_kpair",
                 "pairs_ani_ms_per_kpair"):
        assert read[name](bare) is None
    # routing counted, nothing past the packed range: a share of 0
    none = _window({"counters": {"chain_calls": 9.0}})
    assert read["per_pair_share"](none) == 0.0
    # no device in the trace (a CPU run): no span metric
    assert read["pairs_ani_ms_per_kpair"](_window(program, busy=0.0)) is None


def test_tiny_mixed_run_routes_agrees_and_the_control_fails():
    from pyskani_tpu_torch.utils import profiling
    cell = _tiny(_cell())
    entry = harness.load_entry(cell.traffic["entry"]).Entry(
        cell.config, cell.traffic, 2**31 + 41, "cpu")
    entry.setup()
    profiling.reset_stats()
    profiling.enable()
    try:
        entry.call()
        counters = profiling.stats().snapshot()["counters"]
    finally:
        profiling.disable()
        profiling.reset_stats()
    entry.release()
    # one complete genome of 4: its 3 pairs through one chain_pairs call,
    # the drafts' 3 in one chain_triangle group
    assert counters["triangle_giants"] == 1
    assert counters["pairs_ani_pairs"] == 3
    assert counters["chain_calls"] == 2
    assert len(entry._sample()) == 6
    limits = cell.traffic["limits"]
    got = entry.check()
    assert all(got[k] <= limits[k] for k in limits), got
    control = entry.check(control=True)
    assert any(control[k] > limits[k] for k in limits), control


def test_tiny_small_run_counts_one_chain_call_a_cluster():
    cell = tiny_cell(SMALL)
    cell.config["population"].update(roots=2, children=10)
    cell.traffic.update(cycle=[[2, 2], [4, 1]], sample=4)
    out = harness.run(cell, 2**31 + 13, 0.01, True, "cpu", 0.0,
                      log=lambda s: None)
    assert out["correct"] and out["attempted"] == 8
    assert out["metrics"]["chain_calls_per_kpair"]["value"] == 375.0

