#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one GPU and check it.

    python3 chip_smoke.py [--seed 0] [--refs 512] [--queries 8] [--out FILE]
                          [--profile] [--overlap]

Phases (any failure exits non-zero and prints no result line):

1. build   — compile every CUDA source of the port (``csrc/*.cu``) with
             nvcc for sm_90a, one process per source, all at once;
2. card    — the card's name and power limit (nvidia-smi);
3. goldens — sketch E. coli EC590 into ``Database()`` on the card, check
             the card's sketch equals the CPU's bit for bit, query K-12 in
             the default, learned_ani=False, robust and median modes and
             hold the five goldens of tests/test_ani.py at 4 decimals;
4. search  — an in-memory store of ``--refs`` genomes of 2-5 Mbp (32
             families of refs/32 members mutated 0.5-5% from one random
             root each), sketched on the card, then ``--queries`` queries,
             each mutated 1% from a different family's root.  Each query
             must hit exactly its family; the first query's hits are
             checked against the CPU port;
5. fallback — the full-range per-pair path at E. coli scale: a store of
             8 families (roots of 4.4-5.5 Mbp), each with 4 complete
             single-contig members and 4 drafts cut into 600-1500
             contigs, sketched on the card; one query per family, mutated
             1% from its root.  The drafts' contig bucket puts the
             complete members past the packed range, so they chain on
             ``chain_pairs`` and the drafts on ``chain_block``.  Each
             query must hit exactly its family; the complete members'
             hits must equal a control store's (complete genomes only,
             block path) and one query on a complete and a draft
             reference the CPU port's, within 1e-6;
6. giant    — (a) a ~300 Mbp genome in 3 contigs, one above the 2^27 bp
             call buffer, sketched on the card in chunked calls and in
             one call: bit-equal on every table row and field.  (b) one
             family query's card sketch placed after seedless pad contigs
             to 2.24 Gbp, through ``Database.query`` against the fallback
             store: every reference takes ``chain_pairs``, and the hits
             must equal the control query's (identity and reference
             fraction within 2e-6, query fraction scaled by the length
             ratio within 1e-5 relative); the same query again with
             ``est_ci`` (the largest resample tables, M = 262144): other
             outputs unchanged, wall time and peak memory;
7. triangle — all-vs-all.  (a) 64 genomes of 2.3 Mbp, ~1% substitutions
             from one root: ``Database.sketch_many`` must equal a
             per-genome ``sketch`` loop bit for bit (both rates printed);
             ``engine.batch.triangle`` must launch the DP 3 times (two
             ``chain_triangle`` groups of 32, one 32 x 32 ``chain_block``
             tile); pairs/s, wall and peak memory; 16 sampled pairs must
             equal ``chain_pairs`` on the card and a 3-genome
             ``chain_triangle`` the CPU port's (1e-6).  (b) the fallback
             store's first two families (8 complete genomes, 8 drafts):
             every pair touching a complete genome takes ``pairs_ani``
             (92 pairs) and the drafts one ``chain_triangle``; the 28
             complete pairs must equal a triangle of the complete genomes
             alone, and one complete-draft pair the CPU port's (1e-6).
             (c) ``cli.main(["triangle", ...])`` on 4 FASTA files: its
             rows must equal the engine's.  (d) a fragment budget of 64
             (the genomes have 115): ``chain_triangle`` of 4 genomes and
             ``chain_block`` of 2 against a genome's last 1 Mbp (the
             reference side alone past it) must flag ``frag_overflow`` on every pair as
             the CPU port does, agree with it on every other key, and
             ``check_overflow`` must raise, also through
             ``engine.batch.triangle``;
8. disk     — on-disk stores and the bootstrap interval.  (a) the search
             store saved in both formats to a temporary folder (bytes
             and write rate), opened (each query streams its shortlist
             from disk) and loaded: every query's hits equal the memory
             store's in names, order and within 1e-6; queries/s and peak
             memory of memory, open and load.  (b) a consolidated store
             of 2048 entries (each search sketch under 4 names): 4
             queries, each shortlist of ~64 streamed in 4 chunks of 16;
             with ``--overlap``, those queries also in turns with a
             double-buffered stream (a worker thread loads the next
             chunk), 4 times each, hits equal.  (c) est_ci on
             the memory store, a fallback query (``chain_block`` and
             ``chain_pairs``) and the family triangle (``chain_triangle``
             and the cross tile): every other output unchanged, bounds
             equal to the CPU port's within 1e-6, the resample index
             tables bit-equal card vs CPU, and the wall-time overhead.
             (d) ``cli.main(["sketch", ...])`` on 4 FASTA files, then
             ``search --ci`` with and without ``--preload``: rows equal
             the library's; the files read by the native FASTA reader and
             by the Python parser (same contigs, MB/s of each).  The
             folder is removed at the end;
9. generic_k — (a) ``sketch_kernel_batch`` at nine (k, marker_k) pairs
             (k 4, 9, 16, 17, 21, 32 with marker_k 21; 15, 21, 32 with
             marker_k 32) on a stack of two E. coli EC590 slices (1 Mbp,
             0.6 Mbp): card equals CPU port on every output key.  (b) 128
             genomes (8 families of 16, roots of 2-5 Mbp, the search
             phase's generator) through ``Database(k=K).sketch_many`` at
             K = 15, 21, 32, two alternated rounds (Mbp/s, peak memory);
             8 queries on the k = 21 store, each hitting exactly its
             family, the first against the CPU port (1e-6); one query and
             one ``sketch_many`` with profiling on, whose counters and
             calls must equal what the phase knows.  (c) the k = 21 store
             saved and opened (2 streamed queries equal the memory
             store's) and ``cli.main(["dist", ..., "-k", "21"])`` rows
             equal the library's;
10. mesh    — the multi-device layer (``parallel/``).  (a) one NCCL rank
             in this process (a FileStore rendezvous): the sharded search
             of the search phase's 8 queries on its memory store and on
             ``open`` of the store saved (streamed in 8 chunks), hits
             equal; one [512, 8] step whose every plane equals
             ``chain_pairs`` on the passing pairs (integers equal, floats
             within 1e-6, 0 elsewhere); ``sharded_triangle`` of the
             triangle phase's family within 1e-6 of
             ``engine.batch.triangle``.  (b) four spawned ranks on this
             card, collectives over gloo through host memory (NCCL refuses
             two ranks on one card): the search on the saved store at
             2 x 2 and 4 x 1, ``sharded_triangle`` and ``ring_triangle``
             (blocks of 16: one rank's 64-genome block would pass the
             pair-grid limit); every rank on CUDA, every rank launching
             the DP, every result equal to (a)'s.  (c) with two cards or
             more, the same on NCCL, one card per rank (a line says when
             it did not run).  Walls printed beside the card line;
11. kernels — every DP grid the search, fallback, giant, triangle, disk
             and generic_k phases fed the kernel, random tie-heavy grids
             and edge grids (PF = 100, bands 0/1/25/32, anchors resuming
             after 40 invalid columns, empty rows, a tie across two
             32-column chunks, contig-local positions in [2^30, 2^31)
             with reverse strands and gaps at max_gap_length +- 1)
             through the CUDA kernel and its plain PyTorch version: score
             and root must be bit-equal.  Times the kernel on the first
             search grid, the largest ``chain_pairs`` grid of the
             fallback phase, a giant grid, the family triangle's group
             and cross-tile grids and the first k = 21 search grid as
             device time (launches queued behind a sleep kernel, so the
             host's enqueue is off the clock), warm and with L2 flushed, the
             wrapper's host time per call and the plain version, and
             computes the card's bound for the work.

The chain-DP kernel's launch count is reset just before the main-path
calls of each phase (the search's queries, the fallback's queries, the
giant query, each of the three triangles, each timed run of the disk
phase, the k = 21 queries, streamed queries and CLI, each part of the
mesh phase in every rank) and read just after; each must launch it, the
per-pair path for every fallback query, and the family triangle exactly
3 times.  The kernels line counts every rank's launches, and the
fragment-budget part's 3 (printed apart on the launches line).  Every
chain call of every phase, in every rank, must return ``frag_overflow``
and, outside that part, set it on no pair.

The last three lines are the card line, one ``{"kernels": [...]}`` JSON
object and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLD = dict(af_query=0.9189, af_ref=0.9246, raw=0.9946, learned=0.9939,
            robust=0.9977, median=0.9995)
# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s and
# f32 (non-tensor-core) operations/s; the DP's 32-bit integer and f32
# operations are counted against the latter
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
DP_OPS_PER_TEST = 20   # subtractions, negate, abs, compares, meta key
                       # test, int->f32, add, mul, sub, max-select
ACGT = np.frombuffer(b"ACGT", np.uint8)
# fallback phase: families, root lengths, members per family, draft contig
# counts (each contig >= 100 bp, MIN_LENGTH_CONTIG), mutation range
FALLBACK = dict(families=8, root_bp=(4_400_000, 5_500_000), complete=4,
                drafts=4, draft_contigs=(600, 1_500), divergence=(0.005, 0.03))
# giant phase: contig lengths of the chunked-sketch genome (the first above
# the 2^27 bp call buffer; smaller fallbacks if one call does not fit the
# card), and the pad contigs of the giant query (before, after, length)
GIANT = dict(genomes=((160_000_000, 80_000_000, 60_000_000),
                      (140_000_000, 40_000_000, 20_000_000),
                      (136_000_000, 8_000_000, 6_000_000)),
             pads=(30, 10, 56_000_000))
# triangle phase: the JAX package's bench family (bench.py: one root, ~1%
# substitutions per genome), 64 genomes so the triangle has two groups of
# 32 and one 32 x 32 cross tile
TRIANGLE = dict(genomes=64, length=2_300_000)
# disk phase: the large consolidated store holds each search sketch under
# `copies` names, so a query's shortlist (~16 family members) becomes ~64
# references, streamed in chunks of 16; the first `queries` of the search's
# queries run on it (decoding 64 sketches per query is the phase's largest
# cost)
DISK = dict(copies=4, queries=4)
# generic_k phase: (a) the nine (k, marker_k) pairs of the sketch check;
# (b) a search store of 8 families x 16 (the search phase's generator),
# sketched at each k in ``rates`` (two alternated rounds), 8 queries at
# k = 21
GENERIC_K = dict(pairs=((4, 21), (9, 21), (16, 21), (17, 21), (21, 21),
                        (32, 21), (15, 32), (21, 32), (32, 32)),
                 slice_bp=(1_000_000, 600_000), families=8, per_family=16,
                 root_bp=(2_000_000, 5_000_000), rates=(15, 21, 32),
                 rounds=2)
FLOAT_KEYS = ("ani_mean", "ani_robust", "ani_median", "af_query", "af_ref")
INT_KEYS = ("n_anchors", "n_fragments")


def log(*a):
    print(*a, flush=True)


def mutate(rng, arr: np.ndarray, sub_rate: float, indel_rate: float):
    """Random substitutions plus short (1-29 bp) insertions and deletions,
    vectorised (same model as tests/conftest.py::mutate)."""
    arr = arr.copy()
    n = len(arr)
    nsub = int(n * sub_rate)
    arr[rng.integers(0, n, nsub)] = ACGT[rng.integers(0, 4, nsub)]
    nind = int(n * indel_rate)
    cuts = rng.integers(0, n, nind)
    lens = rng.integers(1, 30, nind)
    ins = rng.random(nind) < 0.5
    diff = np.zeros(n + 1, np.int32)
    np.add.at(diff, cuts[~ins], 1)
    np.add.at(diff, np.minimum(cuts[~ins] + lens[~ins], n), -1)
    keep = np.cumsum(diff[:n]) == 0
    pos = np.repeat(cuts[ins], lens[ins])
    vals = ACGT[rng.integers(0, 4, pos.size)]
    return np.insert(arr, pos, vals)[np.insert(keep, pos, True)]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build(result):
    from pyskani_tpu_torch.ops import _build
    names = sorted(f[:-3] for f in os.listdir(
        os.path.join(ROOT, "pyskani_tpu_torch", "csrc")) if f.endswith(".cu"))
    t0 = time.perf_counter()
    secs = _build.build(names)
    wall = time.perf_counter() - t0
    log(f"[build] {names} in {wall:.2f} s (per source {secs})")
    for name in names:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    result["build_s"] = wall
    result["build_log"] = _build.build_logs


def phase_goldens(result, torch, dev):
    import pyskani_tpu_torch
    from pyskani_tpu_torch.io.fasta import parse
    from pyskani_tpu_torch.ops.sketch import FIELDS, sketch_genome_device
    from pyskani_tpu_torch.params import SketchParams

    data = os.path.join(ROOT, "tests", "data")
    ec590 = next(iter(parse(os.path.join(data, "e.coli-EC590.fasta.gz")))).seq
    k12 = next(iter(parse(os.path.join(data, "e.coli-K12.fasta.gz")))).seq

    # the card's sketch must equal the CPU's bit for bit (int64 hashing)
    p = SketchParams()
    on_card = sketch_genome_device("EC590", [ec590], p, device=dev).device
    on_cpu = sketch_genome_device("EC590", [ec590], p, device="cpu").device
    for f in FIELDS:
        if not torch.equal(getattr(on_card, f).cpu(), getattr(on_cpu, f)):
            raise AssertionError(f"card sketch differs from CPU in {f}")
    log(f"[goldens] EC590 sketch on the card equals the CPU sketch "
        f"({int(on_card.n_seeds)} seeds, {int(on_card.n_markers)} markers)")

    db = pyskani_tpu_torch.Database()
    assert db.device.type == "cuda"
    db.sketch("EC590", ec590)
    modes = {"learned": {}, "raw": dict(learned_ani=False),
             "robust": dict(robust=True), "median": dict(median=True)}
    got = {}
    for mode, kw in modes.items():
        hits = db.query("K12", k12, **kw)
        assert len(hits) == 1, (mode, hits)
        h = hits[0]
        got[mode] = dict(identity=h.identity, af_query=h.query_fraction,
                         af_ref=h.reference_fraction)
        log(f"[goldens] {mode}: {h}")
        assert round(h.identity - GOLD[mode], 4) == 0, (mode, h.identity)
        assert round(h.query_fraction - GOLD["af_query"], 4) == 0, mode
        assert round(h.reference_fraction - GOLD["af_ref"], 4) == 0, mode
    result["goldens"] = got
    log("[goldens] all five goldens hold at 4 decimals")


def phase_search(result, torch, dev, args, rec):
    import pyskani_tpu_torch
    from pyskani_tpu_torch import database as dbmod
    from pyskani_tpu_torch.ops import chain_dp as dp_mod

    rng = np.random.default_rng(args.seed)
    n_fam = 32
    per_fam = args.refs // n_fam
    root_len = rng.integers(2_000_000, 5_000_001, n_fam)
    t0 = time.perf_counter()
    roots = [ACGT[rng.integers(0, 4, int(L))] for L in root_len]
    gen_s = time.perf_counter() - t0

    db = pyskani_tpu_torch.Database()
    sketch_s = 0.0
    bp = 0
    for f in range(n_fam):
        for m in range(per_fam):
            d = rng.uniform(0.005, 0.05)
            t0 = time.perf_counter()
            g = mutate(rng, roots[f], d, d / 10).tobytes()
            t1 = time.perf_counter()
            db.sketch(f"f{f:02d}_m{m:02d}", g)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            gen_s += t1 - t0
            sketch_s += t2 - t1
            bp += len(g)
    log(f"[search] {args.refs} references ({bp / 1e9:.3f} Gbp) generated "
        f"in {gen_s:.1f} s, sketched on the card in {sketch_s:.2f} s: "
        f"{bp / 1e6 / sketch_s:.1f} Mbp/s")
    log(f"[search] device memory after sketching: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    # the queries come from the families with the longest roots, so each
    # query's fragment budget is NF = 256 and its one chain block has
    # R = 16 x 256 = 4096 DP rows
    q_fams = [int(i) for i in np.argsort(-root_len)[:args.queries]]
    queries = [(f"q{f:02d}", mutate(rng, roots[f], 0.01, 0.001).tobytes())
               for f in q_fams]
    passed = []
    real_screen = dbmod.screen_batch

    def screen_and_count(*a, **kw):
        passes, est = real_screen(*a, **kw)
        passed.append(int(passes.sum()))
        return passes, est

    dbmod.screen_batch = screen_and_count
    dp_mod.chain_dp.launches = 0
    q_times, all_hits = [], []
    try:
        for (qname, q), f in zip(queries, q_fams):
            t0 = time.perf_counter()
            hits = db.query(qname, q, learned_ani=False)
            torch.cuda.synchronize()
            q_times.append(time.perf_counter() - t0)
            all_hits.append(hits)
            names = sorted(h.reference_name for h in hits)
            want = [f"f{f:02d}_m{m:02d}" for m in range(per_fam)]
            if names != want:
                raise AssertionError(f"{qname}: hits {names} != {want}")
            for h in hits:
                if not (0.9 < h.identity <= 1.0 and
                        0.0 < h.query_fraction <= 1.0 and
                        0.0 < h.reference_fraction <= 1.0):
                    raise AssertionError(f"{qname}: implausible hit {h}")
    finally:
        dbmod.screen_batch = real_screen
    launches = dp_mod.chain_dp.launches
    if launches == 0:
        raise AssertionError("the search never launched the chain-DP kernel")
    shapes = sorted({tuple(g[0].shape) for g in rec.grids_of("search")})
    screened_out = 1.0 - sum(passed) / (len(passed) * args.refs)
    steady = q_times[1:] or q_times
    log(f"[search] {len(queries)} queries: first {q_times[0]:.3f} s "
        f"(includes stacking the store), then {len(steady) / sum(steady):.2f} "
        f"queries/s; {len(queries) / sum(q_times):.2f} queries/s overall")
    log(f"[search] screen passed {passed} of {args.refs}: screened-out "
        f"share {screened_out:.4f}; chain-DP launches {launches}, "
        f"grid shapes [R, PF] {shapes}")

    if args.profile:
        g_prof = mutate(rng, roots[q_fams[0]], 0.01, 0.001).tobytes()
        result["profile"] = dict(
            query=_profile(torch, lambda: db.query(
                queries[-1][0], queries[-1][1], learned_ani=False)),
            sketch=_profile(torch, lambda: db._sketch("profiled", [g_prof])))

    # reference check on a small input: the first query against two of its
    # family's sketches, chained by the CPU port
    cpu = pyskani_tpu_torch.Database(device="cpu")
    for h in all_hits[0][:2]:
        cpu._register_sketch(db._storage.load(h.reference_name))
    cpu_hits = cpu.query(queries[0][0], queries[0][1], learned_ani=False)
    card = {h.reference_name: h for h in all_hits[0]}
    worst = 0.0
    for h in cpu_hits:
        c = card[h.reference_name]
        worst = max(worst, abs(h.identity - c.identity),
                    abs(h.query_fraction - c.query_fraction),
                    abs(h.reference_fraction - c.reference_fraction))
    if len(cpu_hits) != 2 or worst > 1e-6:
        raise AssertionError(f"card vs CPU port: {cpu_hits} (max diff "
                             f"{worst})")
    log(f"[search] first query vs the CPU port on 2 references: max |diff| "
        f"{worst:.3g}")
    result["search"] = dict(
        refs=args.refs, bp=bp, gen_s=gen_s, sketch_s=sketch_s,
        sketch_mbp_s=bp / 1e6 / sketch_s, query_s=q_times,
        queries_per_s=len(queries) / sum(q_times),
        steady_queries_per_s=len(steady) / sum(steady),
        screen_passed=passed, screened_out=screened_out,
        dp_launches=launches, dp_shapes=[list(s) for s in shapes],
        cpu_check_max_diff=worst)
    return launches, db, queries


def _profile(torch, fn):
    """Device busy time, wall time, the top device activities (kernels,
    copies) of one call, and the host time spent inside PyTorch ops (the
    rest of the wall is Python and numpy)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    if not by_name:
        raise RuntimeError("the profiler recorded no device activity")
    busy = sum(us for us, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    dp_us = sum(us for k, (us, _) in by_name.items() if "chain_dp" in k)
    host_ops_us = sum(e.self_cpu_time_total for e in prof.key_averages())
    out = dict(wall_us=wall_us, device_busy_us=busy,
               idle_share=1.0 - busy / wall_us,
               device_launches=sum(n for _, n in by_name.values()),
               chain_dp_us=dp_us, host_ops_us=host_ops_us,
               top=[dict(name=k[:80], device_us=us, count=n)
                    for k, (us, n) in top])
    log(f"[profile] wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms in {out['device_launches']} device "
        f"activities, idle share {out['idle_share']:.3f}; chain-DP kernel "
        f"{dp_us / 1e3:.4f} ms; host inside PyTorch ops "
        f"{host_ops_us / 1e3:.2f} ms")
    for t in out["top"][:8]:
        log(f"[profile]   {t['device_us'] / 1e3:9.3f} ms x{t['count']:5d} "
            f"{t['name']}")
    return out


class Recorder:
    """Keeps every grid the pipelines feed the chain-DP kernel and counts
    the kernel's launches per phase and path.

    It wraps ``chain_dp`` as ``ops/chain.py`` calls it (a clone of each
    CUDA grid while ``keep`` is set; in a phase of ``distinct``, only the
    first grid of each path and shape) and ``chain_block`` /
    ``chain_pairs`` / ``chain_triangle`` as ``engine/batch.py``,
    ``engine/stream.py`` and ``parallel/dist.py`` call them (the
    wrapper's own launch count before and after each call, and each
    output's ``frag_overflow``)."""

    PATHS = ("chain_block", "chain_pairs", "chain_triangle")

    def __init__(self):
        from pyskani_tpu_torch.engine import batch as batch_mod
        from pyskani_tpu_torch.engine import stream as stream_mod
        from pyskani_tpu_torch.ops import chain as chain_mod
        from pyskani_tpu_torch.ops import chain_dp as dp_mod
        from pyskani_tpu_torch.parallel import dist as dist_mod
        self.grids = []          # (phase, path, (qpos, rpos, meta))
        self.launches = {}       # (phase, path) -> launches
        self.flags = []          # (phase, frag_overflow or None) per call
        self.phase = None
        self.keep = True
        self.distinct = set()    # phases that keep one grid per shape
        self._seen = set()
        self._path = [None]
        self._mods = (batch_mod, chain_mod, dp_mod)
        self._wrapped = [(batch_mod, n) for n in self.PATHS] + \
            [(stream_mod, "chain_block"), (dist_mod, "chain_block"),
             (dist_mod, "chain_pairs")]
        self._real = {}

    def __enter__(self):
        _, chain_mod, dp_mod = self._mods
        real_dp = self._real["chain_dp"] = chain_mod.chain_dp

        def record_dp(q, r, m, cfg):
            key = (self.phase, self._path[-1], tuple(q.shape))
            if self.keep and q.is_cuda and key not in self._seen:
                if self.phase in self.distinct:
                    self._seen.add(key)
                self.grids.append((self.phase, self._path[-1],
                                   (q.clone(), r.clone(), m.clone())))
            return real_dp(q, r, m, cfg)

        chain_mod.chain_dp = record_dp
        for mod, name in self._wrapped:
            fn = self._real[(mod, name)] = getattr(mod, name)
            setattr(mod, name, self._counted(name, fn, dp_mod))
        return self

    def _counted(self, name, fn, dp_mod):
        def call(*a, **kw):
            before = dp_mod.chain_dp.launches
            self._path.append(name)
            try:
                out = fn(*a, **kw)
            finally:
                self._path.pop()
                key = (self.phase, name)
                self.launches[key] = self.launches.get(key, 0) + \
                    dp_mod.chain_dp.launches - before
            self.flags.append((self.phase, out.get("frag_overflow")))
            return out
        return call

    def flag_report(self) -> dict:
        """{phase: [chain calls, calls without ``frag_overflow``, pairs
        flagged]} over every recorded call."""
        rep = {}
        for phase, flag in self.flags:
            r = rep.setdefault(str(phase), [0, 0, 0])
            r[0] += 1
            if flag is None:
                r[1] += 1
            else:
                r[2] += int(flag.sum())
        return rep

    def __exit__(self, *exc):
        _, chain_mod, _ = self._mods
        chain_mod.chain_dp = self._real["chain_dp"]
        for mod, name in self._wrapped:
            setattr(mod, name, self._real[(mod, name)])
        return False

    def grids_of(self, phase, path=None):
        return [g for ph, pa, g in self.grids
                if ph == phase and (path is None or pa == path)]

    def launches_of(self, phase, path):
        return self.launches.get((phase, path), 0)


def _draft_contigs(rng, g: bytes, n: int, min_len: int = 100):
    """Cut a genome into n contigs of at least min_len bp (Dirichlet
    lengths)."""
    extra = len(g) - n * min_len
    lens = min_len + np.floor(rng.dirichlet(np.ones(n)) * extra).astype(int)
    lens[-1] += len(g) - lens.sum()
    ends = np.cumsum(lens)
    return [g[e - n_:e] for e, n_ in zip(ends, lens)]


def _hit_diff(a, b) -> float:
    return max(abs(a.identity - b.identity),
               abs(a.query_fraction - b.query_fraction),
               abs(a.reference_fraction - b.reference_fraction))


def phase_fallback(result, torch, dev, args, rec):
    """The full-range per-pair path under ``Database.query`` at E. coli
    scale; returns (database, queries, hits) for the giant phase."""
    import pyskani_tpu_torch
    from pyskani_tpu_torch import database as dbmod
    from pyskani_tpu_torch.ops import chain_dp as dp_mod

    F = FALLBACK
    rng = np.random.default_rng(args.seed + 1)
    root_len = rng.integers(F["root_bp"][0], F["root_bp"][1] + 1,
                            F["families"])
    roots = [ACGT[rng.integers(0, 4, int(L), dtype=np.uint8)]
             for L in root_len]
    db = pyskani_tpu_torch.Database()
    fams, complete, drafts = [], [], []
    bp, sketch_s, n_contigs = 0, 0.0, []
    for f, root in enumerate(roots):
        members = []
        for m in range(F["complete"] + F["drafts"]):
            d = rng.uniform(*F["divergence"])
            g = mutate(rng, root, d, d / 10).tobytes()
            if m < F["complete"]:
                name, contigs = f"c{f}_m{m}", [g]
                complete.append(name)
            else:
                n = int(rng.integers(F["draft_contigs"][0],
                                     F["draft_contigs"][1] + 1))
                name, contigs = f"d{f}_m{m}", _draft_contigs(rng, g, n)
                drafts.append(name)
                n_contigs.append(n)
            t0 = time.perf_counter()
            db.sketch(name, *contigs)
            torch.cuda.synchronize()
            sketch_s += time.perf_counter() - t0
            bp += len(g)
            members.append(name)
        fams.append(members)
    log(f"[fallback] {len(complete) + len(drafts)} references "
        f"({bp / 1e6:.1f} Mbp; drafts of {min(n_contigs)}-{max(n_contigs)} "
        f"contigs) sketched on the card in {sketch_s:.2f} s: "
        f"{bp / 1e6 / sketch_s:.1f} Mbp/s")

    queries = [(f"q{f}", mutate(rng, root, 0.01, 0.001).tobytes())
               for f, root in enumerate(roots)]
    by_name = {m.name: m for m in db._markers}
    routes = [dbmod._partition_blockable(by_name, fam) for fam in fams]
    for fam, (block, fb, cb, cap) in zip(fams, routes):
        want_fb = [n for n in fam if n.startswith("c")]
        if fb != want_fb:
            raise AssertionError(f"routing of {fam}: per-pair {fb}, "
                                 f"expected {want_fb} (bucket {cb}, cap "
                                 f"{cap})")
    log(f"[fallback] routing: contig buckets "
        f"{sorted({r[2] for r in routes})}, packed caps "
        f"{sorted({r[3] for r in routes})} bp; complete members per-pair")

    rec.phase = "fallback"
    dp_mod.chain_dp.launches = 0
    q_times, all_hits, pairs_per_query = [], [], []
    for (qname, q), fam in zip(queries, fams):
        before = rec.launches_of("fallback", "chain_pairs")
        t0 = time.perf_counter()
        hits = db.query(qname, q, learned_ani=False)
        torch.cuda.synchronize()
        q_times.append(time.perf_counter() - t0)
        pairs_per_query.append(rec.launches_of("fallback", "chain_pairs") -
                               before)
        all_hits.append(hits)
        if sorted(h.reference_name for h in hits) != sorted(fam):
            raise AssertionError(f"{qname}: hits "
                                 f"{[h.reference_name for h in hits]} != "
                                 f"{fam}")
        for h in hits:
            if not (0.9 < h.identity <= 1.0 and 0.0 < h.query_fraction <= 1
                    and 0.0 < h.reference_fraction <= 1.0):
                raise AssertionError(f"{qname}: implausible hit {h}")
    launches = dp_mod.chain_dp.launches
    rec.phase = None
    if min(pairs_per_query) < 1:
        raise AssertionError(f"chain_pairs launched the DP "
                             f"{pairs_per_query} times per query")
    per_path = {p: rec.launches_of("fallback", p) for p in Recorder.PATHS}
    if sum(per_path.values()) != launches:
        raise AssertionError(f"launches {launches} != per path {per_path}")
    pair_shapes = sorted({tuple(g[0].shape) for g in
                          rec.grids_of("fallback", "chain_pairs")})
    block_shapes = sorted({tuple(g[0].shape) for g in
                           rec.grids_of("fallback", "chain_block")})
    steady = q_times[1:] or q_times
    log(f"[fallback] {len(queries)} queries, each hits exactly its family: "
        f"{len(steady) / sum(steady):.2f} queries/s after the first "
        f"({q_times[0]:.3f} s, stacks the store); chain-DP launches "
        f"{per_path}, chain_pairs grids {pair_shapes}, chain_block grids "
        f"{block_shapes}")

    # control: the complete genomes alone, where the block path serves them
    rec.phase = "fallback_checks"
    ctrl = pyskani_tpu_torch.Database()
    for name in complete:
        ctrl._register_sketch(db._storage.load(name))
    worst_ctrl = 0.0
    for (qname, q), hits in zip(queries, all_hits):
        want = {h.reference_name: h for h in
                ctrl.query(qname, q, learned_ani=False)}
        got = {h.reference_name: h for h in hits
               if h.reference_name.startswith("c")}
        if sorted(want) != sorted(got):
            raise AssertionError(f"{qname}: control hits {sorted(want)} != "
                                 f"{sorted(got)}")
        worst_ctrl = max([worst_ctrl] + [_hit_diff(got[n], want[n])
                                         for n in got])
    if worst_ctrl > 1e-6:
        raise AssertionError(f"per-pair hits differ from the control's block "
                             f"hits by {worst_ctrl}")
    log(f"[fallback] complete members (per-pair) vs a control store "
        f"(block path): max |diff| {worst_ctrl:.3g}")

    # the CPU port on one complete and one draft reference
    cpu = pyskani_tpu_torch.Database(device="cpu")
    pick = [fams[0][0], fams[0][-1]]
    for name in pick:
        cpu._register_sketch(db._storage.load(name))
    cpu_hits = cpu.query(queries[0][0], queries[0][1], learned_ani=False)
    card = {h.reference_name: h for h in all_hits[0]}
    if sorted(h.reference_name for h in cpu_hits) != sorted(pick):
        raise AssertionError(f"CPU port hits {cpu_hits}")
    worst_cpu = max(_hit_diff(h, card[h.reference_name]) for h in cpu_hits)
    if worst_cpu > 1e-6:
        raise AssertionError(f"card vs CPU port: max diff {worst_cpu}")
    rec.phase = None
    log(f"[fallback] {queries[0][0]} on {pick} vs the CPU port: max |diff| "
        f"{worst_cpu:.3g}")
    result["fallback"] = dict(
        refs=len(complete) + len(drafts), bp=bp, sketch_s=sketch_s,
        draft_contigs=[min(n_contigs), max(n_contigs)],
        contig_buckets=sorted({r[2] for r in routes}), query_s=q_times,
        queries_per_s=len(queries) / sum(q_times),
        steady_queries_per_s=len(steady) / sum(steady),
        dp_launches=launches, dp_launches_per_path=per_path,
        pairs_launches_per_query=pairs_per_query,
        pair_grid_shapes=[list(x) for x in pair_shapes],
        block_grid_shapes=[list(x) for x in block_shapes],
        control_max_diff=worst_ctrl, cpu_check_max_diff=worst_cpu)
    return db, queries, all_hits, launches


def _embed_giant(host, pre: int, post: int, pad_len: int):
    """A giant multi-contig genome made from ``host``'s sketch: its contigs
    (with their seeds and markers) placed after ``pre`` seedless pad
    contigs of ``pad_len`` bp and followed by ``post`` more.  Only the
    contig ids shift: the engine never reads the sequence."""
    import dataclasses

    import torch

    from pyskani_tpu_torch.ops.sketch import (U32_MAX, HostSketch,
                                              contig_budget_for)
    d = host.device
    nc = int(d.n_contigs)
    total_c = pre + nc + post
    clens = torch.zeros(contig_budget_for(total_c), dtype=torch.int32,
                        device=d.device)
    clens[:pre] = pad_len
    clens[pre:pre + nc] = d.contig_lengths[:nc]
    clens[pre + nc:total_c] = pad_len
    live = torch.arange(d.seed_budget, device=d.device) < d.n_seeds

    def shift(t):
        return torch.where(live, t + pre, t)

    lengths = [pad_len] * pre + list(host.lengths) + [pad_len] * post
    dev2 = dataclasses.replace(
        d, contig_ids=shift(d.contig_ids), p_contig_ids=shift(d.p_contig_ids),
        contig_lengths=clens,
        n_contigs=torch.tensor(total_c, dtype=torch.int32, device=d.device),
        total_len=torch.tensor(min(sum(lengths), U32_MAX),
                               dtype=torch.int64, device=d.device))
    names = ([f"pad_{i}" for i in range(pre)] + host.contig_names +
             [f"pad_{pre + i}" for i in range(post)])
    return HostSketch(name=host.name, contig_names=names, device=dev2,
                      lengths=lengths)


def _timed(torch, fn):
    """(result, wall s, peak device GiB above what was allocated before)
    of one call."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, \
        (torch.cuda.max_memory_allocated() - base) / 2**30


def phase_giant(result, torch, dev, args, rec, db, queries, fb_hits):
    from pyskani_tpu_torch import database as dbmod
    from pyskani_tpu_torch.ops import chain_dp as dp_mod
    from pyskani_tpu_torch.ops.sketch import (FIELDS, GIANT_SKETCH_BUFFER,
                                              sketch_genome_device)
    from pyskani_tpu_torch.params import SketchParams

    # ---- (a) chunked sketching on the card ----
    params = SketchParams()
    buf = GIANT_SKETCH_BUFFER
    rng = np.random.default_rng(args.seed + 2)
    out = None
    for sizes in GIANT["genomes"]:
        if max(sizes) <= buf:
            raise AssertionError(f"giant genome {sizes}: no contig is split")
        contigs = [ACGT[rng.integers(0, 4, n, dtype=np.uint8)].tobytes()
                   for n in sizes]
        total = sum(sizes)
        chunked, chunk_s, chunk_gib = _timed(
            torch, lambda: sketch_genome_device("giant", contigs, params,
                                                device=dev))
        try:
            single, single_s, single_gib = _timed(
                torch, lambda: sketch_genome_device(
                    "giant", contigs, params, max_buffer=total, device=dev))
        except torch.cuda.OutOfMemoryError:
            log(f"[giant] one call of {total} bp does not fit the card; "
                f"trying a smaller genome")
            del chunked
            torch.cuda.empty_cache()
            continue
        out = (sizes, chunked, single)
        break
    if out is None:
        raise AssertionError("no giant genome fits one sketch call")
    sizes, chunked, single = out
    a, b = chunked.device, single.device
    n, m = int(b.n_seeds), int(b.n_markers)
    rows = {"kmers": n, "positions": n, "contig_ids": n, "strands": n,
            "own_mult": n, "p_positions": n, "p_contig_ids": n,
            "p_own_mult": n, "markers_hi": m, "markers_lo": m}
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if f in rows:
            x, y = x[:rows[f]], y[:rows[f]]
        if not torch.equal(x, y):
            raise AssertionError(f"chunked sketch differs from one call in "
                                 f"{f}")
    log(f"[giant] {sum(sizes) / 1e6:.1f} Mbp in contigs {list(sizes)} "
        f"(call buffer {buf}): chunked {chunk_s:.2f} s, peak +"
        f"{chunk_gib:.2f} GiB; one call {single_s:.2f} s, peak +"
        f"{single_gib:.2f} GiB; bit-equal ({n} seeds, {m} markers; every "
        f"field, table fields on their {n}/{m} rows)")
    del chunked, single, a, b
    torch.cuda.empty_cache()

    # ---- (b) a query of >= 2^30 bp through Database.query ----
    qname, q = queries[0]
    control = {h.reference_name: h for h in fb_hits[0]}
    q_sk = sketch_genome_device(qname, [q], params, device=dev)
    pre, post, pad = GIANT["pads"]
    giant = _embed_giant(q_sk, pre, post, pad)
    if giant.total_len < 2_200_000_000:
        raise AssertionError(f"giant query of {giant.total_len} bp")
    real_sketch = dbmod.sketch_genome_device
    dbmod.sketch_genome_device = lambda *a, **k: giant
    rec.phase = "giant"
    dp_mod.chain_dp.launches = 0
    try:
        # timed with no grid kept, so neither the wall time nor the peak
        # holds the harness's copies; a second, untimed query keeps them
        rec.keep = False
        hits, wall_s, peak_gib = _timed(torch, lambda: db.query(
            qname + "_giant", b"A" * 600, learned_ani=False))
        launches = dp_mod.chain_dp.launches
        per_path = {p: rec.launches_of("giant", p) for p in Recorder.PATHS}
        rec.keep = True
        kept = db.query(qname + "_giant", b"A" * 600, learned_ani=False)
        # once with the bootstrap interval: M = 2 NF resample columns per
        # pair, the largest index tables any path draws; its grids repeat
        # the query's, so none is kept
        rec.keep = False
        rec.phase = "giant_est_ci"
        dp_mod.chain_dp.launches = 0
        ci_hits, ci_wall_s, ci_peak_gib = _timed(torch, lambda: db.query(
            qname + "_giant", b"A" * 600, learned_ani=False, est_ci=True))
        ci_launches = dp_mod.chain_dp.launches
    finally:
        dbmod.sketch_genome_device = real_sketch
        rec.phase = None
        rec.keep = True
    if [repr(h) for h in kept] != [repr(h) for h in hits]:
        raise AssertionError(f"giant query repeated: {kept} != {hits}")
    if ci_launches < 1 or [(h.reference_name, h.identity, h.query_fraction,
                            h.reference_fraction) for h in ci_hits] != \
            [(h.reference_name, h.identity, h.query_fraction,
              h.reference_fraction) for h in hits]:
        raise AssertionError(f"giant query with est_ci ({ci_launches} "
                             f"launches): {ci_hits} != {hits}")
    _check_ci(ci_hits, "giant est_ci")
    if per_path["chain_block"] != 0 or per_path["chain_pairs"] < 1 or \
            per_path["chain_pairs"] != launches:
        raise AssertionError(f"giant query launches {launches}, per path "
                             f"{per_path}: every pair must take chain_pairs")
    if sorted(h.reference_name for h in hits) != sorted(control):
        raise AssertionError(f"giant hits {hits} != control {control}")
    scale = q_sk.total_len / giant.total_len
    worst = dict(identity=0.0, af_ref=0.0, af_query_rel=0.0)
    for h in hits:
        c = control[h.reference_name]
        worst["identity"] = max(worst["identity"],
                                abs(h.identity - c.identity))
        worst["af_ref"] = max(worst["af_ref"], abs(h.reference_fraction -
                                                   c.reference_fraction))
        worst["af_query_rel"] = max(
            worst["af_query_rel"],
            abs(h.query_fraction / (c.query_fraction * scale) - 1.0))
    if worst["identity"] > 2e-6 or worst["af_ref"] > 2e-6 or \
            worst["af_query_rel"] > 1e-5:
        raise AssertionError(f"giant query vs control: {worst}")
    shapes = sorted({tuple(g[0].shape) for g in rec.grids_of("giant")})
    log(f"[giant] query of {giant.total_len / 1e9:.3f} Gbp "
        f"({len(giant.lengths)} contigs) through Database.query: "
        f"{len(hits)} hits equal the control's ({worst}); {wall_s:.2f} s, "
        f"peak +{peak_gib:.2f} GiB; chain_pairs launches {launches}, grids "
        f"{shapes}; with est_ci {ci_wall_s:.2f} s, peak +{ci_peak_gib:.2f} "
        f"GiB, other outputs unchanged, launches {ci_launches}")
    result["giant"] = dict(
        sketch=dict(contigs=list(sizes), buffer=buf, chunked_s=chunk_s,
                    chunked_peak_gib=chunk_gib, single_s=single_s,
                    single_peak_gib=single_gib, n_seeds=n, n_markers=m),
        query=dict(total_bp=giant.total_len, contigs=len(giant.lengths),
                   wall_s=wall_s, peak_gib=peak_gib, hits=len(hits),
                   max_diff=worst, dp_launches=launches,
                   grid_shapes=[list(x) for x in shapes]),
        query_est_ci=dict(wall_s=ci_wall_s, peak_gib=ci_peak_gib,
                          dp_launches=ci_launches,
                          bounds=[[h.ci_low, h.ci_high] for h in ci_hits]))
    return launches + ci_launches


def _family_genomes(rng, n: int, length: int):
    """n genomes, each ~1% substitutions from one random root (the JAX
    package's bench family, bench.py::make_genomes)."""
    root = ACGT[rng.integers(0, 4, length, dtype=np.uint8)]
    out = []
    for _ in range(n):
        arr = root.copy()
        idx = rng.integers(0, length, length // 100)
        arr[idx] = ACGT[rng.integers(0, 4, len(idx), dtype=np.uint8)]
        out.append(arr.tobytes())
    return out


def _out_diff(got: dict, want: dict, keys=FLOAT_KEYS) -> float:
    """Max |diff| over ``keys`` of two dicts of equal-length arrays, and
    the integer keys must agree exactly."""
    for k in INT_KEYS:
        if not np.array_equal(np.asarray(got[k]), np.asarray(want[k])):
            raise AssertionError(f"{k}: {got[k]} != {want[k]}")
    return max(float(np.abs(np.asarray(got[k], np.float64) -
                            np.asarray(want[k], np.float64)).max())
               for k in keys)


def _cpu(t):
    return {k: v.cpu().numpy() for k, v in t.items()}


FRAG_BUDGET = dict(genomes=4, max_fragments=64, cut_bp=1_000_000)


def _frag_budget_part(torch, dev, rec, genomes, sketches, cfg, budgets):
    """A fragment budget that truncates: 64 of the family genomes' 115
    fragments.  ``chain_triangle`` of 4 genomes (both sides of every pair
    past the budget) and ``chain_block`` of 2 whole genomes against a
    query of another's last 1 Mbp (50 fragments: the reference side
    alone) on the
    card, then the same calls on the CPU port; the card's
    ``frag_overflow`` must equal the CPU's and be set on every pair, every
    other key must agree (integers equal, floats within 1e-6), and
    ``check_overflow`` must raise on both and through
    ``engine.batch.triangle``.  Returns (chain-DP launches, report)."""
    import dataclasses

    import pyskani_tpu_torch
    from pyskani_tpu_torch.engine import batch as eb
    from pyskani_tpu_torch.ops import chain_dp as dp_mod

    F = FRAG_BUDGET
    small = dataclasses.replace(budgets, max_fragments=F["max_fragments"])
    cut_db = pyskani_tpu_torch.Database()
    # the last 1 Mbp: chains on the references' fragments 65-114
    cut_db.sketch("cut", genomes[F["genomes"]][-F["cut_bp"]:])
    cut = cut_db._storage.load("cut")
    if cut.n_fragments(cfg.fragment_length) >= F["max_fragments"]:
        raise AssertionError("the cut query must fit the fragment budget")
    stack = eb.stack_sketches(sketches[:F["genomes"]])
    refs = eb.take_sketch(stack, torch.tensor([0, 1], device=dev))
    query = eb.stack_sketches([cut])

    def calls(st, r, q):
        return (_cpu(eb.chain_triangle(st, cfg=cfg, budgets=small)),
                _cpu(eb.chain_block(r, q, cfg=cfg, budgets=small)))

    rec.phase = "frag_budget"
    dp_mod.chain_dp.launches = 0
    tri, blk = calls(stack, refs, query)
    tri_cpu, blk_cpu = calls(*(x.map(lambda t: t.cpu())
                               for x in (stack, refs, query)))
    raised = []
    try:
        eb.triangle(sketches[:F["genomes"]], cfg, budgets=small)
    except RuntimeError as e:
        raised.append(str(e))
    launches = dp_mod.chain_dp.launches
    rec.phase = None
    for out in (tri, blk):
        try:
            eb.check_overflow(out, small)
        except RuntimeError as e:
            raised.append(str(e))
    diffs = {}
    for label, card, cpu in (("chain_triangle", tri, tri_cpu),
                             ("chain_block", blk, blk_cpu)):
        if not (np.array_equal(card["frag_overflow"], cpu["frag_overflow"])
                and card["frag_overflow"].all()):
            raise AssertionError(f"{label} frag_overflow: card "
                                 f"{card['frag_overflow']} vs CPU "
                                 f"{cpu['frag_overflow']}")
        for k in card:
            if k not in FLOAT_KEYS and \
                    not np.array_equal(card[k], cpu[k]):
                raise AssertionError(f"{label} {k}: card {card[k]} vs CPU "
                                     f"{cpu[k]}")
        diffs[label] = _out_diff(card, cpu)
    if len(raised) != 3 or not all("fragment budget overflow" in m
                                   for m in raised):
        raise AssertionError(f"check_overflow raised {raised}")
    if max(diffs.values()) > 1e-6 or launches != 3:
        raise AssertionError(f"frag_budget: card vs CPU {diffs}, chain-DP "
                             f"launches {launches}")
    log(f"[triangle] fragment budget {F['max_fragments']} of "
        f"{sketches[0].n_fragments(cfg.fragment_length)}: chain_triangle "
        f"({len(tri['frag_overflow'])} pairs) and chain_block (2 whole "
        f"references x a {F['cut_bp']} bp query) flag every pair, card = "
        f"CPU port (max |diff| {max(diffs.values()):.3g}); check_overflow "
        f"raised 3 of 3 (engine.batch.triangle, both outputs); chain-DP "
        f"launches {launches}")
    return launches, dict(pairs={k: len(v["frag_overflow"])
                                 for k, v in (("chain_triangle", tri),
                                              ("chain_block", blk))},
                          max_diff=diffs, raised=len(raised),
                          launches=launches)


def phase_triangle(result, torch, dev, args, rec, db):
    """All-vs-all: (a) a 64-genome family, (b) a mixed complete/draft set
    from the fallback store, (c) the CLI, (d) a fragment budget that
    truncates (``_frag_budget_part``).  Returns the chain-DP launches of
    the three main-path calls, those of (d) and the family."""
    import tempfile

    import pyskani_tpu_torch
    from pyskani_tpu_torch import cli
    from pyskani_tpu_torch.engine import batch as eb
    from pyskani_tpu_torch.ops import chain_dp as dp_mod
    from pyskani_tpu_torch.ops.chain import ChainConfig
    from pyskani_tpu_torch.ops.sketch import FIELDS

    T = TRIANGLE
    cfg = ChainConfig()
    rng = np.random.default_rng(args.seed + 3)
    t0 = time.perf_counter()
    genomes = _family_genomes(rng, T["genomes"], T["length"])
    gen_s = time.perf_counter() - t0
    names = [f"t{i:02d}" for i in range(len(genomes))]
    bp = sum(map(len, genomes))

    # ---- (a) batched vs per-genome sketching, bit-equal ----
    many = pyskani_tpu_torch.Database()
    one = pyskani_tpu_torch.Database()
    _, many_s, _ = _timed(torch, lambda: many.sketch_many(
        (n, [g]) for n, g in zip(names, genomes)))
    _, one_s, _ = _timed(torch, lambda: [one.sketch(n, g)
                                         for n, g in zip(names, genomes)])
    sketches = [many._storage.load(n) for n in names]
    for n, a in zip(names, sketches):
        b = one._storage.load(n)
        for f in FIELDS:
            if not torch.equal(getattr(a.device, f), getattr(b.device, f)):
                raise AssertionError(f"{n}: sketch_many differs from sketch "
                                     f"in {f}")
    log(f"[triangle] {len(genomes)} genomes of {T['length']} bp (~1% from "
        f"one root, generated in {gen_s:.1f} s): sketch_many "
        f"{bp / 1e6 / many_s:.1f} Mbp/s ({many_s:.2f} s), per-genome sketch "
        f"{bp / 1e6 / one_s:.1f} Mbp/s ({one_s:.2f} s); bit-equal on every "
        f"field")
    del one

    # ---- (a) the family triangle: untimed with grids kept, then timed ----
    rec.phase = "triangle"
    first, first_s, _ = _timed(torch, lambda: eb.triangle(sketches, cfg))
    rec.keep = False
    dp_mod.chain_dp.launches = 0
    base = {p: rec.launches_of("triangle", p) for p in Recorder.PATHS}
    (ri, qi, out), wall_s, peak_gib = _timed(
        torch, lambda: eb.triangle(sketches, cfg))
    fam_launches = dp_mod.chain_dp.launches
    per_path = {p: rec.launches_of("triangle", p) - base[p]
                for p in Recorder.PATHS}
    if args.profile:
        prof = result.setdefault("profile", {})
        prof["triangle"] = _profile(torch, lambda: eb.triangle(sketches, cfg))
        stack8 = [(n, [g]) for n, g in zip(names[:8], genomes[:8])]
        prof["sketch_many"] = _profile(
            torch, lambda: pyskani_tpu_torch.Database().sketch_many(stack8))
    rec.keep = True
    rec.phase = None
    if per_path != {"chain_block": 1, "chain_pairs": 0, "chain_triangle": 2} \
            or fam_launches != 3:
        raise AssertionError(f"family triangle launched the DP "
                             f"{fam_launches} times: {per_path}")
    if _out_diff(first[2], out) != 0.0:
        raise AssertionError("the family triangle is not repeatable")
    P = len(ri)
    ani = out["ani_mean"]
    if not (np.isfinite(ani).all() and (ani > 0.97).all() and
            (ani <= 1.0).all() and (out["af_query"] > 0.8).all()):
        raise AssertionError(f"implausible family ANI {ani.min()}-"
                             f"{ani.max()}")
    shapes = sorted({tuple(g[0].shape) for g in rec.grids_of("triangle")})
    log(f"[triangle] family: {P} pairs in {wall_s:.3f} s = {P / wall_s:.1f} "
        f"pairs/s (first call {first_s:.3f} s), peak +{peak_gib:.2f} GiB; "
        f"chain-DP launches {per_path}, grids {shapes}; ANI "
        f"{ani.min():.5f}-{ani.max():.5f}, {int(out['n_anchors'].min())}-"
        f"{int(out['n_anchors'].max())} anchors per pair")

    # 16 sampled pairs on chain_pairs (own pool per pair), on the card
    rec.phase = "triangle_checks"
    batch = eb.stack_sketches(sketches)
    budgets = eb.default_budgets(sketches, batch, cfg)
    pick = np.sort(rng.choice(P, 16, replace=False))
    ref = _cpu(eb.pairs_ani(batch, ri[pick], qi[pick], cfg=cfg,
                            budgets=budgets))
    pairs_diff = _out_diff({k: v[pick] for k, v in out.items()}, ref)
    # one 3-genome chain_triangle on the card vs the CPU port
    three = eb.take_sketch(batch, torch.tensor([0, 1, 2], device=dev))
    card3 = _cpu(eb.chain_triangle(three, cfg=cfg, budgets=budgets))
    cpu3 = _cpu(eb.chain_triangle(three.map(lambda x: x.cpu()), cfg=cfg,
                                  budgets=budgets))
    cpu_diff = _out_diff(card3, cpu3)
    rec.phase = None
    if pairs_diff > 1e-6 or cpu_diff > 1e-6:
        raise AssertionError(f"family triangle vs chain_pairs {pairs_diff}, "
                             f"3-genome card vs CPU {cpu_diff}")
    log(f"[triangle] 16 sampled pairs vs chain_pairs: max |diff| "
        f"{pairs_diff:.3g} (n_anchors equal); 3-genome chain_triangle card "
        f"vs CPU port: max |diff| {cpu_diff:.3g}")
    del batch, three
    # ---- (d) a fragment budget that truncates: raises, card = CPU ----
    frag_launches, frag_rep = _frag_budget_part(
        torch, dev, rec, genomes, sketches, cfg, budgets)

    # ---- (b) mixed: 8 complete genomes + 8 drafts of the fallback store ----
    mixed = [db._storage.load(m.name) for m in db._markers[:16]]
    complete = [i for i, s in enumerate(mixed) if len(s.lengths) == 1]
    # untimed with grids kept, then timed with none kept, as in (a)
    rec.phase = "triangle_mixed"
    _, _, mfirst = eb.triangle(mixed, cfg)
    rec.keep = False
    dp_mod.chain_dp.launches = 0
    base = {p: rec.launches_of("triangle_mixed", p) for p in Recorder.PATHS}
    try:
        (mri, mqi, mout), mixed_s, mixed_gib = _timed(
            torch, lambda: eb.triangle(mixed, cfg))
    finally:
        rec.keep = True
    mixed_launches = dp_mod.chain_dp.launches
    mixed_path = {p: rec.launches_of("triangle_mixed", p) - base[p]
                  for p in Recorder.PATHS}
    rec.phase = "triangle_checks"
    if _out_diff(mfirst, mout) != 0.0:
        raise AssertionError("the mixed triangle is not repeatable")
    del mfirst
    n_fb = sum(1 for i, j in zip(mri, mqi) if i in complete or j in complete)
    if len(complete) != 8 or n_fb != 92 or mixed_path["chain_triangle"] != 1 \
            or mixed_path["chain_block"] != 0 or \
            mixed_path["chain_pairs"] != -(-n_fb // 4):
        raise AssertionError(f"mixed triangle routing: complete {complete}, "
                             f"{n_fb} per-pair pairs, launches {mixed_path}")
    cri, cqi, cout = eb.triangle([mixed[i] for i in complete], cfg)
    sel = [int(np.nonzero((mri == complete[a]) & (mqi == complete[b]))[0][0])
           for a, b in zip(cri, cqi)]
    ctrl_diff = _out_diff({k: v[sel] for k, v in mout.items()}, cout)
    # one complete-draft pair on the CPU port, with the mixed budgets
    mbatch = eb.stack_sketches(mixed)
    mbudgets = eb.default_budgets(mixed, mbatch, cfg)
    i, j = complete[0], min(set(range(16)) - set(complete))
    p_ij = int(np.nonzero((mri == i) & (mqi == j))[0][0])
    cpu_pair = _cpu(eb.pairs_ani(mbatch.map(lambda x: x.cpu()), [i], [j],
                                 cfg=cfg, budgets=mbudgets))
    mixed_cpu_diff = _out_diff({k: mout[k][[p_ij]] for k in cpu_pair},
                               cpu_pair)
    rec.phase = None
    del mbatch
    if ctrl_diff > 1e-6 or mixed_cpu_diff > 1e-6:
        raise AssertionError(f"mixed triangle vs control {ctrl_diff}, vs CPU "
                             f"port {mixed_cpu_diff}")
    mshapes = sorted({tuple(g[0].shape)
                      for g in rec.grids_of("triangle_mixed")})
    log(f"[triangle] mixed (8 complete + 8 drafts): {len(mri)} pairs in "
        f"{mixed_s:.3f} s, peak +{mixed_gib:.2f} GiB; {n_fb} pairs per-pair; "
        f"chain-DP launches {mixed_path}, grids {mshapes}; complete pairs "
        f"vs a control triangle: max |diff| {ctrl_diff:.3g}; pair ({i}, {j}) "
        f"vs the CPU port: max |diff| {mixed_cpu_diff:.3g}")

    # ---- (c) the CLI on 4 FASTA files ----
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for n, g in zip(names[:4], genomes[:4]):
            paths.append(os.path.join(tmp, f"{n}.fa"))
            with open(paths[-1], "wb") as f:
                f.write(b">" + n.encode() + b"\n" + g + b"\n")
        tsv = os.path.join(tmp, "out.tsv")
        rec.phase = "triangle_cli"
        dp_mod.chain_dp.launches = 0
        rc = cli.main(["triangle", *paths, "--device", "cuda", "-o", tsv])
        cli_launches = dp_mod.chain_dp.launches
        rec.phase = None
        with open(tsv) as f:
            rows = f.read().splitlines()
    _, _, eout = eb.triangle(sketches[:4], cfg)
    want = ["Ref_file\tQuery_file\tANI\tAlign_fraction_ref\t"
            "Align_fraction_query"]
    for p, (a, b) in enumerate(zip(*np.triu_indices(4, k=1))):
        want.append(f"{names[a]}.fa\t{names[b]}.fa\t"
                    f"{100 * float(eout['ani_mean'][p]):.2f}\t"
                    f"{100 * float(eout['af_ref'][p]):.2f}\t"
                    f"{100 * float(eout['af_query'][p]):.2f}")
    if rc != 0 or rows != want or cli_launches != 1:
        raise AssertionError(f"CLI triangle rc {rc}, launches "
                             f"{cli_launches}: {rows} != {want}")
    log(f"[triangle] CLI triangle on 4 FASTA files: {len(rows) - 1} rows "
        f"equal the engine's; chain-DP launches {cli_launches}")
    result["triangle"] = dict(
        genomes=len(genomes), length=T["length"], bp=bp,
        sketch_many_s=many_s, sketch_many_mbp_s=bp / 1e6 / many_s,
        sketch_loop_s=one_s, sketch_loop_mbp_s=bp / 1e6 / one_s,
        pairs=P, wall_s=wall_s, first_s=first_s, pairs_per_s=P / wall_s,
        peak_gib=peak_gib, dp_launches=per_path, grid_shapes=shapes,
        ani_range=[float(ani.min()), float(ani.max())],
        sampled_pairs_max_diff=pairs_diff, cpu_three_max_diff=cpu_diff,
        mixed=dict(pairs=len(mri), wall_s=mixed_s, peak_gib=mixed_gib,
                   per_pair_pairs=n_fb, dp_launches=mixed_path,
                   grid_shapes=mshapes, control_max_diff=ctrl_diff,
                   cpu_max_diff=mixed_cpu_diff),
        cli=dict(rows=len(rows) - 1, dp_launches=cli_launches),
        frag_budget=frag_rep)
    family = dict(names=names, genomes=genomes, sketches=sketches, out=out)
    return fam_launches + mixed_launches + cli_launches, frag_launches, \
        family


def _write_fasta(path, name: str, g: bytes, width: int = 80) -> str:
    """One-record FASTA file with lines of ``width`` bases."""
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        f.write(b"\n".join(g[i:i + width] for i in range(0, len(g), width)))
        f.write(b"\n")
    return path


def _reader_rates(paths, reps: int = 3) -> dict:
    """The port's native FASTA reader against its Python parser on the
    same files: MB/s of each (medians of ``reps`` alternated reads of all
    files), failing unless the reader built and both read the same
    contigs."""
    from pyskani_tpu_torch.io import native
    from pyskani_tpu_torch.io.fasta import read_genome

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError(f"the native FASTA reader did not build: "
                             f"{native.build_log}")
    build_s = time.perf_counter() - t0
    mb = sum(os.path.getsize(p) for p in paths) / 1e6
    walls, got = {"native": [], "python": []}, {}
    for _ in range(reps):
        for label, fn in (("native", native.read_contigs),
                          ("python", read_genome)):
            t0 = time.perf_counter()
            got[label] = [fn(p) for p in paths]
            walls[label].append(time.perf_counter() - t0)
    if got["native"] != got["python"]:
        raise AssertionError("the native reader and the Python parser read "
                             "different contigs")
    return dict(build_s=build_s, mb=mb, native_s=walls["native"],
                python_s=walls["python"],
                native_mb_s=mb / float(np.median(walls["native"])),
                python_mb_s=mb / float(np.median(walls["python"])))


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _same_hits(got, want, label) -> float:
    """Max |diff| of two hit lists that must name the same references in
    the same order."""
    g = [h.reference_name for h in got]
    w = [h.reference_name for h in want]
    if g != w:
        raise AssertionError(f"{label}: hits {g} != {w}")
    return max([0.0] + [_hit_diff(a, b) for a, b in zip(got, want)])


def _ci_diff(got, want) -> float:
    return max([0.0] + [max(abs(a.ci_low - b.ci_low),
                            abs(a.ci_high - b.ci_high))
                        for a, b in zip(got, want)])


def _check_ci(hits, label):
    for h in hits:
        if not (np.isfinite(h.ci_low) and np.isfinite(h.ci_high) and
                0.0 <= h.ci_low <= h.ci_high + 1e-6 and h.ci_high <= 1.0):
            raise AssertionError(f"{label}: implausible interval {h} "
                                 f"[{h.ci_low}, {h.ci_high}]")


def _stream_cost(torch, store, names, dev) -> dict:
    """The host's part of streaming ``names`` from a disk ``store``, each
    step timed alone: decoding the sketches (npz to host tensors),
    stacking them into pinned buffers, and the copy to the card (ms)."""
    from pyskani_tpu_torch.engine.batch import stack_sketches_host
    from pyskani_tpu_torch.ops.sketch import FIELDS
    t0 = time.perf_counter()
    hosts = [store._storage.load(n, device="cpu") for n in names]
    t1 = time.perf_counter()
    stack = stack_sketches_host(hosts, pin=True)
    t2 = time.perf_counter()
    stack.map(lambda t: t.to(dev, non_blocking=True))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    nbytes = sum(getattr(stack, f).numel() * getattr(stack, f).element_size()
                 for f in FIELDS)
    return dict(sketches=len(names), chunk_mb=nbytes / 1e6,
                decode_ms=(t1 - t0) * 1e3, stack_ms=(t2 - t1) * 1e3,
                copy_ms=(t3 - t2) * 1e3)


def _stream_threaded(load, names, query, *, cfg, budgets, seed_budget,
                     marker_budget, contig_budget=None, chunk=16):
    """``engine/stream.py::stream_one_vs_many`` with double buffering: a
    worker thread loads chunk i+1, stacks it into pinned buffers and
    copies it on a side CUDA stream while chunk i chains, and the compute
    stream waits on the copy's event.  The design the in-line stream is
    measured against (``--overlap``)."""
    import torch
    from concurrent.futures import ThreadPoolExecutor

    from pyskani_tpu_torch.engine import stream as stream_mod
    from pyskani_tpu_torch.engine.batch import stack_sketches_host
    from pyskani_tpu_torch.ops.sketch import FIELDS
    if not names:
        return {}
    dev = query.device
    q1 = query.map(lambda x: x[None])
    side = torch.cuda.Stream(device=dev)

    def ship(chunk_names):
        hosts = [load(n) for n in chunk_names]
        hosts += [hosts[0]] * (chunk - len(hosts))
        stack = stack_sketches_host(hosts, seed_budget, marker_budget,
                                    contig_budget, pin=True)
        with torch.cuda.stream(side):
            out = stack.map(lambda t: t.to(dev, non_blocking=True))
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    groups = [names[i:i + chunk] for i in range(0, len(names), chunk)]
    outs = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        nxt = pool.submit(ship, groups[0])
        for gi in range(len(groups)):
            cur, done = nxt.result()
            if gi + 1 < len(groups):
                nxt = pool.submit(ship, groups[gi + 1])
            compute = torch.cuda.current_stream(dev)
            compute.wait_event(done)
            # allocated on the side stream: kept from reuse until the
            # compute stream is done with it
            for f in FIELDS:
                getattr(cur, f).record_stream(compute)
            out = stream_mod.chain_block(cur, q1, cfg=cfg, budgets=budgets)
            outs.append({k: v[:, 0] for k, v in out.items()})
    P = len(names)
    return {k: torch.cat([o[k] for o in outs])[:P].cpu().numpy()
            for k in outs[0]}


def _overlap_ab(torch, rec, store, queries, pairs=4) -> dict:
    """Wall of the streamed ``queries`` on ``store`` with the port's
    in-line stream and with ``_stream_threaded``, alternated ``pairs``
    times; the hits of the two must be equal."""
    from pyskani_tpu_torch import database as dbmod
    real = dbmod.stream_one_vs_many
    walls = {"inline": [], "thread": []}
    hits = {}
    rec.phase, rec.keep = "disk_overlap", False
    try:
        for _ in range(pairs):
            for mode in walls:
                if mode == "thread":
                    dbmod.stream_one_vs_many = _stream_threaded
                try:
                    hits[mode], wall, _ = _timed(torch, lambda: [
                        store.query(n, q, learned_ani=False)
                        for n, q in queries])
                    walls[mode].append(wall)
                finally:
                    dbmod.stream_one_vs_many = real
    finally:
        rec.phase, rec.keep = None, True
    worst = max(_same_hits(a, b, "overlap A/B")
                for a, b in zip(hits["thread"], hits["inline"]))
    if worst != 0.0:
        raise AssertionError(f"threaded stream differs by {worst}")
    out = dict(queries=len(queries), thread_s=walls["thread"],
               inline_s=walls["inline"],
               gain=float(np.median(walls["inline"]) /
                          np.median(walls["thread"]) - 1))
    log(f"[disk] streamed queries x {len(queries)}, in line vs a worker "
        f"thread loading the next chunk, alternated: in line "
        f"{walls['inline']} s, thread {walls['thread']} s; hits equal; "
        f"medians, in line / thread - 1 = {out['gain']:+.3f}")
    return out


def phase_disk(result, torch, dev, rec, db, queries, fb_db, fb_queries,
               fb_hits, family, overlap=False):
    """On-disk stores and the bootstrap interval: (a) the search store
    saved in both formats, opened (streamed) and loaded; (b) a
    consolidated store of DISK["copies"] x 512 entries streamed in several
    chunks per query; (c) est_ci on the memory store, the fallback store
    and the family triangle against the CPU port; (d) the CLI's sketch
    and search --ci.  Returns the chain-DP launches of its main-path
    runs."""
    import dataclasses
    import shutil
    import tempfile

    import pyskani_tpu_torch
    from pyskani_tpu_torch import cli
    from pyskani_tpu_torch.engine import batch as eb
    from pyskani_tpu_torch.ops import chain_dp as dp_mod
    from pyskani_tpu_torch.ops import prng
    from pyskani_tpu_torch.ops.chain import ChainConfig

    Database = pyskani_tpu_torch.Database
    launches, chunks, rep = {}, {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_disk_")

    def run_queries(store, label, keep=False, n=len(queries), **kw):
        """The first ``n`` queries on ``store``: one untimed query (its DP
        grids kept for the kernels phase with ``keep``; the paths whose
        grids repeat another label's keep none), then all ``n`` timed with
        none kept.  Returns the hits; counts DP launches and chain_block
        calls (streamed chunks) of the timed run."""
        qs = queries[:n]
        n = len(qs)
        phase = rec.phase = f"disk_{label}"
        rec.keep = keep
        try:
            store.query(*queries[0], learned_ani=False, **kw)
            rec.keep = False
            before = rec.launches_of(phase, "chain_block")
            dp_mod.chain_dp.launches = 0
            hits, wall, peak = _timed(torch, lambda: [
                store.query(name, q, learned_ani=False, **kw)
                for name, q in qs])
            launches[label] = dp_mod.chain_dp.launches
            chunks[label] = rec.launches_of(phase, "chain_block") - before
        finally:
            rec.keep = True
            rec.phase = None
        rep[label] = dict(queries=n, queries_per_s=n / wall, wall_s=wall,
                          peak_gib=peak, dp_launches=launches[label],
                          chain_block_calls=chunks[label])
        log(f"[disk] {label}: {n} queries in {wall:.3f} s = "
            f"{n / wall:.2f} queries/s, peak +{peak:.3f} GiB; "
            f"chain-DP launches {launches[label]}, chain_block calls "
            f"{chunks[label]}")
        return hits

    try:
        # ---- (a) memory, then saved in both formats, opened and loaded ----
        mem_hits = run_queries(db, "memory")
        for fmt in ("consolidated", "separated"):
            path = os.path.join(tmp, fmt)
            _, save_s, _ = _timed(torch, lambda: db.save(path, format=fmt))
            nbytes = _dir_bytes(path)
            opened = Database.open(path)
            if opened.device.type != dev.type:
                raise AssertionError(f"open() runs on {opened.device}")
            hits = run_queries(opened, f"open_{fmt}",
                               keep=fmt == "consolidated")
            d_open = max(_same_hits(h, m, f"open {fmt}")
                         for h, m in zip(hits, mem_hits))
            cost = [_stream_cost(torch, opened, [h.reference_name
                                                 for h in mem_hits[0]], dev)
                    for _ in range(2)]
            loaded, load_s, load_gib = _timed(torch,
                                              lambda: Database.load(path))
            hits = run_queries(loaded, f"load_{fmt}")
            d_load = max(_same_hits(h, m, f"load {fmt}")
                         for h, m in zip(hits, mem_hits))
            del loaded, opened
            if d_open > 1e-6 or d_load > 1e-6:
                raise AssertionError(f"{fmt}: open/load hits differ from the "
                                     f"memory store's by {d_open}/{d_load}")
            rep[fmt] = dict(bytes=nbytes, save_s=save_s,
                            write_mb_s=nbytes / 1e6 / save_s, load_s=load_s,
                            load_peak_gib=load_gib, open_max_diff=d_open,
                            load_max_diff=d_load, stream_cost=cost)
            log(f"[disk] {fmt}: {nbytes / 1e6:.1f} MB written in "
                f"{save_s:.2f} s ({nbytes / 1e6 / save_s:.1f} MB/s); load() "
                f"{load_s:.2f} s, +{load_gib:.3f} GiB; open and load hits "
                f"equal the memory store's (max |diff| {d_open:.3g} / "
                f"{d_load:.3g}); one query's chunk of "
                f"{cost[-1]['sketches']} sketches ({cost[-1]['chunk_mb']:.1f} "
                f"MB), each step alone, two runs: decode "
                f"{[round(c['decode_ms'], 2) for c in cost]} ms, pinned stack "
                f"{[round(c['stack_ms'], 2) for c in cost]} ms, copy to the "
                f"card {[round(c['copy_ms'], 2) for c in cost]} ms")

        # ---- (b) a consolidated store of copies x 512 entries ----
        path = os.path.join(tmp, "copies")
        names = [m.name for m in db._markers]

        def build():
            with Database(path, format="consolidated") as big:
                for c in range(DISK["copies"]):
                    for n in names:
                        big._register_sketch(dataclasses.replace(
                            db._storage.load(n), name=f"{n}_c{c}"))

        _, build_s, _ = _timed(torch, build)
        hits = run_queries(Database.open(path), "open_copies", keep=True,
                           n=DISK["queries"])
        worst = 0.0
        for h, m in zip(hits, mem_hits):
            want = [f"{x.reference_name}_c{c}" for c in range(DISK["copies"])
                    for x in m]
            if [x.reference_name for x in h] != want:
                raise AssertionError(f"copies store hits "
                                     f"{[x.reference_name for x in h]}")
            worst = max([worst] + [_hit_diff(x, m[i % len(m)])
                                   for i, x in enumerate(h)])
        per_query = chunks["open_copies"] / len(hits)
        if worst > 1e-6 or per_query < 2:
            raise AssertionError(f"copies store: max diff {worst}, "
                                 f"{per_query} chunks per query")
        rep["copies"] = dict(entries=len(names) * DISK["copies"],
                             bytes=_dir_bytes(path), build_s=build_s,
                             shortlist=len(hits[0]),
                             chunks_per_query=per_query, max_diff=worst)
        log(f"[disk] {len(names) * DISK['copies']}-entry consolidated store "
            f"({_dir_bytes(path) / 1e6:.1f} MB, built in {build_s:.2f} s): "
            f"{len(hits[0])} hits per query in {per_query:.1f} streamed "
            f"chunks, equal to the memory store's (max |diff| {worst:.3g})")
        if overlap:
            rep["copies"]["overlap"] = _overlap_ab(
                torch, rec, Database.open(path), queries[:DISK["queries"]])
        shutil.rmtree(path)

        # ---- (c) est_ci: memory store, fallback store, family triangle ----
        ci_hits = run_queries(db, "est_ci_memory", est_ci=True)
        exact = max(_same_hits(h, m, "est_ci memory")
                    for h, m in zip(ci_hits, mem_hits))
        for h in ci_hits:
            _check_ci(h, "est_ci memory")
        cpu = Database(device="cpu")
        for h in ci_hits[0][:2]:
            cpu._register_sketch(db._storage.load(h.reference_name))
        cpu_hits = cpu.query(*queries[0], learned_ani=False, est_ci=True)
        card = {h.reference_name: h for h in ci_hits[0]}
        mem_cpu = max(max(_hit_diff(h, card[h.reference_name]),
                          _ci_diff([h], [card[h.reference_name]]))
                      for h in cpu_hits)

        fq = fb_queries[0]
        rec.phase = "disk_est_ci_fallback"
        rec.keep = False
        try:
            dp_mod.chain_dp.launches = 0
            fb_ci, _, fb_ci_gib = _timed(torch, lambda: fb_db.query(
                *fq, learned_ani=False, est_ci=True))
            launches["est_ci_fallback"] = dp_mod.chain_dp.launches
        finally:
            rec.keep = True
            rec.phase = None
        exact = max(exact, _same_hits(fb_ci, fb_hits[0], "est_ci fallback"))
        _check_ci(fb_ci, "est_ci fallback")
        pick = [next(h.reference_name for h in fb_ci
                     if h.reference_name.startswith(p)) for p in "cd"]
        cpu = Database(device="cpu")
        for n in pick:
            cpu._register_sketch(fb_db._storage.load(n))
        card = {h.reference_name: h for h in fb_ci}
        fb_cpu = max(max(_hit_diff(h, card[h.reference_name]),
                         _ci_diff([h], [card[h.reference_name]]))
                     for h in cpu.query(*fq, learned_ani=False, est_ci=True))

        sketches, fam_out = family["sketches"], family["out"]
        cfg_ci = ChainConfig(est_ci=True)
        rec.phase = "disk_est_ci_triangle"
        rec.keep = False
        try:
            dp_mod.chain_dp.launches = 0
            (_, _, tri), _, tri_gib = _timed(
                torch, lambda: eb.triangle(sketches, cfg_ci))
            launches["est_ci_triangle"] = dp_mod.chain_dp.launches
        finally:
            rec.keep = True
            rec.phase = None
        for k, v in fam_out.items():
            if not np.array_equal(tri[k], v):
                raise AssertionError(f"triangle with est_ci: {k} differs")
        lo, hi = tri["ani_ci_low"], tri["ani_ci_high"]
        # the two quantiles interpolate in f32: where every resample mean
        # is one value, the 5% bound may read one ulp above the 95% bound
        bad = ~(np.isfinite(lo) & (0 <= lo) & (lo <= hi + 1e-6) & (hi <= 1))
        if bad.any():
            i = np.nonzero(bad)[0][:4]
            raise AssertionError(
                f"triangle with est_ci: {int(bad.sum())} implausible bounds, "
                f"e.g. pairs {i.tolist()}: [{lo[i].tolist()}, "
                f"{hi[i].tolist()}]")
        # a 3-genome group and a 2 x 2 cross tile, card vs the CPU port
        rec.phase = "disk_checks"
        batch = eb.stack_sketches(sketches)
        budgets = eb.default_budgets(sketches, batch, cfg_ci)
        cpu_batch = batch.map(lambda x: x.cpu())
        tri_cpu = 0.0
        for run in (
                lambda b, t: eb.chain_triangle(
                    eb.take_sketch(b, t([0, 1, 2])), cfg=cfg_ci,
                    budgets=budgets),
                lambda b, t: eb.chain_block(
                    eb.take_sketch(b, t([0, 1])), eb.take_sketch(
                        b, t([32, 33])), cfg=cfg_ci, budgets=budgets)):
            got = _cpu(run(batch, lambda i: torch.tensor(i, device=dev)))
            want = _cpu(run(cpu_batch, torch.tensor))
            tri_cpu = max(tri_cpu, _out_diff(
                got, want, FLOAT_KEYS + ("ani_ci_low", "ani_ci_high")))
        rec.phase = None
        del batch, cpu_batch
        # the resample index tables: card vs CPU, bit for bit
        tables = 0
        for M in sorted({2 * budgets.max_fragments, 512, 768}):
            spans = torch.tensor(sorted({1, 2, 3, 97, M // 2, M - 1, M}),
                                 dtype=torch.int64).view(-1, 1, 1)
            on_card = prng.randint_from_bits(*prng.bootstrap_bits(
                100, M, dev), spans.to(dev))
            on_cpu = prng.randint_from_bits(*prng.bootstrap_bits(
                100, M, "cpu"), spans)
            if not torch.equal(on_card.cpu(), on_cpu):
                raise AssertionError(f"bootstrap indices differ at M={M}")
            tables += 1
        if exact != 0.0 or max(mem_cpu, fb_cpu, tri_cpu) > 1e-6:
            raise AssertionError(f"est_ci: other outputs moved by {exact}; vs "
                                 f"the CPU port {mem_cpu}, {fb_cpu}, "
                                 f"{tri_cpu}")
        # the wall-time overhead: plain and est_ci calls alternated, three
        # of each, so that neither side runs warmer than the other
        runs = dict(
            search=lambda ci: [db.query(n, q, learned_ani=False, est_ci=ci)
                               for n, q in queries],
            fallback=lambda ci: fb_db.query(*fq, learned_ani=False,
                                            est_ci=ci),
            triangle=lambda ci: eb.triangle(sketches,
                                            cfg_ci if ci else ChainConfig()))
        overhead = {}
        rec.phase = "disk_est_ci_timing"
        rec.keep = False
        try:
            for label, fn in runs.items():
                walls = {False: [], True: []}
                for _ in range(3):
                    for ci in (False, True):
                        walls[ci].append(_timed(torch, lambda: fn(ci))[1])
                overhead[label] = dict(
                    plain_s=walls[False], ci_s=walls[True],
                    overhead=float(np.median(walls[True]) /
                                   np.median(walls[False]) - 1))
        finally:
            rec.keep = True
            rec.phase = None
        rep["est_ci"] = dict(
            overhead=overhead, fallback_peak_gib=fb_ci_gib,
            triangle_peak_gib=tri_gib, cpu_max_diff=[mem_cpu, fb_cpu, tri_cpu],
            index_tables=tables)
        log(f"[disk] est_ci: other outputs unchanged; bounds vs the CPU port "
            f"(memory, fallback, triangle group + cross tile) max |diff| "
            f"{mem_cpu:.3g}, {fb_cpu:.3g}, {tri_cpu:.3g}; index tables "
            f"bit-equal card vs CPU at {tables} widths; family triangle "
            f"peak +{tri_gib:.2f} GiB; wall, plain vs est_ci alternated "
            f"(medians of 3): " + ", ".join(
                f"{k} {np.median(v['plain_s']):.4f} -> "
                f"{np.median(v['ci_s']):.4f} s ({v['overhead']:+.3f})"
                for k, v in overhead.items()))

        # ---- (d) the CLI: sketch, then search --ci (open and preload) ----
        paths = [_write_fasta(os.path.join(tmp, f"{n}.fa"), n, g)
                 for n, g in zip(family["names"][:4], family["genomes"][:4])]
        # the CLI reads through the native reader: its rate beside the
        # Python parser's, and the same contigs from both
        rep["reader"] = reader = _reader_rates(paths)
        log(f"[disk] FASTA reading, {reader['mb']:.1f} MB in 4 files "
            f"(medians of {len(reader['native_s'])} alternated reads): native "
            f"reader {reader['native_mb_s']:.1f} MB/s, Python parser "
            f"{reader['python_mb_s']:.1f} MB/s, same contigs; reader built "
            f"in {reader['build_s']:.2f} s")
        store = os.path.join(tmp, "cli_db")
        rec.phase = "disk_cli"
        try:
            dp_mod.chain_dp.launches = 0
            if cli.main(["sketch", *paths, "-o", store, "--device",
                         "cuda"]) != 0:
                raise AssertionError("CLI sketch failed")
            rows = {}
            for preload in (False, True):
                tsv = os.path.join(tmp, f"search_{preload}.tsv")
                if cli.main(["search", "-d", store, *paths[:2], "--ci",
                             "--device", "cuda", "-o", tsv] +
                            ["--preload"] * preload) != 0:
                    raise AssertionError("CLI search failed")
                with open(tsv) as f:
                    rows[preload] = f.read().splitlines()
            launches["cli"] = dp_mod.chain_dp.launches
        finally:
            rec.phase = None
        # the library's own rows: same grids as the CLI's, none kept
        rec.phase, rec.keep = "disk_cli_checks", False
        for preload, opener in ((False, Database.open),
                                (True, Database.load)):
            lib = opener(store)
            want = ["Ref_file\tQuery_file\tANI\tAlign_fraction_ref\t"
                    "Align_fraction_query\tANI_5_percentile\t"
                    "ANI_95_percentile"]
            for p, g in zip(paths[:2], family["genomes"][:2]):
                hits = sorted(lib.query(os.path.basename(p), g, est_ci=True),
                              key=lambda h: -h.identity)
                want += [f"{h.reference_name}\t{h.query_name}\t"
                         f"{100 * h.identity:.2f}\t"
                         f"{100 * h.reference_fraction:.2f}\t"
                         f"{100 * h.query_fraction:.2f}\t"
                         f"{100 * h.ci_low:.2f}\t{100 * h.ci_high:.2f}"
                         for h in hits
                         if max(h.query_fraction,
                                h.reference_fraction) * 100 >= 15.0]
            if rows[preload] != want or len(want) != 1 + 2 * 4:
                raise AssertionError(f"CLI search (preload {preload}) rows "
                                     f"{rows[preload]} != {want}")
        rec.phase, rec.keep = None, True
        log(f"[disk] CLI sketch of 4 FASTA files, then search --ci with and "
            f"without --preload: {len(rows[False]) - 1} rows each, equal to "
            f"the library's; chain-DP launches {launches['cli']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    main_path = ("open_consolidated", "load_consolidated", "open_separated",
                 "load_separated", "open_copies", "est_ci_memory",
                 "est_ci_fallback", "est_ci_triangle", "cli")
    for label in main_path:
        if launches[label] < 1:
            raise AssertionError(f"disk {label}: no chain-DP launch")
    total = sum(launches[k] for k in main_path)
    rep["dp_launches"] = launches
    result["disk"] = rep
    log(f"[disk] chain-DP launches on the disk phase's main paths: {total} "
        f"{ {k: launches[k] for k in main_path} }")
    return total


# mesh phase: references per rank per streamed chunk (the 512-genome store
# streams in 8 chunks at 1 x 1, 4 at 2 x 2 and 2 at 4 x 1), the spawned
# ranks of part (b) and their time limit
MESH = dict(stream_refs=64, ranks=4, timeout=900)


def _hit_rows(all_hits):
    return [[(h.reference_name, h.identity, h.query_fraction,
              h.reference_fraction) for h in hits] for hits in all_hits]


def _rows_diff(got, want, label) -> float:
    """Max |diff| of two _hit_rows lists that name the same references in
    the same order."""
    if [[r[0] for r in q] for q in got] != [[r[0] for r in q] for q in want]:
        raise AssertionError(f"{label}: hits differ in names")
    return max([0.0] + [abs(a - b) for g, w in zip(got, want)
                        for rg, rw in zip(g, w)
                        for a, b in zip(rg[1:], rw[1:])])


def _tri_diff(got, want, keys=FLOAT_KEYS, ints=True) -> float:
    """Max |diff| over ``keys`` of two triangles (ri, qi, dict); the pair
    order, and with ``ints`` every integer key, must agree exactly."""
    if not (np.array_equal(got[0], want[0]) and
            np.array_equal(got[1], want[1])):
        raise AssertionError("triangles differ in pair order")
    if ints:
        for k, v in want[2].items():
            if not np.issubdtype(np.asarray(v).dtype, np.floating) and \
                    not np.array_equal(np.asarray(got[2][k]), np.asarray(v)):
                raise AssertionError(f"triangles differ in {k}")
    return max(float(np.abs(np.asarray(got[2][k], np.float64) -
                            np.asarray(want[2][k], np.float64)).max())
               for k in keys)


def mesh_rank(store, queries, fam, shapes, ring):
    """One rank of the mesh phase's parts (b) and (c), spawned by
    ``parallel.dist.launch`` on its card: the sharded search of the saved
    store at each mesh shape of the world, then ``sharded_triangle`` and
    (with ``ring``) ``ring_triangle`` of the family's sketches.  The
    first DP grid of each path and shape is kept and, after the run, held
    bit-equal to ``chain_dp_plain``.  Returns the results, the devices
    the rank's sketches lay on, its chain-DP launches and the grids it
    checked."""
    import torch

    from pyskani_tpu_torch.ops import chain_dp as dp_mod
    from pyskani_tpu_torch.ops.chain import ChainConfig

    out = dict(hits={}, chunks={}, devices=set())
    with Recorder() as rec:
        rec.phase = "mesh"
        rec.distinct.add("mesh")
        dp_mod.chain_dp.launches = 0
        _mesh_rank_run(out, store, queries, fam, shapes, ring)
        out["launches"] = dp_mod.chain_dp.launches
    out["grids"] = _hold_plain(torch, rec.grids, ChainConfig())
    out["flags"] = rec.flag_report()
    return out


def _mesh_rank_run(out, store, queries, fam, shapes, ring):
    """The main path of one spawned rank, its wall into ``out``."""
    import torch

    from pyskani_tpu_torch import Database, convert
    from pyskani_tpu_torch.engine import batch as eb
    from pyskani_tpu_torch.ops.chain import ChainConfig
    from pyskani_tpu_torch.parallel import dist as pdist
    from pyskani_tpu_torch.parallel.mesh import make_mesh
    from pyskani_tpu_torch.parallel.search import ShardedDatabaseSearch

    t0 = time.perf_counter()
    for shape in shapes:
        mesh = make_mesh(*shape)
        s = ShardedDatabaseSearch(Database.open(store, device=mesh.device),
                                  mesh, learned_ani=False,
                                  stream_refs_per_device=MESH["stream_refs"])
        out["hits"][shape] = _hit_rows(s.query_many(queries))
        out["chunks"][shape] = len(s._ref_name_chunks)
    cfg = ChainConfig()
    sketches = [convert.sketch_from_numpy(f, n, cn, L, device=mesh.device)
                for n, f, cn, L in fam]
    batch = eb.stack_sketches(sketches)
    budgets = eb.default_budgets(sketches, batch, cfg)
    out["devices"] |= {str(batch.kmers.device), str(mesh.device)}
    out["sharded"] = pdist.sharded_triangle(batch, mesh, cfg=cfg,
                                            budgets=budgets)
    if ring:
        out["ring"] = pdist.ring_triangle(batch, mesh, cfg=cfg,
                                          budgets=budgets)
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0


def _hold_plain(torch, grids, cfg) -> list:
    """Hold each recorded (phase, path, grid) bit-equal to
    ``chain_dp_plain``; returns the (path, [R, PF]) of each."""
    from pyskani_tpu_torch.ops.chain_dp import chain_dp, chain_dp_plain
    for _, path, (q, r, m) in grids:
        s_k, t_k = chain_dp(q, r, m, cfg)
        s_p, t_p = chain_dp_plain(q, r, m, cfg)
        if not (torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
                and torch.equal(t_k, t_p)):
            raise AssertionError(f"chain_dp kernel != plain on a mesh "
                                 f"{path} grid {tuple(q.shape)}")
    return [(path, tuple(g[0].shape)) for _, path, g in grids]


def _check_ranks(ranks, want_hits, want_tri, label) -> dict:
    """Parts (b) and (c): every rank on CUDA, every rank launched the DP
    and held a ``chain_pairs`` (search) and a ``chain_block`` (triangle)
    grid bit-equal to the plain version, no rank's chain call set or
    lacked ``frag_overflow``, every rank's results equal part
    (a)'s (hits and the sharded triangle within 1e-6, integers of the
    triangle equal; the ring's estimators within 1e-6 of
    ``engine.batch.triangle``)."""
    diffs = {}
    for r, res in enumerate(ranks):
        if not res["devices"] or not all(d.startswith("cuda")
                                         for d in res["devices"]):
            raise AssertionError(f"{label} rank {r} ran on {res['devices']}")
        if res["launches"] < 1:
            raise AssertionError(f"{label} rank {r} never launched the "
                                 f"chain-DP kernel")
        if any(f[1] or f[2] for f in res["flags"].values()):
            raise AssertionError(f"{label} rank {r} frag_overflow [calls, "
                                 f"missing, flagged]: {res['flags']}")
        paths = {p for p, _ in res["grids"]}
        if not {"chain_pairs", "chain_block"} <= paths:
            raise AssertionError(f"{label} rank {r} checked grids of "
                                 f"{paths} only")
        for shape, hits in res["hits"].items():
            key = f"search {shape[0]}x{shape[1]}"
            diffs[key] = max(diffs.get(key, 0.0),
                             _rows_diff(hits, want_hits, f"{label} {key}"))
        diffs["sharded"] = max(diffs.get("sharded", 0.0), _tri_diff(
            res["sharded"], want_tri["sharded"]))
        if "ring" in res:
            diffs["ring"] = max(diffs.get("ring", 0.0), _tri_diff(
                res["ring"], want_tri["single"], ints=False))
    for k, v in diffs.items():
        if v > 1e-6:
            raise AssertionError(f"{label} {k}: max |diff| {v} vs part (a)")
    return diffs


def phase_mesh(result, torch, dev, card, rec, db, queries, family):
    """The multi-device layer (``parallel/``): (a) one NCCL rank in this
    process: ``ShardedDatabaseSearch`` on the memory search store and on
    ``open`` of it saved (streamed in 8 chunks), every plane of one step
    against ``chain_pairs``, and ``sharded_triangle`` of the family
    against ``engine.batch.triangle``, the first DP grid of each path and
    shape recorded (phase "mesh") for the kernels phase; (b) four spawned
    ranks on this card, collectives over gloo through host memory: the
    search on the saved store at 2 x 2 and 4 x 1, ``sharded_triangle``
    and ``ring_triangle``, each rank holding its own grids of each shape
    against the plain version; (c) with two cards or more, NCCL with one
    card per rank.  Returns the chain-DP launches of every rank's main
    path."""
    import shutil
    import tempfile

    import torch.distributed as tdist

    from pyskani_tpu_torch import Database, convert
    from pyskani_tpu_torch.engine import batch as eb
    from pyskani_tpu_torch.ops import chain_dp as dp_mod
    from pyskani_tpu_torch.ops.chain import ChainConfig, chain_pairs
    from pyskani_tpu_torch.parallel import dist as pdist
    from pyskani_tpu_torch.parallel.mesh import make_mesh
    from pyskani_tpu_torch.parallel.search import ShardedDatabaseSearch

    cfg = ChainConfig()
    named = [(n, [q]) for n, q in queries]
    sketches = family["sketches"]
    fam = [(s.name, convert.sketch_to_numpy(s), s.contig_names, s.lengths)
           for s in sketches]
    single = (*np.triu_indices(len(sketches), k=1), family["out"])
    rep = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        store = os.path.join(tmp, "store")
        db.save(store)

        # ---- (a) one NCCL rank in this process ----
        tdist.init_process_group(
            "nccl", store=tdist.FileStore(os.path.join(tmp, "rdv"), 1),
            world_size=1, rank=0)
        try:
            mesh = make_mesh(1, 1)
            if not (mesh.distributed and mesh.transport.type == "cuda"):
                raise AssertionError(f"(a) is not an NCCL mesh: {mesh}")
            rec.phase = "mesh"
            rec.distinct.add("mesh")
            dp_mod.chain_dp.launches = 0
            t0 = time.perf_counter()
            s_mem = ShardedDatabaseSearch(db, mesh, learned_ani=False)
            mem = _hit_rows(s_mem.query_many(named))
            s_open = ShardedDatabaseSearch(
                Database.open(store), mesh, learned_ani=False,
                stream_refs_per_device=MESH["stream_refs"])
            opened = _hit_rows(s_open.query_many(named))
            s8 = ShardedDatabaseSearch(db, mesh, learned_ani=False,
                                       queries_per_device=len(named))
            qblock = s8._query_block(named)
            planes = s8._step(s8._refs, qblock)
            batch = eb.stack_sketches(sketches)
            budgets = eb.default_budgets(sketches, batch, cfg)
            sharded = pdist.sharded_triangle(batch, mesh, cfg=cfg,
                                             budgets=budgets)
            torch.cuda.synchronize()
            wall_a = time.perf_counter() - t0
            launches_a = dp_mod.chain_dp.launches
        finally:
            rec.phase = None
            tdist.destroy_process_group()
        d_open = _rows_diff(opened, mem, "(a) open vs memory")
        n_chunks = len(s_open._ref_name_chunks)
        if n_chunks < 2 or sum(map(len, mem)) == 0:
            raise AssertionError(f"(a): {n_chunks} chunks, hits {mem}")
        # every plane of the step against chain_pairs on the passing pairs
        # (in chunks of 16, not the step's 4)
        sp = planes["screen_pass"]
        pid = torch.nonzero(sp.reshape(-1)).reshape(-1)
        Q = sp.shape[1]
        rec.phase, rec.keep = "mesh_checks", False
        try:
            ref = [chain_pairs(eb.take_sketch(s8._refs, pid[i:i + 16] // Q),
                               eb.take_sketch(qblock, pid[i:i + 16] % Q),
                               cfg=cfg, budgets=s8._budgets)
                   for i in range(0, pid.shape[0], 16)]
        finally:
            rec.phase, rec.keep = None, True
        d_planes = 0.0
        for k in ref[0]:
            want = torch.cat([r[k] for r in ref])
            got = planes[k].reshape(-1)
            if got[~sp.reshape(-1)].any():
                raise AssertionError(f"(a) plane {k}: a pair that did not "
                                     f"pass the screen is not 0")
            if want.is_floating_point():
                d_planes = max(d_planes, float(
                    (got[pid] - want).abs().max()))
            elif not torch.equal(got[pid], want):
                raise AssertionError(f"(a) plane {k} != chain_pairs")
        if int(planes["n_chained"][0]) != pid.shape[0]:
            raise AssertionError("(a) n_chained != passing pairs")
        d_tri = _tri_diff(sharded, single, ints=False)
        if max(d_open, d_planes, d_tri) > 1e-6:
            raise AssertionError(f"(a): open vs memory {d_open}, planes vs "
                                 f"chain_pairs {d_planes}, sharded triangle "
                                 f"vs engine.batch.triangle {d_tri}")
        rep["a"] = dict(wall_s=wall_a, launches=launches_a, chunks=n_chunks,
                        pairs_chained=int(pid.shape[0]),
                        open_vs_memory=d_open, planes_vs_chain_pairs=d_planes,
                        sharded_vs_triangle=d_tri,
                        grids=[(pa, tuple(g[0].shape))
                               for ph, pa, g in rec.grids if ph == "mesh"])
        log(f"[mesh] (a) 1 NCCL rank: memory and open ({n_chunks} chunks) "
            f"searches, one [{sp.shape[0]}, {Q}] step ({pid.shape[0]} pairs "
            f"chained, every plane vs chain_pairs: max |diff| "
            f"{d_planes:.3g}, integers equal), sharded_triangle vs "
            f"engine.batch.triangle max |diff| {d_tri:.3g}; wall "
            f"{wall_a:.2f} s, chain-DP launches {launches_a}, DP grids "
            f"recorded for the kernels phase {rep['a']['grids']} ({card})")
        want_tri = dict(sharded=sharded, single=single)

        # ---- (b) four ranks on this card, gloo through host memory ----
        t0 = time.perf_counter()
        ranks = pdist.launch(mesh_rank, MESH["ranks"],
                             (store, named, fam, [(2, 2), (4, 1)], True),
                             device=f"cuda:{dev.index or 0}",
                             timeout=MESH["timeout"])
        wall_b = time.perf_counter() - t0
        diffs = _check_ranks(ranks, opened, want_tri, "(b)")
        launches_b = sum(r["launches"] for r in ranks)
        rep["b"] = dict(wall_s=wall_b, rank_wall_s=[r["wall_s"] for r in ranks],
                        launches=[r["launches"] for r in ranks],
                        chunks={f"{k[0]}x{k[1]}": v
                                for k, v in ranks[0]["chunks"].items()},
                        max_diff=diffs, grids=[r["grids"] for r in ranks])
        log(f"[mesh] (b) {MESH['ranks']} gloo ranks on one card: searches "
            f"at 2x2 and 4x1 ({rep['b']['chunks']} chunks), sharded_triangle "
            f"and ring_triangle equal part (a) (max |diff| {diffs}); each "
            f"rank's DP grids of each shape bit-equal to chain_dp_plain "
            f"(rank 0: {ranks[0]['grids']}); wall "
            f"{wall_b:.2f} s (ranks {[round(r['wall_s'], 2) for r in ranks]} "
            f"s after start-up), chain-DP launches {rep['b']['launches']} "
            f"({card})")

        # ---- (c) one card per rank over NCCL ----
        n = torch.cuda.device_count()
        launches_c = 0
        if n >= 2:
            world = min(4, n)
            shapes = [(2, 2), (4, 1)] if world == 4 else \
                [(world, 1), (1, world)]
            t0 = time.perf_counter()
            ranks = pdist.launch(mesh_rank, world,
                                 (store, named, fam, shapes, True),
                                 device="cuda", timeout=MESH["timeout"])
            wall_c = time.perf_counter() - t0
            diffs = _check_ranks(ranks, opened, want_tri, "(c)")
            launches_c = sum(r["launches"] for r in ranks)
            rep["c"] = dict(world=world, wall_s=wall_c, max_diff=diffs,
                            launches=[r["launches"] for r in ranks],
                            grids=[r["grids"] for r in ranks])
            log(f"[mesh] (c) {world} NCCL ranks, one card each: equal part "
                f"(a) (max |diff| {diffs}); wall {wall_c:.2f} s, chain-DP "
                f"launches {rep['c']['launches']} ({card})")
        else:
            log(f"[mesh] (c) did not run: {n} CUDA device (NCCL with one "
                f"card per rank needs 2 or more)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result["mesh"] = rep
    return launches_a + launches_b + launches_c


def _kernel_stack(torch, seqs, dev):
    """``sketch_kernel_batch`` inputs for a stack of one-contig genomes:
    packed codes [B, L//4] and starts [B, 9] on ``dev``."""
    from pyskani_tpu_torch.ops.sketch import encode_pack, round_up
    L = round_up(max(len(s) for s in seqs), 1 << 20)
    raw = np.zeros((len(seqs), L), np.uint8)
    starts = np.zeros((len(seqs), 9), np.int32)
    for b, s in enumerate(seqs):
        raw[b, :len(s)] = np.frombuffer(s, np.uint8)
        starts[b, 1:] = len(s)
    return (encode_pack(torch.from_numpy(raw).to(dev)),
            torch.from_numpy(starts).to(dev))


def _cli_rows(hits, min_af=15.0):
    """The rows ``dist`` prints for one query's hits (best ANI first)."""
    hits = sorted(hits, key=lambda h: -h.identity)
    return [f"{h.reference_name}\t{h.query_name}\t{100 * h.identity:.2f}\t"
            f"{100 * h.reference_fraction:.2f}\t"
            f"{100 * h.query_fraction:.2f}" for h in hits
            if max(h.query_fraction, h.reference_fraction) * 100 >= min_af]


def phase_generic_k(result, torch, dev, args, rec):
    """Generic k on the card.  (a) ``sketch_kernel_batch`` at the nine
    (k, marker_k) pairs on a stack of two E. coli slices, card vs CPU
    port on every output key; (b) a k = 21 search store of 128 genomes
    built with ``sketch_many`` (sketch rates and peak memory at k = 15,
    21 and 32 on the same genomes), 8 queries each hitting its family,
    one against the CPU port, and one query and one ``sketch_many`` with
    profiling on; (c) the k = 21 store saved and opened, and the CLI's
    ``dist -k 21`` against the library.  Returns the chain-DP launches of
    its main-path runs."""
    import shutil
    import tempfile

    import pyskani_tpu_torch
    from pyskani_tpu_torch import cli
    from pyskani_tpu_torch import database as dbmod
    from pyskani_tpu_torch.io.fasta import parse
    from pyskani_tpu_torch.ops import chain_dp as dp_mod
    from pyskani_tpu_torch.ops.sketch import (marker_budget_for,
                                              seed_budget_for,
                                              sketch_kernel_batch)
    from pyskani_tpu_torch.utils import profiling

    G = GENERIC_K
    Database = pyskani_tpu_torch.Database
    rep, launches = {}, {}

    # ---- (a) the sketch kernel at nine (k, marker_k), card vs CPU ----
    ec590 = next(iter(parse(os.path.join(
        ROOT, "tests", "data", "e.coli-EC590.fasta.gz")))).seq
    a, b = G["slice_bp"]
    seqs = [ec590[:a], ec590[a:a + b]]
    packed, starts = _kernel_stack(torch, seqs, dev)
    packed_cpu, starts_cpu = packed.cpu(), starts.cpu()
    counts = {}
    for k, mk in G["pairs"]:
        kw = dict(k=k, marker_k=mk, c=125, marker_c=1000,
                  seed_budget=seed_budget_for(a, 125),
                  marker_budget=marker_budget_for(a, 1000))
        card = sketch_kernel_batch(packed, starts, [1, 1], **kw)
        cpu = sketch_kernel_batch(packed_cpu, starts_cpu, [1, 1], **kw)
        for key, want in cpu.items():
            if not torch.equal(card[key].cpu(), want):
                raise AssertionError(f"sketch k={k} marker_k={mk}: {key} "
                                     f"differs card vs CPU")
        if mk == 32 and not (card["markers_hi"][:, :int(
                card["n_markers"].min())] >= 1 << 31).any():
            raise AssertionError("marker_k=32: no marker at or above 2^63")
        counts[f"{k}/{mk}"] = card["n_seeds"].tolist() + \
            card["n_markers"].tolist()
    del packed, starts, card, cpu
    rep["kernel_pairs"] = counts
    log(f"[generic_k] sketch_kernel_batch on 2 E. coli slices ({a} + {b} "
        f"bp) equals the CPU port on every output key at {len(counts)} "
        f"(k, marker_k): seeds, seeds, markers, markers {counts}")

    # ---- (b) a k = 21 search store, sketch rates at k = 15 / 21 / 32 ----
    rng = np.random.default_rng(args.seed + 5)
    nf, per = G["families"], G["per_family"]
    root_len = rng.integers(G["root_bp"][0], G["root_bp"][1] + 1, nf)
    roots = [ACGT[rng.integers(0, 4, int(L))] for L in root_len]
    items = []
    for f in range(nf):
        for m in range(per):
            d = rng.uniform(0.005, 0.05)
            items.append((f"f{f}_m{m:02d}",
                          [mutate(rng, roots[f], d, d / 10).tobytes()]))
    queries = [(f"q{f}", mutate(rng, roots[f], 0.01, 0.001).tobytes())
               for f in range(nf)]
    bp = sum(len(c[0]) for _, c in items)
    rates = {k: dict(mbp_s=[], wall_s=[], peak_gib=[]) for k in G["rates"]}
    for _ in range(G["rounds"]):
        for k in G["rates"]:
            store = Database(k=k)
            _, wall, peak = _timed(torch, lambda: store.sketch_many(items))
            rates[k]["mbp_s"].append(bp / 1e6 / wall)
            rates[k]["wall_s"].append(wall)
            rates[k]["peak_gib"].append(peak)
            if k == 21:
                db = store
            del store
    rep["sketch_rates"] = rates
    log(f"[generic_k] sketch_many of {len(items)} genomes ({bp / 1e9:.3f} "
        f"Gbp), {G['rounds']} alternated rounds: " + "; ".join(
            f"k={k} {[round(x, 1) for x in r['mbp_s']]} Mbp/s, peak +"
            f"{[round(x, 2) for x in r['peak_gib']]} GiB"
            for k, r in rates.items()))

    passed = []
    real_screen = dbmod.screen_batch

    def screen_and_count(*a, **kw):
        passes, est = real_screen(*a, **kw)
        passed.append(int(passes.sum()))
        return passes, est

    dbmod.screen_batch = screen_and_count
    rec.phase = "generic_k"
    dp_mod.chain_dp.launches = 0
    q_times, all_hits = [], []
    try:
        for f, (qname, q) in enumerate(queries):
            t0 = time.perf_counter()
            hits = db.query(qname, q, learned_ani=False)
            torch.cuda.synchronize()
            q_times.append(time.perf_counter() - t0)
            all_hits.append(hits)
            names = sorted(h.reference_name for h in hits)
            want = [f"f{f}_m{m:02d}" for m in range(per)]
            if names != want:
                raise AssertionError(f"k=21 {qname}: hits {names} != {want}")
            for h in hits:
                if not (0.9 < h.identity <= 1.0 and
                        0.0 < h.query_fraction <= 1.0 and
                        0.0 < h.reference_fraction <= 1.0):
                    raise AssertionError(f"k=21 {qname}: implausible {h}")
        launches["search"] = dp_mod.chain_dp.launches
        rec.phase = None

        # the first query against two of its family on the CPU port
        cpu = Database(k=21, device="cpu")
        for h in all_hits[0][:2]:
            cpu._register_sketch(db._storage.load(h.reference_name))
        card = {h.reference_name: h for h in all_hits[0]}
        cpu_hits = cpu.query(*queries[0], learned_ani=False)
        worst = max(_hit_diff(h, card[h.reference_name]) for h in cpu_hits)
        if len(cpu_hits) != 2 or worst > 1e-6:
            raise AssertionError(f"k=21 card vs CPU port: {cpu_hits} (max "
                                 f"diff {worst})")

        # one query and one sketch_many with profiling on, outside the
        # timed runs: the counters must be what this phase knows
        rec.phase, rec.keep = "generic_k_profile", False
        passed.clear()
        profiling.enable()
        profiling.reset_stats()
        try:
            prof_hits = db.query(*queries[1], learned_ani=False)
            Database(k=21).sketch_many(items[:8])
            snap = profiling.stats().snapshot()
        finally:
            profiling.disable()
            profiling.reset_stats()
            rec.phase, rec.keep = None, True
    finally:
        dbmod.screen_batch = real_screen
        rec.phase = None
    want = dict(bases_sketched=float(len(queries[1][1]) + sum(
        len(c[0]) for _, c in items[:8])), refs_screened=float(len(items)),
        screen_passed=float(passed[0]), pairs_chained=float(passed[0]))
    got = {key: snap["counters"].get(key) for key in want}
    if got != want or len(prof_hits) != per or snap["calls"] != dict(
            sketch=2, screen=1, chain=1) or not all(
            t > 0 for t in snap["timers_s"].values()):
        raise AssertionError(f"profiling snapshot {snap} != {want}")
    rep["profile_snapshot"] = snap
    log(f"[generic_k] profiling on (one query, one sketch_many of 8): "
        f"{json.dumps(snap)}")
    steady = q_times[1:]
    rep.update(search=dict(refs=len(items), bp=bp, query_s=q_times,
                           queries_per_s=len(q_times) / sum(q_times),
                           steady_queries_per_s=len(steady) / sum(steady),
                           cpu_check_max_diff=worst,
                           dp_launches=launches["search"]))
    log(f"[generic_k] k=21: {len(queries)} queries, each hits exactly its "
        f"family of {per}: first {q_times[0]:.3f} s, then "
        f"{len(steady) / sum(steady):.2f} queries/s; first query vs the CPU "
        f"port on 2 references max |diff| {worst:.3g}; chain-DP launches "
        f"{launches['search']}")

    # ---- (c) the k = 21 store on disk, and the CLI's dist -k 21 ----
    tmp = tempfile.mkdtemp(prefix="chip_smoke_k21_")
    try:
        path = os.path.join(tmp, "store")
        _, save_s, _ = _timed(torch, lambda: db.save(path))
        opened = Database.open(path)
        if opened._params.k != 21:
            raise AssertionError(f"opened store has k={opened._params.k}")
        rec.phase, rec.keep = "generic_k_open", False
        try:
            dp_mod.chain_dp.launches = 0
            hits = [opened.query(n, q, learned_ani=False)
                    for n, q in queries[:2]]
            launches["open"] = dp_mod.chain_dp.launches
        finally:
            rec.phase, rec.keep = None, True
        d_open = max(_same_hits(h, m, "k=21 open")
                     for h, m in zip(hits, all_hits))
        if d_open > 1e-6:
            raise AssertionError(f"k=21 open hits differ by {d_open}")
        del opened

        refs = [items[0], items[1], items[per]]
        rpaths = [_write_fasta(os.path.join(tmp, f"{n}.fa"), n, c[0])
                  for n, c in refs]
        qpath = _write_fasta(os.path.join(tmp, "q0.fa"), "q0",
                             queries[0][1])
        tsv = os.path.join(tmp, "dist.tsv")
        rec.phase = "generic_k_cli"
        try:
            dp_mod.chain_dp.launches = 0
            if cli.main(["dist", "-q", qpath, "-r", *rpaths, "-k", "21",
                         "--learned-ani", "no", "--device", "cuda", "-o",
                         tsv]) != 0:
                raise AssertionError("CLI dist -k 21 failed")
            launches["cli"] = dp_mod.chain_dp.launches
        finally:
            rec.phase = None
        with open(tsv) as f:
            rows = f.read().splitlines()
        rec.phase, rec.keep = "generic_k_cli_checks", False
        try:
            lib = Database(k=21)
            lib.sketch_many([(os.path.basename(p), c)
                             for p, (_, c) in zip(rpaths, refs)])
            want = ["Ref_file\tQuery_file\tANI\tAlign_fraction_ref\t"
                    "Align_fraction_query"] + _cli_rows(lib.query(
                        "q0.fa", queries[0][1], learned_ani=False))
        finally:
            rec.phase, rec.keep = None, True
        if rows != want or len(rows) != 3:
            raise AssertionError(f"CLI dist -k 21 rows {rows} != {want}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rep["disk"] = dict(save_s=save_s, open_max_diff=d_open,
                       dp_launches=launches["open"])
    rep["cli"] = dict(rows=len(rows) - 1, dp_launches=launches["cli"])
    log(f"[generic_k] k=21 store saved in {save_s:.2f} s, opened: 2 "
        f"streamed queries equal the memory store's (max |diff| "
        f"{d_open:.3g}); CLI dist -k 21: {len(rows) - 1} rows equal to the "
        f"library's; chain-DP launches {launches}")
    for label, n in launches.items():
        if n < 1:
            raise AssertionError(f"generic_k {label}: no chain-DP launch")
    rep["dp_launches"] = launches
    result["generic_k"] = rep
    return sum(launches.values())


def _tie_grid(rng, R, PF, torch, dev):
    """Random tie-heavy [R, PF] grids: small coordinates, so many
    predecessors give equal candidates; rows sorted by (rcid, rpos)."""
    n = rng.integers(0, PF + 1, R)
    rp = rng.integers(0, 160, (R, PF))
    cid = rng.integers(0, 2, (R, PF))
    rev = rng.random((R, PF)) < 0.3
    qp = np.clip(rp + rng.integers(-3, 4, (R, PF)), 0, None)
    order = np.lexsort((rp, cid), axis=-1)
    rp = np.take_along_axis(rp, order, 1)
    cid = np.take_along_axis(cid, order, 1)
    ok = np.arange(PF)[None, :] < n[:, None]
    return _planes(torch, dev, qp, rp, cid, rev, ok)


def _planes(torch, dev, qp, rp, cid, rev, ok):
    meta = np.where(ok, (cid << 3) | (rev.astype(np.int64) << 1) | 1, 0)
    qp, rp = np.where(ok, qp, 0), np.where(ok, rp, 0)
    return tuple(torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
                 .to(dev) for a in (qp, rp, meta))


# edge grids of the kernel's design: label -> (valid pattern, PF, band)
EDGES = {"pf100": ("prefix", 100, 25), "band0": ("runs", 96, 0),
         "band1": ("runs", 96, 1), "band25": ("runs", 96, 25),
         "band32": ("runs", 96, 32), "resume": ("resume", 128, 32),
         "empty": ("empty", 64, 25), "cross_chunk_tie": ("tie", 64, 25)}


def _edge_grid(rng, pattern, R, PF, torch, dev):
    """[R, PF] tie-heavy near-diagonal rows whose valid anchors follow
    ``pattern``: a prefix; alternating valid and invalid runs of 1-44
    columns; valid columns resuming after 40 invalid ones; every other row
    empty; or every row with a planted tie: column 33 has two chain heads
    at gap 5 with equal candidates, column 30 (previous 32-column chunk)
    and column 32 (this chunk), and must take column 32."""
    rp = np.sort(rng.integers(0, 400, (R, PF)), 1)
    qp = np.clip(rp + rng.integers(-4, 5, (R, PF)), 0, None)
    cid = (rng.random((R, PF)) < 0.1).cumsum(1) % 8
    rev = rng.random((R, PF)) < 0.3
    cols = np.arange(PF)[None, :]
    if pattern == "prefix":
        ok = cols < rng.integers(0, PF + 1, (R, 1))
    elif pattern == "runs":
        lens = rng.integers(1, 45, (R, PF))
        run = np.zeros((R, PF), np.int64)
        for r in range(R):
            run[r] = np.repeat(np.arange(PF), lens[r])[:PF]
        ok = (run + np.arange(R)[:, None]) % 2 == 1
    elif pattern == "resume":
        stop = rng.integers(1, 40, (R, 1))
        ok = (cols < stop) | (cols >= stop + 40)
    elif pattern == "empty":
        ok = (np.arange(R)[:, None] % 2 == 0) & \
            (cols < rng.integers(0, PF + 1, (R, 1)))
    else:
        ok = cols != 31
        rp[:, :30] = np.arange(30) * 3        # columns 0-29 chain to
        qp[:, :30] = 1000 - np.arange(30)     # nothing: q falls as r rises
        rp[:, 30:34] = [90, 0, 91, 100]
        qp[:, 30:34] = [95, 0, 86, 100]
        cid[:, :34] = 0
        rev[:, :34] = False
    return _planes(torch, dev, qp, rp, cid, rev, ok)


def _dp_tests(meta, band):
    """Predecessor tests the data needs: a row with v valid anchors
    (columns 0..v-1) tests min(j, band) predecessors at column j."""
    v = (meta & 1).sum(1).double()
    b = float(band)
    small = v * (v - 1) / 2
    big = b * (b - 1) / 2 + (v - b) * b
    return float((v <= b).double().mul(small).add((v > b).double() * big)
                 .sum())


def _device_ms(torch, fn, n, flush=None):
    """Device milliseconds per call of ``fn``, and the host's enqueue
    milliseconds per call.  The n calls are queued behind a sleep kernel
    long enough to cover their enqueue, so the events time the device
    only.  Without ``flush``: one event pair around n back-to-back calls,
    divided by n.  With it: ``flush()`` before each call and one event
    pair per call, median."""
    Event = torch.cuda.Event
    torch.cuda.synchronize()
    # host enqueue per call, and the sleep kernel's cycles per ms
    t0 = time.perf_counter()
    for _ in range(5):
        if flush:
            flush()
        fn()
    host_guess = (time.perf_counter() - t0) / 5 * 1e3
    a, b = Event(enable_timing=True), Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10**6)
    b.record()
    b.synchronize()
    cycles_per_ms = 10**6 / a.elapsed_time(b)
    torch.cuda.synchronize()

    e_sleep = Event(enable_timing=True)
    e_sleep.record()
    torch.cuda._sleep(int(cycles_per_ms * (3 * n * host_guess + 20)))
    t0 = time.perf_counter()
    pairs = []
    if flush is None:
        pairs.append((Event(enable_timing=True), Event(enable_timing=True)))
        pairs[0][0].record()
        for _ in range(n):
            fn()
        pairs[0][1].record()
    else:
        for _ in range(n):
            flush()
            pairs.append((Event(enable_timing=True),
                          Event(enable_timing=True)))
            pairs[-1][0].record()
            fn()
            pairs[-1][1].record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    slept = e_sleep.elapsed_time(pairs[0][0])
    if host_ms >= slept:
        raise RuntimeError(f"the sleep ({slept:.2f} ms) did not cover the "
                           f"enqueue ({host_ms:.2f} ms): device time would "
                           f"include host time")
    times = [x.elapsed_time(y) for x, y in pairs]
    dev_ms = times[0] / n if flush is None else float(np.median(times))
    return dev_ms, host_ms / n, times


def _registers(name):
    """Registers per thread that ptxas reported for ``name``'s kernel."""
    from pyskani_tpu_torch.ops import _build
    m = re.search(r"Used (\d+) registers",
                  _build.build_logs.get(name, ""))
    return int(m.group(1)) if m else None


def _high_grid(rng, R, PF, max_gap, torch, dev):
    """[R, PF] near-diagonal rows at contig-local positions in
    [2^30, 2^31 - 1): successive anchors differ by steps whose gap
    |dr - dq| is max_gap - 1, max_gap, max_gap + 1 or small, on the
    forward or the reverse strand (per row), one or two ref contigs per
    row; valid anchors are a prefix of random length, and a tenth of the
    rows end within a step of 2^31 - 1."""
    dr = rng.integers(1, 3001, (R, PF))
    g = rng.choice([max_gap - 1, max_gap, max_gap + 1, 0, 1, 7], (R, PF))
    dq = dr + rng.choice([-1, 1], (R, PF)) * g
    dq = np.where(dq <= 0, dr + g, dq)
    dr[:, 0] = dq[:, 0] = 0
    top = (1 << 31) - 2
    span_r, span_q = dr.sum(1), dq.sum(1)
    r0 = rng.integers(1 << 30, top - span_r)
    r0[: R // 10] = top - span_r[: R // 10]
    rev = rng.random(R) < 0.5
    q0 = rng.integers((1 << 30) + span_q, top - span_q)
    rp = r0[:, None] + np.cumsum(dr, 1)
    qp = q0[:, None] + np.where(rev[:, None], -1, 1) * np.cumsum(dq, 1)
    cid = (rng.random((R, PF)) < 0.05).cumsum(1) % 2
    ok = np.arange(PF)[None, :] < rng.integers(0, PF + 1, (R, 1))
    assert rp.min() >= 1 << 30 and qp.min() >= 1 << 30 and \
        max(rp.max(), qp.max()) < (1 << 31) - 1
    return _planes(torch, dev, qp, rp, cid,
                   np.repeat(rev[:, None], PF, 1), ok)


def _row_profile(grids):
    """Valid anchors per row over grids [R, PF]: rows, share of empty rows,
    mean over all rows and over rows with anchors, max."""
    v = np.concatenate([(m & 1).sum(1).cpu().numpy() for _, _, m in grids])
    busy = v[v > 0]
    return dict(rows=int(v.size), empty_share=float(1 - busy.size / v.size),
                mean_all=float(v.mean()),
                mean_nonempty=float(busy.mean()) if busy.size else 0.0,
                max=int(v.max()))


def _time_kernel(torch, dev, grid, cfg, label, n_plain=3):
    """Device ms of the kernel on ``grid`` (warm: 200 launches back to
    back; cold: L2 flushed before each of 30), the wrapper's host ms per
    call, the plain version's ms (median of ``n_plain``) and the card's
    bound."""
    from pyskani_tpu_torch.ops.chain_dp import chain_dp, chain_dp_plain

    q, r, m = grid
    R, PF = q.shape

    def call():
        chain_dp(q, r, m, cfg)

    flush_buf = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    for _ in range(5):
        call()
    ms, host_ms, warm_times = _device_ms(torch, call, 200)
    cold_ms, _, cold_times = _device_ms(torch, call, 30,
                                        flush=flush_buf.zero_)
    del flush_buf
    plain = []
    for _ in range(n_plain):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain_dp_plain(q, r, m, cfg)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3)
    bytes_ms = R * PF * 20 / PEAK_BYTES * 1e3
    tests = _dp_tests(m, cfg.chain_band)
    ops_ms = tests * DP_OPS_PER_TEST / PEAK_OPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    prof = _row_profile([grid])
    log(f"[kernels] {label} grid [R, PF] = [{R}, {PF}] (valid anchors per "
        f"row: mean {prof['mean_all']:.1f}, {prof['mean_nonempty']:.1f} "
        f"over the {1 - prof['empty_share']:.3f} of rows with anchors, max "
        f"{prof['max']}): device {ms:.5f} ms warm (200 back-to-back "
        f"launches), {cold_ms:.5f} ms with L2 flushed (median of 30); "
        f"wrapper host time {host_ms:.4f} ms per call; plain "
        f"{float(np.median(plain)):.2f} ms")
    log(f"[kernels] {label} bound {bound_ms:.5f} ms by {bound_by} (bytes "
        f"{bytes_ms:.5f} ms, {tests:.0f} predecessor tests -> "
        f"{ops_ms:.5f} ms): warm time {ms / bound_ms:.2f}x the bound")
    return dict(shape=[R, PF], rows=prof, warm_ms=ms,
                warm_batch_ms=warm_times, cold_ms=cold_ms,
                cold_times_ms=cold_times, host_ms_per_call=host_ms,
                plain_ms=plain, plain_median_ms=float(np.median(plain)),
                bytes_ms=bytes_ms, ops_ms=ops_ms, predecessor_tests=tests,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_kernels(result, torch, dev, rec, launches):
    from pyskani_tpu_torch.ops.chain import ChainConfig
    from pyskani_tpu_torch.ops.chain_dp import chain_dp, chain_dp_plain

    cfg = ChainConfig()
    rng = np.random.default_rng(1)
    cases = [(f"{phase}/{path}", g, cfg) for phase, path, g in rec.grids]
    n_recorded = len(cases)
    cases += [("ties", _tie_grid(rng, 1000, 64, torch, dev), cfg),
              ("ties", _tie_grid(rng, 4096, 256, torch, dev), cfg)]
    cases += [(label, _edge_grid(rng, pattern, 2048, PF, torch, dev),
               ChainConfig(chain_band=band))
              for label, (pattern, PF, band) in EDGES.items()]
    cases.append(("high_positions", _high_grid(
        rng, 2048, 128, cfg.max_gap_length, torch, dev), cfg))
    worst = 0.0
    plain_s = {}
    for label, (q, r, m), c in cases:
        s_k, t_k = chain_dp(q, r, m, c)
        t0 = time.perf_counter()
        s_p, t_p = chain_dp_plain(q, r, m, c)
        torch.cuda.synchronize()
        plain_s[label] = plain_s.get(label, 0.0) + time.perf_counter() - t0
        err = float((s_k - s_p).abs().max()) if s_k.numel() else 0.0
        worst = max(worst, err)
        if not (torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
                and torch.equal(t_k, t_p)):
            raise AssertionError(f"chain_dp kernel != plain on a {label} "
                                 f"grid {tuple(q.shape)} band "
                                 f"{c.chain_band} (max |dscore| {err})")
        if label == "cross_chunk_tie" and not (t_k[:, 33] == 32).all():
            raise AssertionError("chain_dp: the planted cross-chunk tie "
                                 "did not resolve to the newer anchor")
        if label == "high_positions" and not (s_k > c.anchor_score).any():
            raise AssertionError("chain_dp: no chain on the high-position "
                                 "grid")
    counts = {}
    for label, _, _ in cases[:n_recorded]:
        counts[label] = counts.get(label, 0) + 1
    # the mesh's own grids: the sharded step's and the sharded triangle's
    for path in ("chain_pairs", "chain_block"):
        if not counts.get(f"mesh/{path}"):
            raise AssertionError(f"no mesh {path} grid was held against "
                                 f"the plain version")
    log(f"[kernels] chain_dp bit-equal to its plain version on "
        f"{len(cases)} grids (recorded {counts}, 2 tie-heavy, edges "
        f"{list(EDGES)}, high_positions); plain version seconds per kind "
        f"{ {k: round(v, 3) for k, v in plain_s.items()} }")

    search = _time_kernel(torch, dev, rec.grids_of("search")[0], cfg,
                          "search")
    # the fallback's largest per-pair grid (NF is 256 or 384 by query size)
    pairs_grid = max(rec.grids_of("fallback", "chain_pairs"),
                     key=lambda g: g[0].shape[0])
    fallback = _time_kernel(torch, dev, pairs_grid, cfg, "fallback")
    giant = _time_kernel(torch, dev, rec.grids_of("giant", "chain_pairs")[0],
                         cfg, "giant", n_plain=1)
    tri_group = _time_kernel(
        torch, dev, rec.grids_of("triangle", "chain_triangle")[0], cfg,
        "triangle group")
    tri_cross = _time_kernel(
        torch, dev, rec.grids_of("triangle", "chain_block")[0], cfg,
        "triangle cross tile", n_plain=1)
    k21 = _time_kernel(torch, dev, rec.grids_of("generic_k")[0], cfg,
                       "k=21 search")
    profiles = {ph: _row_profile(rec.grids_of(ph, "chain_pairs"))
                for ph in ("fallback", "giant")}
    log(f"[kernels] chain_pairs row profiles (valid anchors per row): "
        f"{profiles}")
    regs = _registers("chain_dp")
    log(f"[kernels] chain_dp: {regs} registers")
    entry = dict(name="chain_dp", route="cuda",
                 source="pyskani_tpu_torch/csrc/chain_dp.cu",
                 replaces="pyskani_tpu/ops/chain_dp_pallas.py:47",
                 launches=launches, max_abs_err=worst, ms=search["warm_ms"],
                 plain_ms=search["plain_median_ms"],
                 bound_ms=search["bound_ms"], bound_by=search["bound_by"],
                 library_ms=None)
    result["kernels"] = [entry]
    result["kernel_detail"] = dict(
        search=search, fallback=fallback, giant=giant,
        triangle_group=tri_group, triangle_cross=tri_cross, k21_search=k21,
        pair_row_profiles=profiles,
        registers=regs, grids_checked=len(cases), recorded=counts,
        plain_s=plain_s)
    return entry


def check_flags(result, report: dict) -> None:
    """Every chain call of every phase returned ``frag_overflow``, and no
    pair of a default-budget phase (all but ``frag_budget``) set it."""
    bad = {ph: r for ph, r in report.items()
           if r[1] or (r[2] and ph != "frag_budget")}
    if bad or not report.get("frag_budget", [0, 0, 0])[2]:
        raise AssertionError(f"frag_overflow per phase [calls, missing, "
                             f"flagged]: {report}")
    calls = sum(r[0] for r in report.values())
    log(f"[flags] frag_overflow on all {calls} chain calls of this "
        f"process; flagged pairs only in the frag_budget part "
        f"({report['frag_budget'][2]}): {report}")
    result["frag_overflow_report"] = report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--refs", type=int, default=512)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one query and one sketch")
    ap.add_argument("--overlap", action="store_true",
                    help="also time the streamed store's queries against "
                         "a double-buffered stream")
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()
    if args.refs % 32 or args.refs < 64 or not 1 <= args.queries <= 32:
        ap.error("--refs must be a multiple of 32 (>= 64), --queries 1-32")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "pyskani_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(pyskani_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    result = dict(args=vars(args), torch=torch.__version__,
                  cuda=torch.version.cuda)

    phase_build(result)
    card = card_line()
    result["card"] = card
    log(f"[card] {card}")
    phase_goldens(result, torch, dev)

    with Recorder() as rec:
        rec.phase = "search"
        search_launches, search_db, search_queries = phase_search(
            result, torch, dev, args, rec)
        rec.phase = None
        db, queries, fb_hits, fb_launches = phase_fallback(
            result, torch, dev, args, rec)
        giant_launches = phase_giant(result, torch, dev, args, rec, db,
                                     queries, fb_hits)
        tri_launches, frag_launches, family = phase_triangle(
            result, torch, dev, args, rec, db)
        disk_launches = phase_disk(result, torch, dev, rec, search_db,
                                   search_queries, db, queries, fb_hits,
                                   family, overlap=args.overlap)
        del db
        gk_launches = phase_generic_k(result, torch, dev, args, rec)
        mesh_launches = phase_mesh(result, torch, dev, card, rec, search_db,
                                   search_queries, family)
    del search_db, family
    check_flags(result, rec.flag_report())
    main_launches = search_launches + fb_launches + giant_launches + \
        tri_launches + disk_launches + gk_launches + mesh_launches
    launches = main_launches + frag_launches
    log(f"[launches] chain-DP kernel on the main paths: search "
        f"{search_launches}, fallback {fb_launches}, giant {giant_launches}, "
        f"triangle {tri_launches}, disk {disk_launches}, generic_k "
        f"{gk_launches}, mesh {mesh_launches}: {main_launches}; with the "
        f"fragment-budget part's {frag_launches}: {launches}")
    entry = phase_kernels(result, torch, dev, rec, launches)
    result["total_s"] = time.perf_counter() - t_start
    log(f"[done] {result['total_s']:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
