#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one GPU and check it.

    python3 chip_smoke.py [--seed 0] [--refs 512] [--queries 8] [--out FILE]

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
             must hit exactly its family.  The chain-DP kernel's launch
             count is reset just before this phase and read just after;
             the first query's hits are checked against the CPU port;
5. kernels — every DP grid the search fed the kernel, random tie-heavy
             grids and edge grids (PF = 100, bands 0/1/25/32, anchors
             resuming after 40 invalid columns, empty rows, a tie across
             two 32-column chunks) through the CUDA kernel and its plain
             PyTorch version: score and root must be bit-equal.  Times
             the kernel on the first search grid as device time (launches
             queued behind a sleep kernel, so the host's enqueue is off
             the clock), warm and with L2 flushed, the wrapper's host
             time per call and the plain version, and computes the card's
             bound for the work.

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


def phase_search(result, torch, dev, args, recorded):
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
    shapes = sorted({tuple(g[0].shape) for g in recorded})
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
    return launches


def _profile(torch, fn):
    """Device busy time, wall time and the top device activities (kernels,
    copies) of one call."""
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
    out = dict(wall_us=wall_us, device_busy_us=busy,
               idle_share=1.0 - busy / wall_us,
               device_launches=sum(n for _, n in by_name.values()),
               chain_dp_us=dp_us,
               top=[dict(name=k[:80], device_us=us, count=n)
                    for k, (us, n) in top])
    log(f"[profile] wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms in {out['device_launches']} device "
        f"activities, idle share {out['idle_share']:.3f}; chain-DP kernel "
        f"{dp_us / 1e3:.4f} ms")
    for t in out["top"][:8]:
        log(f"[profile]   {t['device_us'] / 1e3:9.3f} ms x{t['count']:5d} "
            f"{t['name']}")
    return out


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


def phase_kernels(result, torch, dev, recorded, launches):
    from pyskani_tpu_torch.ops.chain import ChainConfig
    from pyskani_tpu_torch.ops.chain_dp import chain_dp, chain_dp_plain

    cfg = ChainConfig()
    rng = np.random.default_rng(1)
    cases = [("search", g, cfg) for g in recorded]
    cases += [("ties", _tie_grid(rng, 1000, 64, torch, dev), cfg),
              ("ties", _tie_grid(rng, 4096, 256, torch, dev), cfg)]
    cases += [(label, _edge_grid(rng, pattern, 2048, PF, torch, dev),
               ChainConfig(chain_band=band))
              for label, (pattern, PF, band) in EDGES.items()]
    worst = 0.0
    for label, (q, r, m), c in cases:
        s_k, t_k = chain_dp(q, r, m, c)
        s_p, t_p = chain_dp_plain(q, r, m, c)
        torch.cuda.synchronize()
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
    log(f"[kernels] chain_dp bit-equal to its plain version on "
        f"{len(cases)} grids ({len(recorded)} from the search, 2 tie-heavy, "
        f"edges {list(EDGES)})")

    q, r, m = recorded[0]
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
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain_dp_plain(q, r, m, cfg)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3)
    plain_ms = float(np.median(plain))
    bytes_ms = R * PF * 20 / PEAK_BYTES * 1e3
    tests = _dp_tests(m, cfg.chain_band)
    ops_ms = tests * DP_OPS_PER_TEST / PEAK_OPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    regs = _registers("chain_dp")
    valid_cols = int((m & 1).sum())
    log(f"[kernels] chain_dp at [R, PF] = [{R}, {PF}] ({valid_cols} valid "
        f"anchors, {valid_cols / R:.1f} per row): device {ms:.5f} ms warm "
        f"(200 back-to-back launches), {cold_ms:.5f} ms with L2 flushed "
        f"(median of 30); wrapper host time {host_ms:.4f} ms per call; "
        f"plain {plain_ms:.2f} ms; {regs} registers")
    log(f"[kernels] bound {bound_ms:.5f} ms by {bound_by} (bytes "
        f"{bytes_ms:.5f} ms, {tests:.0f} predecessor tests -> "
        f"{ops_ms:.5f} ms): warm time {ms / bound_ms:.2f}x the bound")
    entry = dict(name="chain_dp", route="cuda",
                 source="pyskani_tpu_torch/csrc/chain_dp.cu",
                 replaces="pyskani_tpu/ops/chain_dp_pallas.py:47",
                 launches=launches, max_abs_err=worst, ms=ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=None)
    result["kernels"] = [entry]
    result["kernel_detail"] = dict(
        shape=[R, PF], valid_anchors=valid_cols, warm_ms=ms,
        warm_batch_ms=warm_times, cold_ms=cold_ms, cold_times_ms=cold_times,
        host_ms_per_call=host_ms, registers=regs, plain_ms=plain,
        bytes_ms=bytes_ms, ops_ms=ops_ms, predecessor_tests=tests)
    return entry


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--refs", type=int, default=512)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one query and one sketch")
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

    from pyskani_tpu_torch.ops import chain as chain_mod
    real_dp = chain_mod.chain_dp
    recorded = []

    def record_dp(q, r, m, cfg):
        if q.is_cuda:
            recorded.append((q.clone(), r.clone(), m.clone()))
        return real_dp(q, r, m, cfg)

    chain_mod.chain_dp = record_dp
    try:
        launches = phase_search(result, torch, dev, args, recorded)
    finally:
        chain_mod.chain_dp = real_dp
    entry = phase_kernels(result, torch, dev, recorded, launches)
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
