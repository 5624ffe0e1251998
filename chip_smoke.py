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
5. kernels — every DP grid the search fed the kernel, plus random
             tie-heavy grids, through the CUDA kernel and its plain
             PyTorch version: score and root must be bit-equal.  Times
             the kernel (median of CUDA-event-timed launches) and the
             plain version and computes the card's bound for the work.

The last three lines are the card line, one ``{"kernels": [...]}`` JSON
object and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
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
    # NL = 16 x 256 = 4096 lanes
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
        f"grid shapes [PF, NL] {shapes}")

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
    out = dict(wall_us=wall_us, device_busy_us=busy,
               idle_share=1.0 - busy / wall_us,
               device_launches=sum(n for _, n in by_name.values()),
               top=[dict(name=k[:80], device_us=us, count=n)
                    for k, (us, n) in top])
    log(f"[profile] wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms in {out['device_launches']} device "
        f"activities, idle share {out['idle_share']:.3f}")
    for t in out["top"][:8]:
        log(f"[profile]   {t['device_us'] / 1e3:9.3f} ms x{t['count']:5d} "
            f"{t['name']}")
    return out


def _tie_grid(rng, PF, NL, torch, dev):
    """Random tie-heavy [PF, NL] grids: small coordinates, so many
    predecessors give equal candidates; rows sorted by (rcid, rpos)."""
    n = rng.integers(0, PF + 1, NL)
    rp = rng.integers(0, 160, (NL, PF))
    cid = rng.integers(0, 2, (NL, PF))
    rev = rng.random((NL, PF)) < 0.3
    qp = np.clip(rp + rng.integers(-3, 4, (NL, PF)), 0, None)
    order = np.lexsort((rp, cid), axis=-1)
    rp = np.take_along_axis(rp, order, 1)
    cid = np.take_along_axis(cid, order, 1)
    ok = np.arange(PF)[None, :] < n[:, None]
    meta = np.where(ok, (cid << 3) | (rev.astype(np.int64) << 1) | 1, 0)
    qp, rp = np.where(ok, qp, 0), np.where(ok, rp, 0)
    return tuple(torch.from_numpy(np.ascontiguousarray(a.T).astype(np.int32))
                 .to(dev) for a in (qp, rp, meta))


def _dp_tests(meta_t, band):
    """Predecessor tests the data needs: lane with v valid anchors (rows
    0..v-1) tests min(j, band) predecessors at row j."""
    v = (meta_t & 1).sum(0).double()
    b = float(band)
    small = v * (v - 1) / 2
    big = b * (b - 1) / 2 + (v - b) * b
    return float((v <= b).double().mul(small).add((v > b).double() * big)
                 .sum())


def phase_kernels(result, torch, dev, recorded, launches):
    from pyskani_tpu_torch.ops.chain import ChainConfig
    from pyskani_tpu_torch.ops.chain_dp import chain_dp, chain_dp_plain

    cfg = ChainConfig()
    rng = np.random.default_rng(1)
    cases = [("search", g) for g in recorded]
    cases += [("ties", _tie_grid(rng, 64, 1000, torch, dev)),
              ("ties", _tie_grid(rng, 256, 4096, torch, dev))]
    worst = 0.0
    for label, (q, r, m) in cases:
        s_k, t_k = chain_dp(q, r, m, cfg)
        s_p, t_p = chain_dp_plain(q, r, m, cfg)
        torch.cuda.synchronize()
        err = float((s_k - s_p).abs().max()) if s_k.numel() else 0.0
        worst = max(worst, err)
        if not (torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
                and torch.equal(t_k, t_p)):
            raise AssertionError(f"chain_dp kernel != plain on a {label} "
                                 f"grid {tuple(q.shape)} (max |dscore| "
                                 f"{err})")
    log(f"[kernels] chain_dp bit-equal to its plain version on "
        f"{len(cases)} grids ({len(recorded)} from the search)")

    q, r, m = recorded[0]
    PF, NL = q.shape
    for _ in range(5):
        chain_dp(q, r, m, cfg)
    times = []
    for _ in range(50):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        chain_dp(q, r, m, cfg)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    ms = float(np.median(times))
    plain = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain_dp_plain(q, r, m, cfg)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3)
    plain_ms = float(np.median(plain))
    bytes_ms = PF * NL * 20 / PEAK_BYTES * 1e3
    tests = _dp_tests(m, cfg.chain_band)
    ops_ms = tests * DP_OPS_PER_TEST / PEAK_OPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"[kernels] chain_dp at [PF, NL] = [{PF}, {NL}]: kernel {ms:.4f} ms "
        f"(median of 50, min {min(times):.4f}), plain {plain_ms:.2f} ms; "
        f"bound {bound_ms:.5f} ms by {bound_by} (bytes {bytes_ms:.5f} ms, "
        f"{tests:.0f} predecessor tests -> {ops_ms:.5f} ms)")
    entry = dict(name="chain_dp", route="cuda",
                 source="pyskani_tpu_torch/csrc/chain_dp.cu",
                 replaces="pyskani_tpu/ops/chain_dp_pallas.py:47",
                 launches=launches, max_abs_err=worst, ms=ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=None)
    result["kernels"] = [entry]
    result["kernel_detail"] = dict(shape=[PF, NL], times_ms=times,
                                   plain_ms=plain, bytes_ms=bytes_ms,
                                   ops_ms=ops_ms, predecessor_tests=tests)
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
