"""The packed post-DP (``ops/chain_post.py``): the per-chain stage and
the per-pair tail.

``chain_post_plain`` (what ``chain_post`` runs for CPU tensors) is held
to a NumPy loop over rows and roots on hand-built [P*NF, PF] grids: rows
empty and full, roots at 0 and PF - 1, the score and long-span keep
rules, both ``est_side`` modes, kept anchors past the reference grid, and
more kept chains than ``max_chains_per_pair``.  ``chain_tail_plain``
(what ``chain_tail`` runs for CPU tensors) is held to a NumPy loop over
pairs on hand-built stage outputs and genome stacks: empty pairs, 0, 1
and 2 covered fragments, both ``est_side`` modes, both denominator
masks, reference span pieces past the grid, more kept chains than
``max_chains_per_pair``, and the sorted rows the ``est_ci`` bootstrap
draws on.  The wrappers' refusals, the tail kernel's shared-memory limit
and the CPU paths' silent ``post_kernel_pairs`` and ``post_tail_pairs``
counters are checked here too.  Where a card is present, the per-chain
kernel is held bit-equal to its plain version on DP-made grids at the
triangle's shapes, the tail kernel to its plain version on the same
hand-built inputs and on the inputs of a search call and a triangle
group, and the triangle and one-vs-many paths give the same results
through both kernels as through the plain versions.  The file imports
neither JAX nor ``conftest``'s helpers, so it runs on a card's machine
with ``--noconftest``.
"""

import numpy as np
import pytest
import torch

from pyskani_tpu_torch.ops import chain as chain_mod
from pyskani_tpu_torch.ops.chain import NEG_BIG, POS_BIG, ChainConfig
from pyskani_tpu_torch.ops.chain_dp import chain_dp
from pyskani_tpu_torch.ops.chain_post import (KEYS, MAX_PF, MAX_TAIL,
                                              GenomeTables, chain_post,
                                              chain_post_plain, chain_tail,
                                              chain_tail_plain, tail_fits)
from pyskani_tpu_torch.ops.sketch import FIELDS, I32_SENTINEL, DeviceSketch
from pyskani_tpu_torch.utils import profiling

torch.set_num_threads(1)

RBITS = 3
CR = 1 << RBITS          # reference contig slots
FL = 1000                # fragment length of the hand-built grids


def _grid(P, NF, PF, *, seed, full=0.1, empty=0.3, root0=0.0, new=0.3,
          rpos_hi=30_000, G=3, dev="cpu"):
    """Hand-built stage inputs: rows of random counts (a share ``empty``
    with none, a share ``full`` with PF or more), the valid prefix packed
    as the grid words, scores in [50, 400], and roots that start a chain
    with probability ``new`` or join an earlier anchor's chain (every
    anchor of a share ``root0`` of the rows joins column 0's)."""
    rng = np.random.default_rng(seed)
    R = P * NF
    counts = rng.integers(1, PF + 1, R)
    counts[rng.random(R) < full] = PF + rng.integers(0, 4)
    counts[rng.random(R) < empty] = 0
    n = np.minimum(counts, PF)
    valid = np.arange(PF)[None, :] < n[:, None]
    qpos = rng.integers(0, 1 << 29, (R, PF))
    rpos = rng.integers(0, rpos_hi, (R, PF))
    rcid = rng.integers(0, CR, (R, PF))
    rev = rng.integers(0, 2, (R, PF))
    w1 = np.where(valid, (qpos << 2) | (rev << 1) | 1, 0)
    w2 = np.where(valid, (rpos << RBITS) | rcid, 0)
    roots = np.zeros((R, PF), np.int64)
    all0 = rng.random(R) < root0
    for r in range(R):
        for j in range(1, PF):
            if all0[r]:
                roots[r, j] = 0
            elif rng.random() >= new:
                roots[r, j] = roots[r, rng.integers(0, j)]
            else:
                roots[r, j] = j
    scores = rng.uniform(50, 400, (R, PF)).astype(np.float32)
    # reference fragment offsets of G genomes, CR contigs of 1-12
    # fragments each
    fo = np.zeros((G, CR + 1), np.int64)
    fo[:, 1:] = np.cumsum(rng.integers(1, 13, (G, CR)), 1)
    as_t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return dict(
        w1g=as_t(w1), w2g=as_t(w2), scores=as_t(scores),
        roots=as_t(roots.astype(np.int32)),
        row_bounds=as_t(np.concatenate([[0], np.cumsum(counts)])),
        tail_r=as_t(rng.integers(0, G, P)), r_frag_offs=as_t(fo))


def _oracle(g, cfg, NF, CE):
    """The stage as a loop over rows and roots in NumPy."""
    w1, w2, sc, rt = (g[k].numpy() for k in ("w1g", "w2g", "scores",
                                             "roots"))
    tail_r, fo = g["tail_r"].numpy(), g["r_frag_offs"].numpy()
    R, PF = w1.shape
    P = R // NF
    Cr = fo.shape[1] - 1
    rmask = (1 << RBITS) - 1
    fl = cfg.fragment_length
    o = dict(numer=np.zeros(R, np.int64), span_lo=np.full(R, POS_BIG),
             span_hi=np.full(R, NEG_BIG), n_chains=np.zeros(P, np.int32),
             row_sel=np.zeros((P, CE), np.int64),
             end_valid=np.zeros((P, CE), bool),
             end_qmn=np.full((P, CE), I32_SENTINEL),
             end_qmx=np.full((P, CE), I32_SENTINEL),
             end_rmn=np.full((P, CE), I32_SENTINEL),
             end_rmx=np.full((P, CE), I32_SENTINEL),
             end_rcid=np.zeros((P, CE), np.int64),
             numer_r=np.zeros((P, NF), np.int64),
             ref_over=np.zeros(P, bool))
    for p in range(P):
        for f in range(NF):
            r = p * NF + f
            chains = {}
            for j in np.nonzero(w1[r] & 1)[0]:
                chains.setdefault(min(max(int(rt[r, j]), 0), PF - 1),
                                  []).append(j)
            kept = set()
            for b in sorted(chains):
                js = chains[b]
                qmn, qmx = w1[r, js].min() >> 2, w1[r, js].max() >> 2
                k = len(js) >= cfg.min_anchors_chain
                if cfg.min_chain_score > 0:
                    k &= bool(sc[r, js].max() >=
                              np.float32(cfg.min_chain_score))
                if cfg.keep_long_span > 0:
                    k |= len(js) >= 2 and qmx - qmn >= cfg.keep_long_span
                if not k:
                    continue
                kept.add(b)
                o["numer"][r] += len(js)
                o["span_lo"][r] = min(o["span_lo"][r], qmn - cfg.extend_left)
                o["span_hi"][r] = max(o["span_hi"][r],
                                      qmx + cfg.extend_right)
                s = o["n_chains"][p]
                o["n_chains"][p] += 1
                if s < CE:
                    rmn, rmx = w2[r, js].min(), w2[r, js].max()
                    o["row_sel"][p, s] = f
                    o["end_valid"][p, s] = True
                    o["end_qmn"][p, s], o["end_qmx"][p, s] = qmn, qmx
                    o["end_rmn"][p, s] = rmn >> RBITS
                    o["end_rmx"][p, s] = rmx >> RBITS
                    o["end_rcid"][p, s] = rmn & rmask
            if cfg.est_side != "both":
                continue
            for b in kept:
                for j in chains[b]:
                    rcid = min(max(int(w2[r, j] & rmask), 0), Cr - 1)
                    frag = fo[tail_r[p], rcid] + (w2[r, j] >> RBITS) // fl
                    if frag < NF:
                        o["numer_r"][p, frag] += 1
                    else:
                        o["ref_over"][p] = True
    return o


BASE = dict(P=3, NF=8, PF=48)
CASES = {
    # name: (grid arguments, config fields, max_chains_per_pair)
    "empty_and_full": (dict(full=0.4, empty=0.4), {}, 64),
    "roots_at_0": (dict(root0=0.5, full=0.3), {}, 64),
    "roots_at_pf_minus_1": (dict(full=0.9, empty=0.0, new=0.9), {}, 512),
    "keep_long_span": (dict(new=0.2), dict(min_chain_score=1e9,
                                           keep_long_span=2_500), 64),
    "min_chain_score": (dict(), dict(min_chain_score=300.5,
                                     keep_long_span=0), 64),
    "no_score_rule": (dict(), dict(min_chain_score=0.0,
                                   min_anchors_chain=3), 64),
    "est_chunk": (dict(rpos_hi=400_000), dict(est_side="chunk"), 64),
    "est_both": (dict(), dict(est_side="both"), 64),
    "ref_over": (dict(rpos_hi=400_000), dict(est_side="both"), 64),
    "truncated_at_ce": (dict(new=0.6, empty=0.0), dict(min_chain_score=0.0),
                        5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_oracle(case):
    kw, fields, CE = CASES[case]
    g = _grid(**BASE, seed=sorted(CASES).index(case), **kw)
    cfg = ChainConfig(fragment_length=FL, **fields)
    NF = BASE["NF"]
    got = chain_post(*g.values(), cfg, NF=NF, CE=CE, rcid_bits=RBITS)
    want = _oracle(g, cfg, NF, CE)
    assert tuple(got) == KEYS
    for k in KEYS:
        assert got[k].dtype == torch.from_numpy(want[k]).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # each case exercises what it names
    n = torch.clamp(g["row_bounds"].diff(), max=BASE["PF"])
    kept = int(got["n_chains"].sum())
    assert kept > 0
    if case == "empty_and_full":
        assert (n == 0).any() and (g["row_bounds"].diff() > n).any()
    if case == "roots_at_0":
        assert (g["roots"][n > 1, 1:] == 0).all(1).any()
    if case == "roots_at_pf_minus_1":
        full = n == BASE["PF"]
        assert (g["roots"][full, -1] == BASE["PF"] - 1).any()
    if case == "keep_long_span":
        assert (got["end_qmx"] - got["end_qmn"])[got["end_valid"]].min() \
            >= 2_500
    if case in ("est_chunk", "ref_over"):
        assert got["ref_over"].any() == (case == "ref_over")
    if case == "est_chunk":
        assert not got["numer_r"].any()
    if case == "est_both":
        assert got["numer_r"].sum() > 0
    if case == "truncated_at_ce":
        assert (got["n_chains"] > CE).all() and got["end_valid"].all()


def test_dp_grid_matches_oracle():
    """Grids whose scores and roots are the chain DP's (plain version),
    as the pipeline feeds the stage."""
    g = _dp_grid(2, 16, 64, seed=7, dev="cpu")
    # fragments long enough that some kept anchors fall inside NF = 16
    cfg = ChainConfig(fragment_length=500_000)
    got = chain_post(*g.values(), cfg, NF=16, CE=128, rcid_bits=RBITS)
    want = _oracle(g, cfg, 16, 128)
    assert int(got["n_chains"].sum()) > 0 and got["numer_r"].sum() > 0
    for k in KEYS:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def _small():
    return _grid(P=1, NF=2, PF=8, seed=0)


@pytest.mark.parametrize("which,bad,match", [
    ("w1g", lambda t: t.to(torch.int32), "w1g must be"),
    ("scores", lambda t: t.to(torch.float64), "scores must be"),
    ("roots", lambda t: t.to(torch.int64), "roots must be"),
    ("row_bounds", lambda t: t[:-1], "row_bounds must be"),
    ("tail_r", lambda t: t.to(torch.int32), "tail_r must be"),
    ("w2g", lambda t: t.to("meta"), "CUDA device"),
])
def test_wrapper_refuses(which, bad, match):
    g = _small()
    g[which] = bad(g[which])
    with pytest.raises(ValueError, match=match):
        chain_post(*g.values(), ChainConfig(), NF=2, CE=8, rcid_bits=RBITS)


def test_wrapper_refuses_pf_past_limit():
    PF = MAX_PF + 2
    z = torch.zeros((1, PF), dtype=torch.int64)
    with pytest.raises(ValueError, match="exceeds the kernel's limit"):
        chain_post(z, z, z.float(), z.int(), torch.zeros(2, dtype=torch.int64),
                   torch.zeros(1, dtype=torch.int64),
                   torch.zeros((1, 2), dtype=torch.int64), ChainConfig(),
                   NF=1, CE=8, rcid_bits=RBITS)


def test_cpu_paths_count_no_kernel_pairs():
    import pyskani_tpu_torch
    (_, a), (_, b), (_, q) = _genomes(3, 40_000, 3)
    before = chain_post.launches
    tail_before = chain_tail.launches
    profiling.reset_stats()
    profiling.enable()
    try:
        chain_post(*_small().values(), ChainConfig(), NF=2, CE=8,
                   rcid_bits=RBITS)
        db = pyskani_tpu_torch.Database(device="cpu")
        db.sketch("a", *a)
        db.sketch("b", *b)
        hits = db.query("q", *q)
        snap = profiling.stats().snapshot()
    finally:
        profiling.disable()
        profiling.reset_stats()
    assert len(hits) == 2
    assert snap["counters"]["pairs_chained"] == 2
    assert "post_kernel_pairs" not in snap["counters"]
    assert "post_tail_pairs" not in snap["counters"]
    assert chain_post.launches == before
    assert chain_tail.launches == tail_before


# ---------------------------------------------------------------- tail


def _stack(G, C, S, NF, rng):
    """A stack of G hand-built sketches: 1-C live contigs, NF / 2 to NF
    fragments a genome (the last genome NF to 3 NF), and S / 2 to S seeds
    sorted by (contig, position) with multiplicities 1-30 (past the
    denominator mask's 16 at times)."""
    clens = np.zeros((G, C), np.int64)
    n_contigs = rng.integers(1, C + 1, G)
    for g in range(G):
        # NF / 2 to NF fragments a genome, 1 to 3 NF for the last one
        lo, hi = (NF, 3 * NF) if g == G - 1 else (NF // 2, NF)
        clens[g, :n_contigs[g]] = rng.integers(
            lo * FL // n_contigs[g], hi * FL // n_contigs[g] + 1,
            n_contigs[g])
    n_seeds = rng.integers(S // 2, S + 1, G)
    pos = np.full((G, S), I32_SENTINEL, np.int64)
    cid = np.full((G, S), I32_SENTINEL, np.int64)
    mult = np.zeros((G, S), np.int64)
    for g in range(G):
        c = np.sort(rng.integers(0, n_contigs[g], n_seeds[g]))
        p = rng.integers(0, clens[g, c])
        o = np.lexsort((p, c))
        pos[g, :n_seeds[g]], cid[g, :n_seeds[g]] = p[o], c[o]
        mult[g, :n_seeds[g]] = rng.integers(1, 31, n_seeds[g])
    i32 = lambda x: torch.from_numpy(x.astype(np.int32))
    f = {k: torch.zeros((G, 1), dtype=torch.int64) for k in FIELDS}
    f.update(p_positions=i32(pos), p_contig_ids=i32(cid), p_own_mult=i32(mult),
             kmers=torch.zeros((G, S), dtype=torch.int64),
             n_seeds=i32(n_seeds), contig_lengths=i32(clens),
             n_contigs=i32(n_contigs),
             total_len=torch.from_numpy(clens.sum(1)))
    return DeviceSketch(**f)


def _tables(sk, cfg, denom=True):
    starts, offs = chain_mod._contig_layout(sk, cfg.fragment_length)
    return chain_mod._genome_tables(sk, starts, offs, cfg, denom=denom)


def _stage(P, NF, CE, q_sk, r_sk, tail_q, tail_r, cfg, rng, *, kinds):
    """Hand-built per-chain stage outputs (the dict of KEYS) for P pairs,
    pair p of kind ``kinds[p]``: "empty" (no kept chain), "cov1" /
    "cov2" (1 / 2 covered query fragments, no reference numerators),
    "many" (more kept chains than CE) or "any"."""
    fl = cfg.fragment_length
    _, q_offs = chain_mod._contig_layout(q_sk, fl)
    q_cid = chain_mod._frag_contig(q_offs, NF, q_sk.contig_lengths.shape[1])
    q_offs, q_cid = q_offs.numpy(), q_cid.numpy()
    q_cl = q_sk.contig_lengths.numpy().astype(np.int64)
    r_cl = r_sk.contig_lengths.numpy().astype(np.int64)
    r_nc = r_sk.n_contigs.numpy()
    R = P * NF
    st = dict(numer=np.zeros(R, np.int64), span_lo=np.full(R, POS_BIG),
              span_hi=np.full(R, NEG_BIG), n_chains=np.zeros(P, np.int32),
              row_sel=np.zeros((P, CE), np.int64),
              end_valid=np.zeros((P, CE), bool),
              end_qmn=np.full((P, CE), I32_SENTINEL),
              end_qmx=np.full((P, CE), I32_SENTINEL),
              end_rmn=np.full((P, CE), I32_SENTINEL),
              end_rmx=np.full((P, CE), I32_SENTINEL),
              end_rcid=np.zeros((P, CE), np.int64),
              numer_r=np.zeros((P, NF), np.int64),
              ref_over=rng.random(P) < 0.15)
    for p in range(P):
        kind = kinds[p]
        if kind == "empty":
            st["ref_over"][p] = False
            continue
        gq, gr = tail_q[p], tail_r[p]
        live = min(NF, q_offs[gq, -1])   # the query genome's fragments
        if kind in ("cov1", "cov2"):
            rows = rng.choice(live, int(kind[-1]), replace=False)
        else:
            rows = np.nonzero(rng.random(live) < 0.7)[0]
        # n kept chains in all, at least one in each of ``rows``
        n = max(len(rows), CE + 1 + rng.integers(0, 5)) if kind == "many" \
            else rng.integers(len(rows), 3 * len(rows) + 1)
        sel = np.sort(np.concatenate([rows, rng.choice(rows, n - len(rows))]))
        for f in np.unique(sel):
            r = p * NF + f
            c = q_cid[gq, f]
            base = (f - q_offs[gq, c]) * fl
            # 1-29 anchors a row (26 or more on the covered pairs), about
            # the eligible seeds of a third of a fragment
            lo = 26 if kind in ("cov1", "cov2") else 1
            st["numer"][r] = rng.integers(lo, 30)
            st["span_lo"][r] = base + rng.integers(-fl // 4, fl)
            st["span_hi"][r] = st["span_lo"][r] + rng.integers(0, fl)
        st["n_chains"][p] = n
        for e, f in enumerate(sel[:CE]):
            c = q_cid[gq, f]
            base = (f - q_offs[gq, c]) * fl
            qmn = min(max(0, base + rng.integers(-fl // 4, fl)),
                      q_cl[gq, c] - 1)
            rc = rng.integers(0, r_nc[gr])
            rmn = rng.integers(0, r_cl[gr, rc])
            st["row_sel"][p, e] = f
            st["end_valid"][p, e] = True
            st["end_qmn"][p, e] = qmn
            st["end_qmx"][p, e] = min(qmn + rng.integers(0, fl),
                                      q_cl[gq, c] + 20)
            st["end_rmn"][p, e] = rmn
            st["end_rmx"][p, e] = rmn + rng.integers(0, 5 * fl // 2)
            st["end_rcid"][p, e] = rc
        if cfg.est_side == "both" and kind not in ("cov1", "cov2"):
            st["numer_r"][p] = np.where(rng.random(NF) < 0.6,
                                        rng.integers(1, 40, NF), 0)
    st = {k: torch.from_numpy(np.asarray(v)) for k, v in st.items()}
    st["n_chains"] = st["n_chains"].to(torch.int32)
    return st


def _tail_inputs(P, NF, CE, cfg, *, seed, kinds=None):
    """(stage outputs, tail_r, tail_q, query tables, reference tables,
    (query stack, reference stack)) of P hand-built pairs; the pairs
    take the reference genomes in turn, so the last (past NF) is taken."""
    rng = np.random.default_rng(seed)
    G_q, G_r = 3, 4
    q_sk = _stack(G_q, 3, 300 * NF, NF, rng)
    r_sk = _stack(G_r, 4, 300 * NF, NF, rng)
    tail_q = rng.integers(0, G_q, P)
    tail_r = (np.arange(P) + 1) % G_r
    kinds = kinds or ["any"] * P
    st = _stage(P, NF, CE, q_sk, r_sk, tail_q, tail_r, cfg, rng, kinds=kinds)
    # the large genome's pairs: only the spans can set the flag
    st["ref_over"][torch.from_numpy(tail_r == G_r - 1)] = False
    both = cfg.est_side == "both"
    q = _tables(q_sk, cfg)
    r = _tables(r_sk, cfg, denom=both)
    return (st, torch.from_numpy(tail_r), torch.from_numpy(tail_q), q, r,
            (q_sk, r_sk))


def _tail_oracle(st, tail_r, tail_q, sks, cfg, NF, CE):
    """The tail as a loop over pairs in NumPy, from the raw sketches:
    denominators count the eligible seeds inside each span; the
    quantiles, the median and the fragment ANIs take the plain version's
    f32 operations, the means sum in float64."""
    fl, k = cfg.fragment_length, cfg.k
    f32 = np.float32
    thr = cfg.denom_mask_mult or cfg.max_seed_multiplicity
    st = {k_: v.numpy() for k_, v in st.items()}
    P = len(tail_r)

    def genome(sk, g):
        cl = sk.contig_lengths[g].numpy().astype(np.int64)
        live = np.arange(len(cl)) < int(sk.n_contigs[g])
        starts = np.concatenate([[0], np.cumsum(cl)])
        offs = np.concatenate([[0], np.cumsum(np.where(live, -(-cl // fl),
                                                       0))])
        n = int(sk.n_seeds[g])
        cid = sk.p_contig_ids[g, :n].numpy().astype(np.int64)
        gpos = starts[cid] + sk.p_positions[g, :n].numpy()
        ok = np.ones(n, bool) if cfg.mask_repetitive_denom == "none" else \
            sk.p_own_mult[g, :n].numpy() <= thr
        fcid = np.clip(np.searchsorted(offs, np.arange(NF), "right") - 1,
                       0, len(cl) - 1)
        return dict(cl=cl, starts=starts, offs=offs, gpos=gpos[ok],
                    fcid=fcid, total=int(sk.total_len[g]))

    def fa(numer, lo, hi, gpos):
        denom = int(((gpos >= lo) & (gpos <= hi)).sum())
        ratio = min(f32(numer) / max(f32(denom), f32(1.0)), f32(1.0))
        return f32(ratio) ** f32(1.0 / k)

    def quantile(s, n, q):
        pos = f32(q) * (f32(n) - f32(1.0))
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        w = pos - f32(lo)
        v_lo, v_hi = s[min(max(lo, 0), M - 1)], s[min(max(hi, 0), M - 1)]
        return v_lo * (f32(1.0) - w) + v_hi * w

    def union(iv):
        total, run = 0, NEG_BIG
        for lo, hi in sorted(iv):
            total += max(0, hi - max(lo - 1, run))
            run = max(run, hi)
        return total

    both = cfg.est_side == "both"
    M = 2 * NF if both else NF
    keys = ("ani_mean", "ani_robust", "ani_median", "n_fragments",
            "af_query", "af_ref", "n_chains", "frag_overflow")
    o = {k_: [] for k_ in keys}
    o["ranked"] = np.full((P, M), np.inf, f32)
    q_sk, r_sk = sks
    for p in range(P):
        gq, gr = genome(q_sk, tail_q[p]), genome(r_sk, tail_r[p])
        vals = []
        for f in range(NF):
            n = st["numer"][p * NF + f]
            if n < max(1, cfg.min_frag_anchors):
                continue
            c = gq["fcid"][f]
            base = (f - gq["offs"][c]) * fl
            end = min(base + fl - 1, gq["cl"][c] - 1)
            lo = max(st["span_lo"][p * NF + f], base)
            hi = min(st["span_hi"][p * NF + f], end)
            vals.append(fa(n, gq["starts"][c] + lo, gq["starts"][c] + hi,
                           gq["gpos"]))
        over = bool(st["ref_over"][p])
        ne = min(int(st["n_chains"][p]), CE)
        valid = [e for e in range(ne) if st["end_valid"][p, e]]
        rc = {e: min(max(st["end_rcid"][p, e], 0), len(gr["cl"]) - 1)
              for e in valid}
        if both:
            spans = {}
            for e in valid:
                lo = max(st["end_rmn"][p, e] - cfg.extend_left, 0)
                hi = min(st["end_rmx"][p, e] + cfg.extend_right,
                         gr["cl"][rc[e]] - 1)
                f0 = lo // fl
                for j in range(4):
                    plo = max(lo, (f0 + j) * fl)
                    phi = min(hi, (f0 + j) * fl + fl - 1)
                    fj = gr["offs"][rc[e]] + f0 + j
                    if plo > phi:
                        continue
                    if fj >= NF:
                        over = True
                        continue
                    a, b = spans.get(fj, (I32_SENTINEL, NEG_BIG))
                    spans[fj] = (min(a, plo), max(b, phi))
            for f in range(NF):
                n = st["numer_r"][p, f]
                if n < max(1, cfg.min_frag_anchors):
                    continue
                a, b = spans.get(f, (I32_SENTINEL, NEG_BIG))
                s0 = gr["starts"][gr["fcid"][f]]
                vals.append(fa(n, s0 + a, s0 + b, gr["gpos"]))
        n = len(vals)
        s = np.sort(np.array(vals, f32))
        o["ranked"][p, :n] = s
        s = o["ranked"][p]
        q10, q90 = quantile(s, n, 0.1), quantile(s, n, 0.9)
        win = [v for v in s[:n] if q10 <= v <= q90]
        med = f32(0.5) * (s[min(max((n - 1) // 2, 0), M - 1)] +
                          s[min(max(n // 2, 0), M - 1)])
        o["ani_mean"].append(sum(map(float, vals)) / max(n, 1) if n else 0)
        o["ani_robust"].append(sum(map(float, win)) / max(len(win), 1)
                               if n else 0)
        o["ani_median"].append(med if n else 0)
        o["n_fragments"].append(n)
        q_iv, r_iv = [], []
        for e in valid:
            c = gq["fcid"][st["row_sel"][p, e]]
            q_iv.append((gq["starts"][c] +
                         max(st["end_qmn"][p, e] - cfg.extend_left, 0),
                         gq["starts"][c] +
                         min(st["end_qmx"][p, e] + cfg.extend_right,
                             gq["cl"][c] - 1)))
            r_iv.append((gr["starts"][rc[e]] +
                         max(st["end_rmn"][p, e] - cfg.extend_left, 0),
                         gr["starts"][rc[e]] +
                         min(st["end_rmx"][p, e] + cfg.extend_right,
                             gr["cl"][rc[e]] - 1)))
        o["af_query"].append(f32(union(q_iv)) / max(f32(gq["total"]),
                                                    f32(1.0)))
        o["af_ref"].append(f32(union(r_iv)) / max(f32(gr["total"]),
                                                  f32(1.0)))
        o["n_chains"].append(st["n_chains"][p])
        o["frag_overflow"].append(over)
    return o


TAIL_NF, TAIL_CE = 12, 48
TAIL_KINDS = ["empty", "cov1", "cov2", "many", "any", "any", "any", "any"]
TAIL_CASES = {
    # name: config fields
    "both_own": dict(est_side="both", mask_repetitive_denom="own"),
    "both_none": dict(est_side="both", mask_repetitive_denom="none"),
    "chunk_own": dict(est_side="chunk"),
    "chunk_none": dict(est_side="chunk", mask_repetitive_denom="none"),
    "min_frag_anchors": dict(min_frag_anchors=25),
    "extend_left": dict(extend_left=300, extend_right=40),
    "est_ci": dict(est_ci=True, ci_iterations=30),
    "k21": dict(k=21, denom_mask_mult=0),
}


def _assert_tail_equal(got, want, atol):
    """Integer outputs, flags and aligned fractions equal; the f32
    estimators within ``atol``."""
    for k in ("n_fragments", "n_chains", "frag_overflow", "af_query",
              "af_ref"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("ani_mean", "ani_robust", "ani_median"):
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_tail_plain_matches_oracle(case):
    cfg = ChainConfig(fragment_length=FL, **TAIL_CASES[case])
    st, tail_r, tail_q, q, r, sks = _tail_inputs(
        len(TAIL_KINDS), TAIL_NF, TAIL_CE, cfg,
        seed=sorted(TAIL_CASES).index(case), kinds=TAIL_KINDS)
    got = chain_tail(st, tail_r, tail_q, q, r, cfg, NF=TAIL_NF, CE=TAIL_CE)
    want = _tail_oracle(st, tail_r.numpy(), tail_q.numpy(), sks, cfg,
                        TAIL_NF, TAIL_CE)
    keys = ["ani_mean", "ani_robust", "ani_median", "n_fragments"]
    keys += ["ani_ci_low", "ani_ci_high"] if cfg.est_ci else []
    assert list(got) == keys + ["af_query", "af_ref", "n_chains",
                                "frag_overflow"]
    _assert_tail_equal({k: v.numpy() for k, v in got.items()}, want, 1e-6)
    # each case exercises what it names
    n_cov = got["n_fragments"].numpy()
    assert list(n_cov[:3]) == [0, 1, 2]
    assert got["ani_mean"][0] == 0 and got["af_query"][0] == 0
    assert (got["n_chains"][3] > TAIL_CE) and (n_cov[4:] >= 2).all()
    assert (got["af_query"][1:] > 0).all() and (got["af_ref"][1:] > 0).all()
    if cfg.est_side == "both":
        # reference pieces past the grid set the flag where the stage did not
        assert (got["frag_overflow"] & ~st["ref_over"]).any()
        # the reference fragments add values to the query's
        cov_q = st["numer"].view(-1, TAIL_NF) >= max(1, cfg.min_frag_anchors)
        assert (n_cov[4:] > cov_q[4:].sum(1).numpy()).all()
    else:
        assert torch.equal(got["frag_overflow"], st["ref_over"])
    if cfg.est_ci:
        ranked = torch.from_numpy(want["ranked"])
        ci_lo, ci_hi = chain_mod._bootstrap_ci(ranked, got["n_fragments"],
                                               cfg.ci_iterations)
        for k, v in (("ani_ci_low", ci_lo), ("ani_ci_high", ci_hi)):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)
        assert (got["ani_ci_low"][4:] > 0).all()


def test_tail_fits_limit():
    assert tail_fits(MAX_TAIL // 2, MAX_TAIL, "both")
    assert not tail_fits(MAX_TAIL // 2 + 1, 8, "both")
    assert tail_fits(MAX_TAIL, 8, "chunk")
    assert not tail_fits(MAX_TAIL + 1, 8, "chunk")
    assert not tail_fits(8, MAX_TAIL + 1, "both")
    # every cell's fragment grid (384 to 512) at the default chain budget
    for NF in (384, 512):
        assert tail_fits(NF, 2048, "both")


def _tail_small(cfg=ChainConfig(fragment_length=FL)):
    st, tail_r, tail_q, q, r, _ = _tail_inputs(2, 4, 8, cfg, seed=3)
    return dict(st=st, tail_r=tail_r, tail_q=tail_q, q=q, r=r)


@pytest.mark.parametrize("bad,match", [
    (lambda a: a["st"].update(numer=a["st"]["numer"][:-1]), "numer must be"),
    (lambda a: a["st"].update(n_chains=a["st"]["n_chains"].long()),
     "n_chains must be"),
    (lambda a: a["st"].update(end_valid=a["st"]["end_valid"].long()),
     "end_valid must be"),
    (lambda a: a.update(tail_q=a["tail_q"].int()), "tail_q must be"),
    (lambda a: a.update(q=a["q"]._replace(clens=a["q"].clens.long())),
     "q.clens must be"),
    (lambda a: a.update(r=a["r"]._replace(pref=a["r"].pref[:, :-1])),
     "r.pref must be"),
    (lambda a: a.update(r=a["r"]._replace(pos=None)), "r.pos must be"),
    (lambda a: a.update(q=a["q"]._replace(pos=a["q"].pos.to("meta"))),
     "CUDA device"),
])
def test_tail_wrapper_refuses(bad, match):
    a = _tail_small()
    bad(a)
    with pytest.raises(ValueError, match=match):
        chain_tail(a["st"], a["tail_r"], a["tail_q"], a["q"], a["r"],
                   ChainConfig(fragment_length=FL), NF=4, CE=8)


# ---------------------------------------------------------------- card


def _dp_grid(P, NF, PF, *, seed, dev):
    """Stage inputs as the pipeline makes them: near-diagonal anchor rows
    (breaks every ~30 anchors, either strand, 1-3 ref contigs a row,
    a third of the rows empty, some past PF), packed, and the chain DP's
    scores and roots on ``dev``."""
    rng = np.random.default_rng(seed)
    R = P * NF
    counts = rng.integers(1, PF + PF // 4, R)
    counts[rng.random(R) < 0.33] = 0
    n = np.minimum(counts, PF)
    valid = np.arange(PF)[None, :] < n[:, None]
    rcid = np.cumsum(rng.random((R, PF)) < 0.01, 1) % 3
    rpos = np.cumsum(rng.integers(1, 250, (R, PF)), 1) + \
        rng.integers(0, 7_000_000, (R, 1))
    brk = np.cumsum(rng.random((R, PF)) < 0.03, 1) * 7_919
    rev = rng.integers(0, 2, (R, 1))
    jit = rng.integers(-3, 4, (R, PF))
    base = rng.integers(10_000_000, 20_000_000, (R, 1))
    qpos = np.where(rev == 1, base - rpos, base + rpos) + jit + brk
    w1 = np.where(valid, (qpos << 2) | (rev << 1) | 1, 0)
    w2 = np.where(valid, (rpos << RBITS) | rcid, 0)
    fo = np.zeros((4, CR + 1), np.int64)
    fo[:, 1:] = np.cumsum(rng.integers(10, 30, (4, CR)), 1)
    as_t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    w1g, w2g = as_t(w1), as_t(w2)
    grid = chain_mod._dp_grid_from_words(w1g, w2g, RBITS)
    scores, roots = chain_dp(grid["qpos"], grid["rpos"], grid["meta"],
                             ChainConfig())
    return dict(w1g=w1g, w2g=w2g, scores=scores, roots=roots,
                row_bounds=as_t(np.concatenate([[0], np.cumsum(counts)])),
                tail_r=as_t(rng.integers(0, 4, P)), r_frag_offs=as_t(fo))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("P,NF,PF,fields", [
    (28, 384, 256, {}),
    (325, 384, 256, {}),
    (325, 384, 256, dict(est_side="chunk")),
    (28, 384, 256, dict(min_chain_score=0.0, keep_long_span=0)),
    (16, 384, 512, {}),
    (8, 64, 101, {}),          # odd PF: the kernel's scalar loads
    # two pairs of a large genome: a pair's [NF] numerators do not fit in
    # shared memory beside the bins, so the kernel adds them by global
    # atomics into the pair's own row
    (2, 50_000, 256, {}),
])
def test_cuda_kernel_matches_plain(P, NF, PF, fields):
    _need_card()
    if NF == 50_000:
        props = torch.cuda.get_device_properties(0)
        optin = getattr(props, "shared_memory_per_block_optin", 227 * 1024)
        # the launcher's bins (8 warps x 24 B x PF) and [NF] int32
        # histogram past its room (the opt-in less 1 KB of static memory)
        assert 8 * 24 * PF + 4 * NF > optin - 1024
    g = _dp_grid(P, NF, PF, seed=P + PF, dev="cuda")
    cfg = ChainConfig(**fields)
    for CE in (2048, 7):
        before = chain_post.launches
        got = chain_post(*g.values(), cfg, NF=NF, CE=CE, rcid_bits=RBITS)
        assert chain_post.launches == before + 1
        want = chain_post_plain(g["w1g"], g["w2g"], g["scores"], g["roots"],
                                g["tail_r"], g["r_frag_offs"], cfg, NF=NF,
                                CE=CE, rcid_bits=RBITS)
        torch.cuda.synchronize()
        assert int(want["n_chains"].sum()) > 0
        for k in KEYS:
            assert torch.equal(got[k], want[k]), (k, P, NF, PF, CE)


@pytest.fixture
def plain_on_card(monkeypatch):
    """Route ``ops/chain.py``'s per-chain stage through the plain version
    (on the card's tensors)."""
    def plain(w1g, w2g, scores, roots, row_bounds, tail_r, r_frag_offs,
              cfg, *, NF, CE, rcid_bits):
        return chain_post_plain(w1g, w2g, scores, roots, tail_r,
                                r_frag_offs, cfg, NF=NF, CE=CE,
                                rcid_bits=rcid_bits)
    return lambda: monkeypatch.setattr(chain_mod, "chain_post", plain)


def _genomes(n, length, seed, step=0.005):
    """``n`` genomes of one random root, genome i with 0.2% + ``step`` * i
    substitutions."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, length)
    out = []
    for i in range(n):
        g = base.copy()
        at = rng.integers(0, length, int(length * (0.002 + step * i)))
        g[at] = rng.choice(acgt, at.size)
        out.append((f"g{i}", [g.tobytes()]))
    return out


@pytest.mark.cuda
def test_cuda_triangle_bit_equal(plain_on_card):
    _need_card()
    from pyskani_tpu_torch.database import _chain_cfg_for
    from pyskani_tpu_torch.engine.batch import triangle
    from pyskani_tpu_torch.ops.sketch import sketch_genomes_device
    from pyskani_tpu_torch.params import SketchParams
    params = SketchParams()
    sketches = sketch_genomes_device(_genomes(9, 300_000, 1), params,
                                     device="cuda")
    cfg = _chain_cfg_for(params)
    before = chain_post.launches
    profiling.reset_stats()
    profiling.enable()
    try:
        _, _, got = triangle(sketches, cfg=cfg, group=6)
        counters = profiling.stats().snapshot()["counters"]
    finally:
        profiling.disable()
        profiling.reset_stats()
    # two groups (6 and 3 genomes) and one 6 x 6 cross tile
    assert chain_post.launches == before + 3
    assert counters["post_kernel_pairs"] == 15 + 3 + 36
    plain_on_card()
    _, _, want = triangle(sketches, cfg=cfg, group=6)
    assert chain_post.launches == before + 3
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["ani_mean"] > 0.9).all()


@pytest.mark.cuda
def test_cuda_one_vs_many_bit_equal(plain_on_card):
    _need_card()
    import pyskani_tpu_torch
    genomes = _genomes(6, 300_000, 2)
    db = pyskani_tpu_torch.Database()
    for name, contigs in genomes[1:]:
        db.sketch(name, *contigs)
    query = genomes[0][1][0]
    before = chain_post.launches
    got = db.query("q", query)
    assert chain_post.launches > before
    plain_on_card()
    launched = chain_post.launches
    want = db.query("q", query)
    assert chain_post.launches == launched
    assert len(got) == 5
    fields = lambda h: (h.reference_name, h.identity, h.query_fraction,
                        h.reference_fraction)
    assert [fields(h) for h in got] == [fields(h) for h in want]


def _to(args, dev):
    """The tail's inputs on ``dev``."""
    st, tail_r, tail_q, q, r = args
    move = lambda t: None if t is None else t.to(dev)
    return ({k: v.to(dev) for k, v in st.items()}, tail_r.to(dev),
            tail_q.to(dev), GenomeTables(*map(move, q)),
            GenomeTables(*map(move, r)))


def _kernel_vs_plain(args, cfg, NF, CE):
    """Run the tail kernel and the plain version on the card's ``args``;
    hold them to the acceptance rule (counts, flags and aligned fractions
    bit-equal, the ANI estimators within 1e-6) and return the kernel's."""
    before = chain_tail.launches
    got = chain_tail(*args, cfg, NF=NF, CE=CE)
    assert chain_tail.launches == before + 1
    want = chain_tail_plain(*args, cfg, NF=NF, CE=CE)
    torch.cuda.synchronize()
    assert list(got) == list(want)
    _assert_tail_equal({k: v.cpu() for k, v in got.items()},
                       {k: v.cpu() for k, v in want.items()}, 1e-6)
    if cfg.est_ci:
        for k in ("ani_ci_low", "ani_ci_high"):
            np.testing.assert_allclose(got[k].cpu(), want[k].cpu(), rtol=0,
                                       atol=1e-6, err_msg=k)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TAIL_CASES) + ["wide", "cut_at_5",
                                                     "no_ends", "smem_48k"])
def test_cuda_tail_kernel_matches_plain(case):
    """The hand-built cases, and a wider grid, ends cut at CE 5 and CE 0,
    and NF 2048, CE 2048: exactly 48 KB of dynamic shared memory, which
    with the kernel's static shared memory needs the raised limit."""
    _need_card()
    P, NF, CE, kinds = len(TAIL_KINDS), TAIL_NF, TAIL_CE, TAIL_KINDS
    fields = TAIL_CASES.get(case, {})
    if case == "wide":
        P, NF, CE, kinds = 6, 200, 700, None
    elif case == "cut_at_5":
        CE = 5
    elif case == "no_ends":
        CE, kinds = 0, ["empty"] * P
    elif case == "smem_48k":
        P, NF, CE, kinds = 4, 2048, 2048, None
    cfg = ChainConfig(fragment_length=FL, **fields)
    *args, _ = _tail_inputs(P, NF, CE, cfg, seed=21 + len(case), kinds=kinds)
    got = _kernel_vs_plain(_to(args, "cuda"), cfg, NF, CE)
    assert int(got["n_fragments"].sum()) > 0 or case == "no_ends"


def _record_tail(monkeypatch, calls):
    """Keep the inputs of every ``chain_tail`` call of ``ops/chain.py``."""
    real = chain_mod.chain_tail

    def record(st, tail_r, tail_q, q, r, cfg, *, NF, CE):
        calls.append(((st, tail_r, tail_q, q, r), cfg, NF, CE))
        return real(st, tail_r, tail_q, q, r, cfg, NF=NF, CE=CE)
    monkeypatch.setattr(chain_mod, "chain_tail", record)


# E. coli-sized genomes: 260 fragments of 20 kbp, a 384-fragment grid
CALL_BP, CALL_NF = 5_200_000, 384


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["search", "group"])
def test_cuda_tail_kernel_at_call_shapes(monkeypatch, shape):
    """The inputs of a search call (P 16, NF 384) and of a triangle group
    (P 325), as the chain DP and the per-chain kernel make them, through
    the kernel and the plain version, with and without est_ci."""
    _need_card()
    import dataclasses

    import pyskani_tpu_torch
    from pyskani_tpu_torch.database import _chain_cfg_for
    from pyskani_tpu_torch.engine.batch import triangle
    from pyskani_tpu_torch.ops.sketch import sketch_genomes_device
    from pyskani_tpu_torch.params import SketchParams
    calls = []
    _record_tail(monkeypatch, calls)
    if shape == "search":
        genomes = _genomes(17, CALL_BP, 4, step=0.001)
        db = pyskani_tpu_torch.Database()
        for name, contigs in genomes[1:]:
            db.sketch(name, *contigs)
        assert len(db.query("q", *genomes[0][1])) == 16
        P = 16
    else:
        params = SketchParams()
        sketches = sketch_genomes_device(_genomes(26, CALL_BP, 5, 0.001),
                                         params, device="cuda")
        triangle(sketches, cfg=_chain_cfg_for(params), group=26)
        P = 325
    args, cfg, NF, CE = calls[0]
    assert args[1].shape == (P,) and NF == CALL_NF and CE == 2048
    for est_ci in (False, True):
        got = _kernel_vs_plain(args, dataclasses.replace(cfg, est_ci=est_ci),
                               NF, CE)
        assert (got["ani_mean"] > 0.9).all() and (got["af_query"] > 0.5).all()


@pytest.mark.cuda
def test_cuda_tail_past_limit_takes_plain():
    _need_card()
    NF = MAX_TAIL // 2 + 1
    cfg = ChainConfig(fragment_length=FL)
    *args, _ = _tail_inputs(2, NF, 64, cfg, seed=9)
    args = _to(args, "cuda")
    before = chain_tail.launches
    got = chain_tail(*args, cfg, NF=NF, CE=64)
    assert chain_tail.launches == before
    want = chain_tail_plain(*args, cfg, NF=NF, CE=64)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.fixture
def plain_tail_on_card(monkeypatch):
    """Route ``ops/chain.py``'s per-pair tail through the plain version
    (on the card's tensors)."""
    return lambda: monkeypatch.setattr(chain_mod, "chain_tail",
                                       chain_tail_plain)


@pytest.mark.cuda
def test_cuda_triangle_and_query_through_tail_kernel(plain_tail_on_card):
    """``engine.batch.triangle`` and ``Database.query`` through the tail
    kernel against the plain route on the card."""
    _need_card()
    import pyskani_tpu_torch
    from pyskani_tpu_torch.database import _chain_cfg_for
    from pyskani_tpu_torch.engine.batch import triangle
    from pyskani_tpu_torch.ops.sketch import sketch_genomes_device
    from pyskani_tpu_torch.params import SketchParams
    params = SketchParams()
    genomes = _genomes(9, 300_000, 6)
    sketches = sketch_genomes_device(genomes, params, device="cuda")
    cfg = _chain_cfg_for(params)
    db = pyskani_tpu_torch.Database()
    for name, contigs in genomes[1:]:
        db.sketch(name, *contigs)
    before = chain_tail.launches
    profiling.reset_stats()
    profiling.enable()
    try:
        _, _, got = triangle(sketches, cfg=cfg, group=6)
        hits = db.query("q", *genomes[0][1], learned_ani=False)
        counters = profiling.stats().snapshot()["counters"]
    finally:
        profiling.disable()
        profiling.reset_stats()
    # two groups (6 and 3 genomes), one 6 x 6 cross tile, one search call
    assert chain_tail.launches == before + 4
    assert counters["post_tail_pairs"] == 15 + 3 + 36 + 8
    plain_tail_on_card()
    _, _, want = triangle(sketches, cfg=cfg, group=6)
    plain = db.query("q", *genomes[0][1], learned_ani=False)
    assert chain_tail.launches == before + 4
    _assert_tail_equal(got, want, 1e-6)
    assert set(got) == set(want)
    for k in set(want) - {"ani_mean", "ani_robust", "ani_median"}:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(hits) == len(plain) == 8
    for h, w in zip(hits, plain):
        assert (h.reference_name, h.query_fraction, h.reference_fraction) \
            == (w.reference_name, w.query_fraction, w.reference_fraction)
        assert abs(h.identity - w.identity) <= 1e-6


@pytest.mark.cuda
def test_cuda_chain_post_launches_at_most_40_kernels():
    """Under torch.profiler, the kernels launched inside each ``chain/post``
    span of a search call and a triangle call: the per-chain kernel, the
    tail kernel and the per-genome tables' PyTorch ops."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile

    import pyskani_tpu_torch
    from pyskani_tpu_torch.database import _chain_cfg_for
    from pyskani_tpu_torch.engine.batch import triangle
    from pyskani_tpu_torch.ops.sketch import sketch_genomes_device
    from pyskani_tpu_torch.params import SketchParams
    params = SketchParams()
    genomes = _genomes(9, 200_000, 7)
    sketches = sketch_genomes_device(genomes, params, device="cuda")
    db = pyskani_tpu_torch.Database()
    for name, contigs in genomes[1:]:
        db.sketch(name, *contigs)
    db.query("q", *genomes[0][1])          # warm: builds the kernels
    profiling.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            db.query("q", *genomes[0][1])
            triangle(sketches, cfg=_chain_cfg_for(params), group=6)
            torch.cuda.synchronize()
    finally:
        profiling.disable()
        profiling.reset_stats()
    # the host's events (a range also shows as a device annotation)
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CPU]
    spans = [e.time_range for e in events
             if e.name == "pyskani_tpu_torch/chain/post"]
    launches = [e.time_range.start for e in events
                if e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                              "cuLaunchKernel", "cuLaunchKernelEx")]
    # the search call, two triangle groups and one cross tile
    assert len(spans) == 4
    per_call = [sum(s.start <= t < s.end for t in launches) for s in spans]
    assert min(per_call) >= 2 and max(per_call) <= 40, per_call
