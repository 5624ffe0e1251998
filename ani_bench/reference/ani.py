"""Plain reference of the ANI method that the port serves.

Written from the method (FracMinHash seeds and markers, banded anchor
chaining, fragment ANI and aligned fractions) with the constants of
skani v0.3's defaults as the port states them.  It imports nothing of the port or of the JAX package and
takes nothing the port made: it starts from the genome bytes that the
benchmark handed to both sides.

* Sketching runs in plain PyTorch on any device, so the sketches of a
  sample's genomes take seconds on the card.
* Chaining runs in NumPy on the host.  The chain DP keeps its scores as
  exact integers in tenths (score 10x = 500 per anchor - gap), so ties
  and orderings are those of exact arithmetic; the DP of many pairs runs
  on one grid of fragment rows, one column at a time.
* ``precision`` picks the arithmetic of the estimators: ``"f64"`` is
  the reference; ``"bf16"`` is the control, the same computation with
  the fragment ANIs, their mean and the aligned fractions in bfloat16.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Sequence

import numpy as np
import torch

# skani v0.3 defaults as the port states them
K = 15
MARKER_K = 21
C = 125
MARKER_C = 1000
MIN_CONTIG = 100              # shorter contigs are skipped
FRAGMENT = 20_000
BAND = 25
MAX_GAP = 2_500
ANCHOR10 = 500                # anchor score 50, in tenths
MIN_CHAIN10 = 1_050           # chains scoring below 105 are dropped ...
KEEP_SPAN = 2_500             # ... unless >= 2 anchors span this much query
MAX_MULT = 4                  # k-mers seen more often on a side: no anchor
DENOM_MULT = 16               # own multiplicity above this: not counted

_I64_MIN = -(1 << 63)
_CODE = torch.zeros(256, dtype=torch.int64)
for _b, _v in ((b"Aa", 0), (b"Cc", 1), (b"Gg", 2), (b"Tt", 3)):
    for _ch in _b:
        _CODE[_ch] = _v


# --------------------------------------------------------------- sketch

def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of the 64 bits of an int64 tensor."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def hash64(x: torch.Tensor, bits32: bool = False) -> torch.Tensor:
    """Thomas Wang's invertible 64-bit mix (wrapping arithmetic).
    ``bits32`` computes it on the low 32 bits only: the sketch control."""
    if bits32:
        m = 0xFFFFFFFF
        x = x & m
        x = ((~x) + (x << 21)) & m
        x = x ^ (x >> 24)
        x = ((x + (x << 3)) + (x << 8)) & m
        x = x ^ (x >> 14)
        x = ((x + (x << 2)) + (x << 4)) & m
        x = x ^ (x >> 28)
        return ((x + (x << 31)) & m) << 32
    x = (~x) + (x << 21)
    x = x ^ _lsr(x, 24)
    x = (x + (x << 3)) + (x << 8)
    x = x ^ _lsr(x, 14)
    x = (x + (x << 2)) + (x << 4)
    x = x ^ _lsr(x, 28)
    return x + (x << 31)


def _below(h: torch.Tensor, c: int) -> torch.Tensor:
    """Unsigned ``h < (2^64 - 1) // c`` on int64 bits."""
    key = ((2**64 - 1) // c) ^ (1 << 63)
    key = key - 2**64 if key >= 1 << 63 else key
    return (h ^ _I64_MIN) < key


@dataclasses.dataclass
class RefSketch:
    """One genome's seed table, sorted by (kmer, contig, position), and
    its sorted unique markers, as host arrays."""

    kmers: np.ndarray
    positions: np.ndarray
    contig_ids: np.ndarray
    strands: np.ndarray
    markers: np.ndarray
    contig_lengths: List[int]

    @property
    def total(self) -> int:
        return int(sum(self.contig_lengths))


def _windows(codes: torch.Tensor, k: int):
    """(forward, reverse complement) 2-bit words of every k-window, the
    window at i covering codes[i:i+k]: built from windows of 1, 2, 4, 8
    and 16 bases (each the concatenation of two of half its size), then
    joined by the binary digits of k."""
    n = codes.shape[0] - k + 1
    if n <= 0:
        empty = torch.zeros(0, dtype=torch.int64, device=codes.device)
        return empty, empty
    fw = {1: codes}
    rc = {1: 3 - codes}
    w = 1
    while 2 * w <= k:
        f, r = fw[w], rc[w]
        fw[2 * w] = (f[:-w] << (2 * w)) | f[w:]
        rc[2 * w] = r[:-w] | (r[w:] << (2 * w))
        w *= 2
    fwd = torch.zeros(n, dtype=torch.int64, device=codes.device)
    rev = torch.zeros_like(fwd)
    at = 0
    for w in sorted(fw, reverse=True):
        if k - at >= w:
            fwd = (fwd << (2 * w)) | fw[w][at:at + n]
            rev = rev | (rc[w][at:at + n] << (2 * at))
            at += w
    return fwd, rev


def _by_owner(owner: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Stable order by (owner, key), the input order breaking ties."""
    o = torch.sort(key, stable=True).indices
    return o[torch.sort(owner[o], stable=True).indices]


def sketch_many(genomes: Sequence[Sequence[bytes]], device="cpu", *,
                seeds: bool = True, k: int = K, c: int = C,
                marker_k: int = MARKER_K, marker_c: int = MARKER_C,
                bits32: bool = False) -> List[RefSketch]:
    """Sketch genomes (each a list of contigs) in one pass over their
    concatenated bases.  ``seeds=False`` computes the markers only."""
    dev = torch.device(device)
    kept = [[g for g in contigs if len(g) >= MIN_CONTIG] for contigs in genomes]
    lengths = [len(g) for contigs in kept for g in contigs]
    n_contigs = torch.tensor([len(cs) for cs in kept], device=dev)
    with warnings.catch_warnings():       # read only: nothing writes it
        warnings.simplefilter("ignore", UserWarning)
        raw = torch.frombuffer(b"".join(g for cs in kept for g in cs) or
                               b"A", dtype=torch.uint8)[:sum(lengths)]
    codes = _CODE.to(dev)[raw.to(dev).long()]
    clen = torch.tensor(lengths, dtype=torch.int64, device=dev)
    starts = torch.cumsum(clen, 0) - clen
    cid = torch.repeat_interleave(torch.arange(len(lengths), device=dev), clen)
    genome_of = torch.repeat_interleave(torch.arange(len(kept), device=dev),
                                        n_contigs)
    first_contig = torch.cumsum(n_contigs, 0) - n_contigs

    def valid_windows(kk):
        fwd, rev = _windows(codes, kk)
        end = torch.arange(kk - 1, codes.shape[0], device=dev)
        ok = cid[end - (kk - 1)] == cid[end]
        return fwd, rev, end, ok

    def split(owner, *cols):
        counts = torch.bincount(owner, minlength=len(kept)).tolist()
        return [list(parts) for parts in zip(*(
            torch.split(col, counts) for col in cols))] if cols else []

    fwd, rev, end, ok = valid_windows(marker_k)
    canon = torch.minimum(fwd, rev)
    keep = torch.nonzero(ok & _below(hash64(canon, bits32), marker_c)).flatten()
    m_owner = genome_of[cid[end[keep]]]
    m = canon[keep]
    o = _by_owner(m_owner, m)
    m, m_owner = m[o], m_owner[o]
    new = torch.ones_like(m, dtype=torch.bool)
    new[1:] = (m[1:] != m[:-1]) | (m_owner[1:] != m_owner[:-1])
    markers = split(m_owner[new], m[new])
    del fwd, rev, canon, keep, m, m_owner, o, new
    out = []
    if not seeds:
        empty = np.zeros(0, np.int64)
        for g, (mk,) in enumerate(markers):
            out.append(RefSketch(empty, empty, empty, np.zeros(0, bool),
                                 mk.cpu().numpy(),
                                 [len(x) for x in kept[g]]))
        return out
    fwd, rev, end, ok = valid_windows(k)
    fw = fwd < rev
    canon = torch.where(fw, fwd, rev)
    idx = torch.nonzero(ok & _below(hash64(canon, bits32), c)).flatten()
    e = end[idx]
    ci = cid[e]
    owner = genome_of[ci]
    # the windows are in (genome, contig, position) order already
    o = _by_owner(owner, canon[idx])
    idx, e, ci, owner = idx[o], e[o], ci[o], owner[o]
    parts = split(owner, canon[idx], e - starts[ci],
                  ci - first_contig[owner], fw[idx])
    for g, ((km, pos, cc, st), (mk,)) in enumerate(zip(parts, markers)):
        out.append(RefSketch(km.cpu().numpy(), pos.cpu().numpy(),
                             cc.cpu().numpy(), st.cpu().numpy(),
                             mk.cpu().numpy(), [len(x) for x in kept[g]]))
    return out


# ---------------------------------------------------------------- chain

def _frag_offsets(lengths: Sequence[int]) -> np.ndarray:
    counts = [max(1, -(-L // FRAGMENT)) for L in lengths]
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def _anchors(ref: RefSketch, query: RefSketch) -> dict:
    """Every pair of occurrences of a k-mer shared by the two seed
    tables, for k-mers seen at most MAX_MULT times on each side."""
    qu, qs, qc = np.unique(query.kmers, return_index=True, return_counts=True)
    ru, rs, rc = np.unique(ref.kmers, return_index=True, return_counts=True)
    _, qi, ri = np.intersect1d(qu, ru, assume_unique=True,
                               return_indices=True)
    qs, qc, rs, rc = qs[qi], qc[qi], rs[ri], rc[ri]
    ok = (qc <= MAX_MULT) & (rc <= MAX_MULT)
    qs, qc, rs, rc = qs[ok], qc[ok], rs[ok], rc[ok]
    rep = qc * rc
    n = int(rep.sum())
    kidx = np.repeat(np.arange(len(rep)), rep)
    j = np.arange(n) - np.repeat(np.cumsum(rep) - rep, rep)
    q_idx = qs[kidx] + j // rc[kidx]
    r_idx = rs[kidx] + j % rc[kidx]
    qpos = query.positions[q_idx].astype(np.int64)
    qcid = query.contig_ids[q_idx].astype(np.int64)
    rpos = ref.positions[r_idx].astype(np.int64)
    rcid = ref.contig_ids[r_idx].astype(np.int64)
    rev = query.strands[q_idx] != ref.strands[r_idx]
    frag = _frag_offsets(query.contig_lengths)[qcid] + qpos // FRAGMENT
    order = np.lexsort((qpos, qcid, rpos, rcid, frag))
    return dict(qpos=qpos[order], qcid=qcid[order], rpos=rpos[order],
                rcid=rcid[order], rev=rev[order], frag=frag[order])


def chain_dp(groups: np.ndarray, a: dict):
    """Banded chain DP over anchors sorted by group (a pair's query
    fragment), then (ref contig, ref position, query contig, query
    position).  Each anchor looks back at the BAND anchors before it in
    its group; the best predecessor (nearest on a tie) must strictly
    beat the lone-anchor score.  Returns (score x10, parent) per anchor,
    the parent as a global index or -1."""
    n = len(groups)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    starts = np.concatenate([[0], np.nonzero(np.diff(groups))[0] + 1])
    counts = np.diff(np.concatenate([starts, [n]]))
    row_of = np.repeat(np.arange(len(starts)), counts)
    col = np.arange(n) - starts[row_of]
    # longest rows first, so the rows alive at column i are a prefix
    rank = np.empty(len(starts), np.int64)
    by_len = np.argsort(-counts, kind="stable")
    rank[by_len] = np.arange(len(starts))
    G, L = len(starts), int(counts.max())
    alive = counts[by_len]

    def grid(v, fill=0):
        out = np.full((G, L), fill, dtype=v.dtype)
        out[rank[row_of], col] = v
        return out

    qp, rp, qc, rc = (grid(a[key]) for key in ("qpos", "rpos", "qcid", "rcid"))
    rev = grid(a["rev"], False)
    score = np.full((G, L), ANCHOR10, np.int64)
    parent = np.full((G, L), -1, np.int64)
    neg = np.iinfo(np.int64).min // 4
    for i in range(1, L):
        g = int(np.searchsorted(-alive, -i, side="left"))   # rows with > i
        if g == 0:
            break
        D = min(BAND, i)
        js = slice(i - D, i)
        # look-back columns, nearest first
        qj, rj = qp[:g, js][:, ::-1], rp[:g, js][:, ::-1]
        same = (rc[:g, js][:, ::-1] == rc[:g, i:i + 1]) & \
            (qc[:g, js][:, ::-1] == qc[:g, i:i + 1]) & \
            (rev[:g, js][:, ::-1] == rev[:g, i:i + 1])
        dr = rp[:g, i:i + 1] - rj
        dq = np.where(rev[:g, i:i + 1], qj - qp[:g, i:i + 1],
                      qp[:g, i:i + 1] - qj)
        gap = np.abs(dr - dq)
        ok = same & (dr > 0) & (dq > 0) & (gap < MAX_GAP)
        cand = np.where(ok, score[:g, js][:, ::-1] + ANCHOR10 - gap, neg)
        best = cand.argmax(1)
        top = cand[np.arange(g), best]
        win = top > ANCHOR10
        score[:g, i] = np.where(win, top, ANCHOR10)
        parent[:g, i] = np.where(win, i - 1 - best, -1)
    flat_row = rank[row_of]
    s = score[flat_row, col]
    p = parent[flat_row, col]
    return s, np.where(p >= 0, starts[row_of] + p, -1)


def _roots(parent: np.ndarray) -> np.ndarray:
    root = np.where(parent >= 0, parent, np.arange(len(parent)))
    while True:
        nxt = root[root]
        if np.array_equal(nxt, root):
            return root
        root = nxt


def _seg(values, seg, n, fn, init):
    out = np.full(n, init, dtype=values.dtype)
    fn.at(out, seg, values)
    return out


def _union_length(cid, lo, hi) -> int:
    """Bases covered by the union of inclusive intervals per contig."""
    if len(lo) == 0:
        return 0
    order = np.lexsort((lo, cid))
    cid, lo, hi = cid[order], lo[order], hi[order]
    key_hi = np.maximum.accumulate(cid * (1 << 40) + hi)
    prev = np.concatenate([[-1], key_hi[:-1]])
    start = (cid * (1 << 40) + lo) > prev
    seg = np.cumsum(start) - 1
    n = int(seg[-1]) + 1
    return int((_seg(hi, seg, n, np.maximum, np.iinfo(np.int64).min) -
                _seg(lo, seg, n, np.minimum, np.iinfo(np.int64).max) + 1).sum())


def _denominator_keys(side: RefSketch) -> np.ndarray:
    """Sorted (contig, position) keys of the side's seeds whose own
    multiplicity is at most DENOM_MULT."""
    _, inv, cnt = np.unique(side.kmers, return_inverse=True,
                            return_counts=True)
    ok = cnt[inv] <= DENOM_MULT
    return np.sort(side.contig_ids[ok].astype(np.int64) * (1 << 32) +
                   side.positions[ok].astype(np.int64))


def _grid_estimates(side: RefSketch, pos, cid, kept_anchor, c_cid, c_lo,
                    c_hi, own_fragment: bool):
    """Fragment ANIs on one genome's fragment grid: kept anchors per
    fragment over the seeds inside the fragment's span of kept chains.
    With ``own_fragment`` (the query's grid, whose fragments group the
    chains) a chain's interval is cut to its own fragment, as the JAX
    package's engine, the port's specification, cuts it (its NumPy
    oracle lets the interval spill into the next fragment instead);
    otherwise it is split over every fragment it crosses."""
    offs = _frag_offsets(side.contig_lengths)
    nf = int(offs[-1])
    frag = offs[cid] + pos // FRAGMENT
    numer = np.bincount(frag[kept_anchor], minlength=nf)
    lengths = np.asarray(side.contig_lengths, np.int64)
    lo = np.maximum(c_lo, 0)
    hi = np.minimum(c_hi, lengths[c_cid] - 1)
    if own_fragment:
        hi = np.minimum(hi, (lo // FRAGMENT + 1) * FRAGMENT - 1)
    f0 = offs[c_cid] + lo // FRAGMENT
    f1 = offs[c_cid] + hi // FRAGMENT
    reps = f1 - f0 + 1
    f = np.repeat(f0, reps) + np.arange(reps.sum()) - np.repeat(
        np.cumsum(reps) - reps, reps)
    pc = np.repeat(c_cid, reps)
    base = (f - offs[pc]) * FRAGMENT
    plo = np.maximum(np.repeat(lo, reps), base)
    phi = np.minimum(np.repeat(hi, reps), base + FRAGMENT - 1)
    span_lo = _seg(plo, f, nf, np.minimum, np.iinfo(np.int64).max)
    span_hi = _seg(phi, f, nf, np.maximum, -1)
    frag_cid = np.repeat(np.arange(len(lengths)), np.diff(offs))
    keys = _denominator_keys(side)
    has = span_hi >= 0
    denom = np.zeros(nf, np.int64)
    denom[has] = np.searchsorted(keys, frag_cid[has] * (1 << 32) +
                                 span_hi[has], side="right") - \
        np.searchsorted(keys, frag_cid[has] * (1 << 32) + span_lo[has],
                        side="left")
    cov = numer >= 1
    return np.minimum(numer[cov] / np.maximum(denom[cov], 1), 1.0)


def _finish(ref, query, a, score, root, k: int, precision: str) -> dict:
    n = len(score)
    res = dict(ani=0.0, af_query=0.0, af_ref=0.0, n_anchors=n)
    if n == 0:
        return res
    uniq, chain = np.unique(root, return_inverse=True)
    nc = len(uniq)
    big, small = np.iinfo(np.int64).max, np.iinfo(np.int64).min
    count = np.bincount(chain, minlength=nc)
    qmin = _seg(a["qpos"], chain, nc, np.minimum, big)
    qmax = _seg(a["qpos"], chain, nc, np.maximum, small)
    rmin = _seg(a["rpos"], chain, nc, np.minimum, big)
    rmax = _seg(a["rpos"], chain, nc, np.maximum, small)
    best = _seg(score, chain, nc, np.maximum, small)
    first = np.zeros(nc, np.int64)
    first[chain[::-1]] = np.arange(n - 1, -1, -1)
    c_qcid, c_rcid = a["qcid"][first], a["rcid"][first]
    keep = (best >= MIN_CHAIN10) | ((count >= 2) & (qmax - qmin >= KEEP_SPAN))
    if not keep.any():
        return res
    ext = k - 1
    kept_anchor = keep[chain]
    ratios = np.concatenate([
        _grid_estimates(query, a["qpos"], a["qcid"], kept_anchor,
                        c_qcid[keep], qmin[keep], qmax[keep] + ext, True),
        _grid_estimates(ref, a["rpos"], a["rcid"], kept_anchor,
                        c_rcid[keep], rmin[keep], rmax[keep] + ext, False)])
    q_union = _union_length(c_qcid[keep], np.maximum(qmin[keep], 0),
                            np.minimum(qmax[keep] + ext,
                                       np.asarray(query.contig_lengths)[
                                           c_qcid[keep]] - 1))
    r_union = _union_length(c_rcid[keep], np.maximum(rmin[keep], 0),
                            np.minimum(rmax[keep] + ext,
                                       np.asarray(ref.contig_lengths)[
                                           c_rcid[keep]] - 1))
    if precision == "bf16":
        bf = torch.bfloat16
        fa = torch.tensor(ratios, dtype=bf) ** torch.tensor(1.0 / k, dtype=bf)
        res["ani"] = float(fa.mean()) if len(ratios) else 0.0
        res["af_query"] = float(torch.tensor(q_union, dtype=bf) /
                                torch.tensor(query.total, dtype=bf))
        res["af_ref"] = float(torch.tensor(r_union, dtype=bf) /
                              torch.tensor(ref.total, dtype=bf))
        return res
    res["ani"] = float((ratios ** (1.0 / k)).mean()) if len(ratios) else 0.0
    # the outputs are f32, as skani's: one rounding of the exact ratio
    res["af_query"] = float(np.float32(q_union) / np.float32(query.total))
    res["af_ref"] = float(np.float32(r_union) / np.float32(ref.total))
    return res


def chain_pairs(pairs: Sequence[tuple], k: int = K,
                precision: str = "f64") -> List[dict]:
    """ANI, aligned fractions and anchor count of each (ref, query) pair
    of RefSketches, the query's fragments carrying the chains."""
    anchors = [_anchors(r, q) for r, q in pairs]
    sizes = [len(a["qpos"]) for a in anchors]
    frag_base = np.cumsum([0] + [int(_frag_offsets(q.contig_lengths)[-1])
                                 for _, q in pairs])
    merged = {key: np.concatenate([a[key] for a in anchors])
              for key in ("qpos", "rpos", "qcid", "rcid", "rev")}
    groups = np.concatenate([a["frag"] + frag_base[i]
                             for i, a in enumerate(anchors)])
    score, parent = chain_dp(groups, merged)
    root = _roots(parent)
    out, lo = [], 0
    for (r, q), a, n in zip(pairs, anchors, sizes):
        out.append(_finish(r, q, a, score[lo:lo + n], root[lo:lo + n] - lo,
                           k, precision))
        lo += n
    return out

