"""FracMinHash sketching on PyTorch tensors.

Port of the JAX package's ``ops/sketch.py`` (``sketch_kernel``, the
budget helpers, ``sketch_genome_device``, ``sketch_genomes_device``).
The semantics are the same:
all contigs of a genome are concatenated into one buffer, every position
gets its canonical seed window (k) and marker window (marker_k), both are
hashed with Wang's 64-bit mix and kept below ``(2^64-1)//c``, survivors
are compacted into the seed and marker budgets, and the seed table is
sorted by (kmer, contig, position) beside a (contig, position) view.

Where the JAX code bent around the TPU, this port takes the GPU-natural
form and stays bit-equal on every output:

* the bases are encoded to 2-bit codes on the device
  (``encode_pack``), so the host only copies the bytes;
* 64-bit values ride int64 tensors (multiply, add and ``<<`` wrap mod
  2^64 with the same bits; ``>>`` is masked to a logical shift), so the
  u32-pair emulation of the 64-bit hash is not needed;
* compaction is ``nonzero`` (ascending indices) instead of a blocked
  index sort, and each position finds its contig by a binary search of
  the starts table instead of a scatter-max and running-max fill;
* the survivors are already in (contig, position) order, so the
  kmer-sorted table is ONE stable sort by kmer, and the position-sorted
  view is the compacted table itself;
* a stack of genomes (``sketch_genomes_device``; JAX vmaps the kernel)
  is one [B, L] pass: one ``nonzero`` over the stack with per-row ranks
  for the budgets, and sort keys led by the genome index;
* genomes above ``GIANT_SKETCH_BUFFER`` are sketched in chunked calls
  whose tables are merged on the device (the JAX package merges them in
  numpy on the host).

Every 4 <= k, marker_k <= 32 is supported, as in the JAX package.  The
defaults (k=15, marker_k=21) take a fused path whose windows share their
doubling steps (:func:`_rolling_windows`); any other pair builds each
window by log-doubling (:func:`_windows_generic`).  Windows of up to 64
bits ride int64, so their unsigned order is taken with the sign bit
flipped (:func:`_ult`).

With profiling on (``utils/profiling.py``), a kernel call's host packing
is the span ``sketch/pack``, its copies to the device ``sketch/copy``,
the kernel ``sketch/kernel`` and the counts read back ``sketch/counts``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from ..params import MIN_LENGTH_CONTIG, SketchParams
from ..utils import profiling

U32_SENTINEL = 0xFFFFFFFF
U32_MAX = (1 << 32) - 1
I32_SENTINEL = 0x7FFFFFFF
I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)


@dataclasses.dataclass
class DeviceSketch:
    """Padded dense-tensor sketch of one genome, or a stack of them with a
    leading axis.  Field for field the JAX package's ``DeviceSketch``;
    its uint32 fields (``kmers``, ``markers_hi``, ``markers_lo``,
    ``total_len``) ride int64 here, since PyTorch lacks arithmetic and
    comparisons on uint32."""

    # seed table, sorted by (kmer, contig, position); padding = sentinels
    kmers: torch.Tensor        # int64 [S] (u32 values)
    positions: torch.Tensor    # int32 [S] (end index of k-mer within contig)
    contig_ids: torch.Tensor   # int32 [S]
    strands: torch.Tensor      # bool  [S] (canonical == forward)
    own_mult: torch.Tensor     # int32 [S] (occurrences of this k-mer here)
    # position-sorted view of the same table
    p_positions: torch.Tensor  # int32 [S]
    p_contig_ids: torch.Tensor # int32 [S]
    p_own_mult: torch.Tensor   # int32 [S]
    # marker sketch: sorted unique canonical k-mers (up to 64 bits) as
    # (hi, lo), in unsigned order
    markers_hi: torch.Tensor   # int64 [M] (u32 values)
    markers_lo: torch.Tensor   # int64 [M] (u32 values)
    n_seeds: torch.Tensor      # int32 []
    n_markers: torch.Tensor    # int32 []
    contig_lengths: torch.Tensor  # int32 [C]
    n_contigs: torch.Tensor    # int32 []
    total_len: torch.Tensor    # int64 [] (u32 value)

    @property
    def seed_budget(self) -> int:
        return self.kmers.shape[-1]

    @property
    def marker_budget(self) -> int:
        return self.markers_hi.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.kmers.device

    def map(self, fn) -> "DeviceSketch":
        """Apply ``fn`` to every field tensor."""
        return DeviceSketch(**{f.name: fn(getattr(self, f.name))
                               for f in dataclasses.fields(self)})


FIELDS = tuple(f.name for f in dataclasses.fields(DeviceSketch))


def _rolling_windows(codes: torch.Tensor):
    """All rolling windows the scan needs, by log-doubling (int64 lanes),
    along the last axis of ``codes`` ([L] or [B, L]).

    Returns (fwd15, rev15, marker_fwd, marker_rev) where entry i covers the
    window ending at position i.  Forward k-mers pack the newest base in
    the low bits; reverse complements pack the newest base's complement in
    the high bits.  Every intermediate stays below 2^32 except the 42-bit
    markers, so int64 needs no masks.  The window at the start of the
    buffer wraps (``torch.roll``), as ``jnp.roll`` does; callers mask it
    with ``pos_in_contig >= k-1``.
    """
    def roll(x, s):
        return torch.roll(x, s, -1)

    # intermediates are dropped as soon as they are used: a genome-length
    # int64 array is 8 bytes per base
    c = codes.to(torch.int64)
    r1 = 3 - c
    f2 = (roll(c, 1) << 2) | c
    del c
    f4 = (roll(f2, 2) << 4) | f2
    del f2
    f8 = (roll(f4, 4) << 8) | f4
    del f4
    f16 = (roll(f8, 8) << 16) | f8
    fwd15 = f16 & 0x3FFFFFFF
    f5 = f8 & 0x3FF                       # newest 5 bases
    del f8
    m_f = (roll(f5, 16) << 32) | f16      # 42-bit forward marker k-mer
    del f5, f16

    r2 = (r1 << 2) | roll(r1, 1)
    del r1
    r4 = (r2 << 4) | roll(r2, 2)
    del r2
    r8 = (r4 << 8) | roll(r4, 4)
    del r4
    r16 = (r8 << 16) | roll(r8, 8)
    rev15 = r16 >> 2
    r5 = r8 >> 6                          # newest 5 complements (top)
    del r8
    m_r = (r5 << 32) | roll(r16, 5)       # 42-bit reverse marker k-mer
    return fwd15, rev15, m_f, m_r


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def mm_hash64(key: torch.Tensor) -> torch.Tensor:
    """Thomas Wang's 64-bit invertible hash on int64 lanes (u64 bits).

    Same bits as the JAX package's u32-pair ``u64.mm_hash64``: int64
    add and ``<<`` wrap mod 2^64; right shifts are made logical."""
    key = (~key) + (key << 21)
    key = key ^ _shr(key, 24)
    key = (key + (key << 3)) + (key << 8)
    key = key ^ _shr(key, 14)
    key = (key + (key << 2)) + (key << 4)
    key = key ^ _shr(key, 28)
    key = key + (key << 31)
    return key


def _below(h: torch.Tensor, thr: int) -> torch.Tensor:
    """Unsigned ``h < thr`` for u64 bits in int64, ``0 < thr < 2^64``
    (``thr = 2^64 - 1`` at c = 1)."""
    if thr <= I64_MAX:
        return (h >= 0) & (h < thr)
    return (h ^ I64_MIN) < thr + I64_MIN


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned ``a < b`` for u64 bits in int64: the sign bit flipped
    makes the signed order the unsigned one."""
    return (a ^ I64_MIN) < (b ^ I64_MIN)


def _windows_generic(codes: torch.Tensor, k: int):
    """(fwd, rev) k-mer windows ending at each position for any k <= 32,
    on int64 lanes (u64 bits), along the last axis of ``codes``.

    The JAX package's ``_windows_generic`` with its bit layout: forward
    packs the newest base in the low bits, reverse packs its complement
    in the high bits.  Power-of-two windows are built by doubling
    (w_2n[i] joins w_n[i] and w_n[i-n]), and only those in the binary
    decomposition of k are joined into the result, smallest first (each
    older chunk goes above the forward window and below the reverse one,
    so the order does not change the bits).  Each power is dropped once
    the next is built; ``<<`` wraps mod 2^64 as u64 does."""
    assert 1 <= k <= 32

    def roll(x, s):
        return torch.roll(x, s, -1)

    c = codes.to(torch.int64)
    f, r = c, 3 - c
    del c
    acc_f = acc_r = None
    width, n = 0, 1
    while True:
        if k & n:
            if acc_f is None:
                acc_f, acc_r = f, r
            else:
                acc_f = (roll(f, width) << 2 * width) | acc_f
                acc_r = (acc_r << 2 * n) | roll(r, width)
            width += n
        if 2 * n > k:
            break
        f = (roll(f, n) << 2 * n) | f
        r = (r << 2 * n) | roll(r, n)
        n *= 2
    assert width == k
    return acc_f, acc_r


def _seed_and_marker_windows(codes: torch.Tensor, k: int, marker_k: int):
    """(strand, seed key, seed hash, canonical marker) at every position
    for the generic path, as the JAX ``sketch_kernel``'s generic branch:
    the seed key is the canonical k-mer for 2k <= 32, else the hash's low
    word with 0xFFFFFFFF remapped to 0xFFFFFFFE (the padding sentinel
    stays unambiguous); ``marker_k == k`` reuses the seed's canonical
    k-mer."""
    f, r = _windows_generic(codes, k)
    strand = _ult(f, r)
    canon = torch.where(strand, f, r)
    del f, r
    h = mm_hash64(canon)
    if marker_k == k:
        mcanon = canon
    else:
        mf, mr = _windows_generic(codes, marker_k)
        mcanon = torch.where(_ult(mf, mr), mf, mr)
        del mf, mr
    if 2 * k > 32:
        lo = h & U32_MAX
        canon = torch.where(lo == U32_SENTINEL, U32_SENTINEL - 1, lo)
    return strand, canon, h, mcanon


def _unique_markers(b: torch.Tensor, marker: torch.Tensor, marker_k: int):
    """Sorted unique (genome, marker) pairs of the survivors, in the JAX
    package's unsigned (hi, lo) order per genome.  Returns (genome ids,
    hi words, lo words).

    Markers of at most 42 bits (marker_k <= 21, the default path) take
    one ``unique`` of ``b << 42 | marker``, as before generic k; wider
    ones take two chained stable sorts (by the sign-flipped marker, then
    by genome) and a run-start mask.  Both give the same bits where both
    apply."""
    if marker_k <= 21:
        key = torch.unique((b << 42) | marker)
        marker = key & ((1 << 42) - 1)
        return key >> 42, marker >> 32, marker & 0xFFFFFFFF
    flipped = marker ^ I64_MIN
    order = torch.sort(flipped, stable=True).indices
    order = order[torch.sort(b[order], stable=True).indices]
    b, flipped = b[order], flipped[order]
    first = torch.ones_like(b, dtype=torch.bool)
    first[1:] = (b[1:] != b[:-1]) | (flipped[1:] != flipped[:-1])
    marker = flipped[first] ^ I64_MIN
    return b[first], _shr(marker, 32), marker & U32_MAX


def _row_ranks(b: torch.Tensor, B: int) -> torch.Tensor:
    """Rank of every entry inside its row, for ascending row ids ``b``."""
    cnt = torch.bincount(b, minlength=B)
    return torch.arange(b.shape[0], device=b.device) - \
        (torch.cumsum(cnt, 0) - cnt)[b]


def _scatter_rows(b, rank, vals, B: int, budget: int, fill):
    """[B, budget] table holding ``vals`` at (b, rank), ``fill`` elsewhere."""
    out = torch.full((B, budget), fill, dtype=vals.dtype, device=vals.device)
    out[b, rank] = vals
    return out


def encode_pack(raw: torch.Tensor) -> torch.Tensor:
    """ASCII bytes (uint8 [..., L]) -> 2-bit codes packed 4 per byte,
    oldest base in bits 1:0 ([..., L//4]), on ``raw``'s device: A=0,
    C=1, G=2, T=3 in either case, every other byte (N included) 0, as
    skani's BYTE_TO_SEQ table and the JAX package's ``encode_pack_host``.
    L must be a multiple of 4 (length buckets are).  Encoding on the card
    keeps the host to one copy of the bytes."""
    up = raw & 0xDF                 # upper case: only c, g, t reach C, G, T
    codes = (up == ord("T")).to(torch.uint8) * 3
    codes = torch.where(up == ord("G"), 2, codes)
    codes = torch.where(up == ord("C"), 1, codes)
    q = codes.view(raw.shape[:-1] + (-1, 4))
    return q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) | (q[..., 3] << 6)


_COUNTS = ("n_seeds", "n_markers", "n_seeds_want", "n_markers_want")
# the genome index rides bit 40 and up of the flat starts-table keys
_ROW_SHIFT = 40


def sketch_kernel_batch(packed_codes: torch.Tensor,
                        contig_starts: torch.Tensor, n_contigs,
                        valid_floor: torch.Tensor | None = None, *,
                        k: int, marker_k: int, c: int, marker_c: int,
                        seed_budget: int, marker_budget: int) -> dict:
    """All-positions FracMinHash scan + compaction for a stack of B genomes
    in one pass (the JAX package vmaps ``sketch_kernel``).

    ``packed_codes`` is uint8 [B, L//4] (:func:`encode_pack`, oldest base
    in bits 1:0); ``contig_starts`` int32 [B, C+1] holds the global start
    of each contig with ``contig_starts[b, n_contigs[b]]`` the genome's
    total length; ``n_contigs`` is [B].  ``valid_floor`` (int32 [B, C+1],
    optional) is a global window-end floor per contig: the chunked
    giant-genome path feeds continuation pieces of a split contig with a
    K-1 overlap and masks the overlap's window ends with it.

    Row b equals the JAX ``sketch_kernel`` on genome b with these budgets:
    the union of seed and marker survivors is clipped per row to the
    summed budgets, then seeds and markers to their own (one ``nonzero``
    over the stack and per-row ranks).  The seed table is one stable sort
    by ``b<<32 | kmer``, the markers deduped per genome in unsigned
    (hi, lo) order (:func:`_unique_markers`).  Returns a dict of [B, ...]
    tensors (int64 for u32 values) with the JAX keys; the four counts are
    int64 [B].
    """
    if not (4 <= k <= 32 and 4 <= marker_k <= 32):
        raise ValueError(f"k={k} / marker_k={marker_k} outside the "
                         f"supported [4, 32] range")
    dev = packed_codes.device
    i64 = torch.int64
    thr = (2**64 - 1) // c
    mthr = (2**64 - 1) // marker_c
    B, L = packed_codes.shape[0], packed_codes.shape[1] * 4
    C = contig_starts.shape[1] - 1
    ncon = torch.as_tensor(n_contigs, device=dev).to(i64).reshape(B)

    shifts = torch.arange(4, device=dev, dtype=torch.uint8) * 2
    codes = ((packed_codes[:, :, None] >> shifts) & 3).reshape(B, L)

    # in-contig position: i - (global start of my contig).  The JAX
    # package fills it with a scatter-max of the starts and a running
    # max; one binary search of the starts tables, flattened as
    # b<<40 | start (slots past a genome's last contig pushed out of
    # reach), gives the same start for every position
    starts64 = contig_starts.to(i64)
    rows = torch.arange(B, device=dev, dtype=i64)[:, None]
    slot = torch.arange(C + 1, device=dev)[None, :]
    far = (1 << _ROW_SHIFT) - 1
    tab = ((rows << _ROW_SHIFT) +
           torch.where(slot <= ncon[:, None], starts64, far)).reshape(-1)
    ii = torch.arange(L, device=dev, dtype=i64)[None, :]
    key = (rows << _ROW_SHIFT) + ii
    at = (torch.searchsorted(tab, key.reshape(-1), right=True) - 1).view(B, L)
    pos_in_contig = key - tab[at]
    del key
    total = starts64.gather(1, ncon.clamp(0, C)[:, None])
    in_seq = ii < total
    if valid_floor is not None:
        # the floors increase with the contig (floor < next start), so the
        # contig found above also picks the floor
        in_seq &= ii >= valid_floor.to(i64).reshape(-1)[at]
    del at

    if k == 15 and marker_k == 21:
        # the fused path: every window below 2^42, signed order is right
        fwd, rev, mfwd, mrev = _rolling_windows(codes)
        del codes
        strand = fwd < rev
        canon = torch.where(strand, fwd, rev)
        del fwd, rev
        h = mm_hash64(canon)
        mcanon = torch.minimum(mfwd, mrev)
        del mfwd, mrev
    else:
        strand, canon, h, mcanon = _seed_and_marker_windows(codes, k,
                                                            marker_k)
        del codes
    seed_mask = in_seq & (pos_in_contig >= k - 1) & _below(h, thr)
    del h
    mh = mm_hash64(mcanon)
    marker_mask = in_seq & (pos_in_contig >= marker_k - 1) & _below(mh, mthr)
    del mh, pos_in_contig, in_seq

    # ---- union compaction (clipped per row to the summed budgets) ----
    u_src = torch.nonzero((seed_mask | marker_mask).reshape(-1)).flatten()
    u_b = u_src // L
    keep = _row_ranks(u_b, B) < seed_budget + marker_budget
    u_src, u_b = u_src[keep], u_b[keep]
    u_seed = seed_mask.reshape(-1)[u_src]
    u_marker = marker_mask.reshape(-1)[u_src]
    # survivor contig id: count of table starts <= position, minus one
    u_key = (u_b << _ROW_SHIFT) + (u_src - u_b * L)
    u_at = torch.searchsorted(tab, u_key, right=True) - 1
    cid_u = (u_at - u_b * (C + 1)).clamp(0, C - 1)
    pos_u = u_key - tab[u_b * (C + 1) + cid_u]

    # ---- seeds: the first seed_budget per row ----
    s = torch.nonzero(u_seed).flatten()
    s_b = u_b[s]
    s_rank = _row_ranks(s_b, B)
    s, s_b, s_rank = (x[s_rank < seed_budget] for x in (s, s_b, s_rank))
    src = u_src[s]
    s_kmer = canon.reshape(-1)[src]
    s_pos = pos_u[s].to(torch.int32)
    s_cid = cid_u[s].to(torch.int32)
    s_strand = strand.reshape(-1)[src]
    # survivors are in ascending (genome, position) = (genome, contig,
    # position) order, so ONE stable sort by (genome, kmer) gives the
    # (kmer, contig, position) order per genome, and the unsorted table IS
    # the position view
    s_key = (s_b << 32) | s_kmer
    order = torch.sort(s_key, stable=True).indices
    _, inv, cnt = torch.unique_consecutive(s_key[order], return_inverse=True,
                                           return_counts=True)
    own_sorted = cnt[inv].to(torch.int32)
    own = torch.empty_like(own_sorted)
    own[order] = own_sorted
    o_b = s_b[order]
    o_rank = _row_ranks(o_b, B)
    SB = seed_budget

    def by_kmer(vals, fill):
        return _scatter_rows(o_b, o_rank, vals[order], B, SB, fill)

    def by_pos(vals, fill):
        return _scatter_rows(s_b, s_rank, vals, B, SB, fill)

    # the padding rows form one more k-mer run (the sentinel's), whose
    # multiplicity JAX records on each of them
    n_seeds = torch.bincount(s_b, minlength=B)
    pad = torch.arange(SB, device=dev)[None, :] >= n_seeds[:, None]
    pad_mult = (SB - n_seeds).to(torch.int32)[:, None]

    def mult(table):
        return torch.where(pad, pad_mult, table)

    # ---- markers: the first marker_budget per row, sorted, deduped ----
    m = torch.nonzero(u_marker).flatten()
    m_b = u_b[m]
    m = m[_row_ranks(m_b, B) < marker_budget]
    mk_b, m_hi, m_lo = _unique_markers(
        u_b[m], mcanon.reshape(-1)[u_src[m]], marker_k)
    mk_rank = _row_ranks(mk_b, B)

    return dict(
        n_seeds=n_seeds,
        kmers=by_kmer(s_kmer, U32_SENTINEL),
        positions=by_kmer(s_pos, I32_SENTINEL),
        contig_ids=by_kmer(s_cid, I32_SENTINEL),
        strands=by_kmer(s_strand, False),
        own_mult=mult(by_kmer(own, 0)),
        p_positions=by_pos(s_pos, I32_SENTINEL),
        p_contig_ids=by_pos(s_cid, I32_SENTINEL),
        p_own_mult=mult(by_pos(own, 0)),
        n_markers=torch.bincount(mk_b, minlength=B),
        markers_hi=_scatter_rows(mk_b, mk_rank, m_hi, B,
                                 marker_budget, U32_SENTINEL),
        markers_lo=_scatter_rows(mk_b, mk_rank, m_lo, B,
                                 marker_budget, U32_SENTINEL),
        n_seeds_want=seed_mask.sum(1),
        n_markers_want=marker_mask.sum(1),
    )


def sketch_kernel(packed_codes: torch.Tensor, contig_starts: torch.Tensor,
                  n_contigs: int, valid_floor: torch.Tensor | None = None, *,
                  k: int, marker_k: int, c: int, marker_c: int,
                  seed_budget: int, marker_budget: int):
    """All-positions FracMinHash scan + compaction for one genome: the
    one-row case of :func:`sketch_kernel_batch` ([L//4] codes, [C+1]
    starts and floors).  Returns a dict with the same keys, values and
    (int64 for u32) types as the JAX ``sketch_kernel``; the four counts
    are Python ints."""
    out = sketch_kernel_batch(
        packed_codes[None], contig_starts[None], [int(n_contigs)],
        None if valid_floor is None else valid_floor[None], k=k,
        marker_k=marker_k, c=c, marker_c=marker_c, seed_budget=seed_budget,
        marker_budget=marker_budget)
    res = {key: v[0] for key, v in out.items() if key not in _COUNTS}
    counts = torch.stack([out[key][0] for key in _COUNTS]).tolist()
    res.update(zip(_COUNTS, counts))
    return res


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _warn_sketch_overflow(name: str, want_seeds: int, want_markers: int,
                          seed_budget: int, marker_budget: int) -> None:
    """Loudly report sketch-budget saturation: when either mask outgrows
    its budget, rows are dropped."""
    import warnings
    if want_seeds > seed_budget or want_markers > marker_budget:
        warnings.warn(
            f"sketch {name!r} saturated its budgets (seeds "
            f"{want_seeds}/{seed_budget}, markers "
            f"{want_markers}/{marker_budget}): rows were dropped — "
            f"raise seed_budget/marker_budget", RuntimeWarning,
            stacklevel=3)


# Hard ceiling on contigs per genome: contig ids ride 14-bit fields in the
# chain engine's packed sort keys
MAX_CONTIGS_HARD = 1 << 14


def contig_budget_for(n: int) -> int:
    """Power-of-two contig-table budget for a genome with ``n`` contigs
    (it also sets the bits of the packed block-grid word that go to the
    contig id, see ops.chain.rcid_bits_for)."""
    if n > MAX_CONTIGS_HARD:
        raise ValueError(
            f"genome has {n} contigs (>= MIN_LENGTH_CONTIG), above the "
            f"engine's {MAX_CONTIGS_HARD} hard limit")
    b = 8
    while b < n:
        b *= 2
    return b


def _blank_seed_table(dev: DeviceSketch) -> DeviceSketch:
    """Drop the seed-position table (``seed=False`` sketches record only
    markers + metadata; they screen normally but produce no anchors)."""
    S = dev.seed_budget
    d = dev.device

    def full(v, dtype):
        return torch.full((S,), v, dtype=dtype, device=d)

    return dataclasses.replace(
        dev,
        kmers=full(U32_SENTINEL, torch.int64),
        positions=full(I32_SENTINEL, torch.int32),
        contig_ids=full(I32_SENTINEL, torch.int32),
        strands=full(False, torch.bool),
        own_mult=full(0, torch.int32),
        p_positions=full(I32_SENTINEL, torch.int32),
        p_contig_ids=full(I32_SENTINEL, torch.int32),
        p_own_mult=full(0, torch.int32),
        n_seeds=torch.tensor(0, dtype=torch.int32, device=d),
    )


def seed_budget_for(total_len: int, c: int) -> int:
    """Default seed-table budget: mean + generous slack, lane aligned."""
    expect = max(total_len // c, 256)
    return round_up(int(expect * 1.25) + 1024, 1024)


def marker_budget_for(total_len: int, marker_c: int) -> int:
    expect = max(total_len // marker_c, 64)
    return round_up(int(expect * 1.35) + 512, 512)


# per-call sequence budget: a kernel call holds several genome-length
# int64 intermediates, so genomes above it stream through chunked calls
GIANT_SKETCH_BUFFER = 1 << 27


@dataclasses.dataclass
class HostSketch:
    """A named genome sketch: metadata plus its ``DeviceSketch`` tensors
    (which live on the sketch's device, the card unless the caller asked
    for the CPU)."""

    name: str
    contig_names: List[str]
    device: DeviceSketch
    lengths: List[int] = dataclasses.field(default_factory=list)

    @property
    def total_len(self) -> int:
        return sum(self.lengths)

    def n_fragments(self, fl: int) -> int:
        return sum(max(1, -(-length // fl)) for length in self.lengths)


def _plan_sketch_pieces(kept: Sequence[bytes], K: int, max_buffer: int):
    """Split contigs into fed pieces of <= max_buffer bytes each and pack
    them into kernel calls.

    A piece is (true_cid, src_start, src_end, floor): the kernel is fed
    ``contig[src_start:src_end]``; continuation pieces of a split contig
    lead with a K-1-byte overlap (K = max(k, marker_k)) and mask window
    ends below ``floor`` so the chunk outputs tile the contig's windows
    exactly once.  Returns a list of calls, each a list of pieces.
    """
    if max_buffer < 4 * K:
        # a continuation piece must make progress past its K-1 overlap
        raise ValueError(f"max_buffer={max_buffer} too small for "
                         f"k-mer windows of up to {K} bases (need >= "
                         f"{4 * K})")
    pieces = []
    for cid, contig in enumerate(kept):
        n = len(contig)
        pos = 0
        while pos < n:
            lead = 0 if pos == 0 else K - 1
            new = min(n - pos, max_buffer - lead)
            pieces.append((cid, pos - lead, pos + new, lead))
            pos += new
    calls, cur, cur_len = [], [], 0
    for p in pieces:
        fed = p[2] - p[1]
        if cur and cur_len + fed > max_buffer:
            calls.append(cur)
            cur, cur_len = [], 0
        cur.append(p)
        cur_len += fed
    if cur:
        calls.append(cur)
    return calls


def pad_to(t: torch.Tensor, size: int, fill) -> torch.Tensor:
    """``t`` cut or padded with ``fill`` to ``size`` entries."""
    out = torch.full((size,), fill, dtype=t.dtype, device=t.device)
    k = min(t.shape[0], size)
    out[:k] = t[:k]
    return out


def _pack_call(pieces, slots: int, length_bucket: int, device):
    """One :func:`sketch_kernel` call's input from ``(bytes, floor)``
    pieces laid end to end: the packed codes (padded to a multiple of
    ``length_bucket``), the [slots + 1] starts table and the [slots + 1]
    window-end floors (each piece's start plus its floor); slots past the
    last piece hold the fed total."""
    with profiling.scope("sketch/pack"):
        total = sum(len(b) for b, _ in pieces)
        L = max(round_up(total, length_bucket), length_bucket)
        raw = np.zeros(L, dtype=np.uint8)
        starts = np.full(slots + 1, total, dtype=np.int32)
        floors = np.full(slots + 1, total, dtype=np.int32)
        off = 0
        for i, (b, floor) in enumerate(pieces):
            raw[off:off + len(b)] = np.frombuffer(b, dtype=np.uint8)
            starts[i], floors[i] = off, off + floor
            off += len(b)
    with profiling.scope("sketch/copy"):
        return (encode_pack(torch.from_numpy(raw).to(device)),
                torch.from_numpy(starts).to(device),
                torch.from_numpy(floors).to(device))


def _sketch_genome_chunked(name: str, kept: List[bytes], params: SketchParams,
                           seed_budget: int | None, marker_budget: int | None,
                           length_bucket: int, max_buffer: int,
                           contig_lengths: torch.Tensor) -> DeviceSketch:
    """Chunked sketching for genomes too large for one kernel call.

    Each call sketches a group of pieces through :func:`sketch_kernel`
    (``valid_floor`` masks the overlaps of split contigs).  The per-call
    tables are merged on the device: one (kmer, contig, position) order,
    own multiplicities from the k-mer runs of the UNION, the
    (contig, position) view, and the deduplicated union of the markers.
    Bit-equal to a single-call sketch and to the JAX package's chunked
    sketch (whose merge runs in numpy on the host)."""
    total = sum(len(c) for c in kept)
    device = contig_lengths.device
    K = max(params.k, params.marker_k)
    kmer_l, pos_l, cid_l, str_l, mark_l = [], [], [], [], []
    for pieces in _plan_sketch_pieces(kept, K, max_buffer):
        fed_total = sum(p[2] - p[1] for p in pieces)
        packed, starts, floors = _pack_call(
            [(memoryview(kept[cid])[s0:s1], floor)
             for cid, s0, s1, floor in pieces],
            contig_budget_for(len(pieces)), length_bucket, device)
        sb_c = seed_budget_for(fed_total, params.c)
        mb_c = marker_budget_for(fed_total, params.marker_c)
        with profiling.scope("sketch/kernel", device):
            out = sketch_kernel(
                packed, starts, len(pieces), floors, k=params.k,
                marker_k=params.marker_k, c=params.c,
                marker_c=params.marker_c, seed_budget=sb_c,
                marker_budget=mb_c)
        _warn_sketch_overflow(name, out["n_seeds_want"],
                              out["n_markers_want"], sb_c, mb_c)
        ns, nm = out["n_seeds"], out["n_markers"]
        piece_cid = torch.tensor([p[0] for p in pieces], dtype=torch.int64,
                                 device=device)
        piece_off = torch.tensor([p[1] for p in pieces], dtype=torch.int64,
                                 device=device)
        pidx = out["contig_ids"][:ns].to(torch.int64)
        kmer_l.append(out["kmers"][:ns])
        pos_l.append(out["positions"][:ns].to(torch.int64) + piece_off[pidx])
        cid_l.append(piece_cid[pidx])
        str_l.append(out["strands"][:ns])
        # markers as u64 bits with the sign flipped: signed order is the
        # unsigned (hi, lo) order
        mark_l.append(((out["markers_hi"][:nm] << 32) |
                       out["markers_lo"][:nm]) ^ I64_MIN)

    kmer, pos, cid, strand = (torch.cat(x) for x in
                              (kmer_l, pos_l, cid_l, str_l))
    # (kmer, contig, position) is unique per seed: a stable sort by
    # (contig, position), then a stable sort by kmer, gives the total order
    # (the second is the position view's order)
    p_order = torch.sort((cid << 32) | pos, stable=True).indices
    order = p_order[torch.sort(kmer[p_order], stable=True).indices]
    kmer_s = kmer[order]
    _, inv, cnt = torch.unique_consecutive(kmer_s, return_inverse=True,
                                           return_counts=True)
    own = torch.empty_like(kmer_s, dtype=torch.int32)
    own[order] = cnt[inv].to(torch.int32)
    markers = torch.unique(torch.cat(mark_l)) ^ I64_MIN

    n, m = kmer.shape[0], markers.shape[0]
    sb = seed_budget or seed_budget_for(total, params.c)
    mb = marker_budget or marker_budget_for(total, params.marker_c)
    if n > sb or m > mb:
        raise ValueError(f"chunked sketch {name!r} outgrew its budgets "
                         f"({n}>{sb} or {m}>{mb})")
    i32 = torch.int32

    def scalar(v):
        return torch.tensor(v, dtype=i32, device=device)

    return DeviceSketch(
        kmers=pad_to(kmer_s, sb, U32_SENTINEL),
        positions=pad_to(pos[order].to(i32), sb, I32_SENTINEL),
        contig_ids=pad_to(cid[order].to(i32), sb, I32_SENTINEL),
        strands=pad_to(strand[order], sb, False),
        own_mult=pad_to(own[order], sb, 0),
        p_positions=pad_to(pos[p_order].to(i32), sb, I32_SENTINEL),
        p_contig_ids=pad_to(cid[p_order].to(i32), sb, I32_SENTINEL),
        p_own_mult=pad_to(own[p_order], sb, 0),
        markers_hi=pad_to(_shr(markers, 32), mb, U32_SENTINEL),
        markers_lo=pad_to(markers & U32_MAX, mb, U32_SENTINEL),
        n_seeds=scalar(n), n_markers=scalar(m),
        contig_lengths=contig_lengths, n_contigs=scalar(len(kept)),
        total_len=torch.tensor(min(total, U32_MAX), dtype=torch.int64,
                               device=device))


def sketch_genome_device(
    name: str,
    contigs: Sequence[bytes],
    params: SketchParams,
    seed_budget: int | None = None,
    marker_budget: int | None = None,
    length_bucket: int = 1 << 20,
    max_contigs: int | None = None,
    seed: bool = True,
    max_buffer: int = GIANT_SKETCH_BUFFER,
    device: torch.device | str = "cuda",
) -> HostSketch:
    """Encode contigs, pad, run :func:`sketch_kernel_batch` on ``device``
    as a stack of one.

    Contigs shorter than MIN_LENGTH_CONTIG are skipped entirely.
    ``max_contigs`` defaults to a power-of-two bucket sized from the input.
    Genomes larger than ``max_buffer`` stream through chunked kernel calls
    (:func:`_sketch_genome_chunked`), with the same result.
    """
    kept = [c for c in contigs if len(c) >= MIN_LENGTH_CONTIG]
    contig_names = [f"{name}_{i}" for i, c in enumerate(contigs)
                    if len(c) >= MIN_LENGTH_CONTIG]
    if max_contigs is None:
        max_contigs = contig_budget_for(len(kept))
    elif max_contigs > MAX_CONTIGS_HARD:
        raise ValueError(f"max_contigs={max_contigs} exceeds the engine's "
                         f"{MAX_CONTIGS_HARD} hard limit (contig ids ride "
                         f"14-bit fields in the chain sort keys)")
    elif len(kept) > max_contigs:
        raise ValueError(f"genome {name!r} has {len(kept)} contigs, more "
                         f"than the max_contigs={max_contigs} budget")
    lengths = [len(c) for c in kept]
    device = torch.device(device)
    if sum(lengths) > max_buffer:
        clens = np.zeros(max_contigs, dtype=np.int32)
        clens[:len(lengths)] = lengths
        dev = _sketch_genome_chunked(name, kept, params, seed_budget,
                                     marker_budget, length_bucket,
                                     max_buffer,
                                     torch.from_numpy(clens).to(device))
    else:
        dev = _sketch_stack([(name, kept)], params, seed_budget,
                            marker_budget, length_bucket, max_contigs,
                            device)[0]
    if not seed:
        dev = _blank_seed_table(dev)
    return HostSketch(name=name, contig_names=contig_names, device=dev,
                      lengths=lengths)


def _sketch_stack(group, params: SketchParams, seed_budget: int | None,
                  marker_budget: int | None, length_bucket: int,
                  max_contigs: int | None, device) -> List[DeviceSketch]:
    """One stack of ``(name, kept contigs)`` genomes through
    :func:`sketch_kernel_batch`, with the budgets of its largest member
    (the JAX package's vmapped stack).  Rows are sketched in passes of at
    most ``GIANT_SKETCH_BUFFER`` bases, which bounds memory and leaves
    every row's result as it is."""
    B = len(group)
    totals = [sum(len(c) for c in kept) for _, kept in group]
    max_total = max(totals)
    L = max(round_up(max(max_total, 1), length_bucket), length_bucket)
    sb = seed_budget or seed_budget_for(max_total, params.c)
    mb = marker_budget or marker_budget_for(max_total, params.marker_c)
    mc = max_contigs if max_contigs is not None else \
        contig_budget_for(max(len(kept) for _, kept in group))
    if mc > MAX_CONTIGS_HARD:
        raise ValueError(f"max_contigs={mc} exceeds the engine's "
                         f"{MAX_CONTIGS_HARD} hard limit")
    with profiling.scope("sketch/pack"):
        raw = np.zeros((B, L), dtype=np.uint8)
        starts = np.zeros((B, mc + 1), dtype=np.int32)
        clens = np.zeros((B, mc), dtype=np.int32)
        for b, (gname, kept) in enumerate(group):
            if len(kept) > mc:
                raise ValueError(f"genome {gname!r} has {len(kept)} "
                                 f"contigs, more than the max_contigs={mc} "
                                 f"budget")
            off = 0
            for i, contig in enumerate(kept):
                raw[b, off:off + len(contig)] = np.frombuffer(contig,
                                                              np.uint8)
                starts[b, i] = off
                clens[b, i] = len(contig)
                off += len(contig)
            starts[b, len(kept):] = off
    with profiling.scope("sketch/copy"):
        packed = encode_pack(torch.from_numpy(raw).to(device))
        starts = torch.from_numpy(starts).to(device)
        clens = torch.from_numpy(clens).to(device)
    del raw

    rows = max(1, GIANT_SKETCH_BUFFER // L)
    with profiling.scope("sketch/kernel", device):
        parts = [sketch_kernel_batch(
            packed[lo:lo + rows], starts[lo:lo + rows],
            [len(kept) for _, kept in group[lo:lo + rows]], k=params.k,
            marker_k=params.marker_k, c=params.c, marker_c=params.marker_c,
            seed_budget=sb, marker_budget=mb) for lo in range(0, B, rows)]
        res = {key: torch.cat([p[key] for p in parts]) for key in parts[0]}
    with profiling.scope("sketch/counts"):
        counts = torch.stack([res.pop(key) for key in _COUNTS],
                             1).to(torch.int32)
        want = counts[:, 2:].tolist()
        for (gname, _), (ws, wm) in zip(group, want):
            _warn_sketch_overflow(gname, ws, wm, sb, mb)
        scalars = torch.tensor([[len(kept), min(t, U32_MAX)]
                                for (_, kept), t in zip(group, totals)],
                               dtype=torch.int64, device=device)
        return [DeviceSketch(
            **{key: v[b] for key, v in res.items()},
            n_seeds=counts[b, 0], n_markers=counts[b, 1],
            contig_lengths=clens[b],
            n_contigs=scalars[b, 0].to(torch.int32),
            total_len=scalars[b, 1]) for b in range(B)]


def sketch_genomes_device(
    named_contigs: Sequence[tuple],
    params: SketchParams,
    seed_budget: int | None = None,
    marker_budget: int | None = None,
    length_bucket: int = 1 << 20,
    max_contigs: int | None = None,
    device_batch: int = 8,
    seed: bool = True,
    max_buffer: int = GIANT_SKETCH_BUFFER,
    device: torch.device | str = "cuda",
) -> List[HostSketch]:
    """Sketch MANY genomes, one batched kernel pass per stack.

    ``named_contigs`` is a list of (name, [contig bytes...]).  Genomes are
    grouped into stacks of up to ``device_batch`` BY SIZE (ascending,
    ties in input order), so a stack's members share a padded length and
    budgets sized from its largest member; input order is restored on
    return.  Genomes above ``max_buffer`` take the chunked single-genome
    path.  Every sketch equals the JAX package's ``sketch_genomes_device``
    field for field, padded shapes included: a stack member's budgets (and
    what an overflowing budget clips) follow the stack's largest genome,
    so they can differ from a lone :func:`sketch_genome_device` call's.
    """
    device = torch.device(device)
    items = []
    for name, contigs in named_contigs:
        kept = [c for c in contigs if len(c) >= MIN_LENGTH_CONTIG]
        names = [f"{name}_{i}" for i, c in enumerate(contigs)
                 if len(c) >= MIN_LENGTH_CONTIG]
        items.append((name, kept, names, sum(len(c) for c in kept)))

    by_slot = {}
    for j, (name, kept, _, total) in enumerate(items):
        if total > max_buffer:
            clens = np.zeros(contig_budget_for(len(kept)), dtype=np.int32)
            clens[:len(kept)] = [len(c) for c in kept]
            by_slot[j] = _sketch_genome_chunked(
                name, kept, params, seed_budget, marker_budget,
                length_bucket, max_buffer, torch.from_numpy(clens).to(device))
    small = sorted((j for j, it in enumerate(items) if it[3] <= max_buffer),
                   key=lambda j: items[j][3])
    for lo in range(0, len(small), device_batch):
        slots = small[lo:lo + device_batch]
        sketches = _sketch_stack([items[j][:2] for j in slots], params,
                                 seed_budget, marker_budget, length_bucket,
                                 max_contigs, device)
        by_slot.update(zip(slots, sketches))
    out = []
    for j, (name, kept, names, _) in enumerate(items):
        dev = by_slot[j] if seed else _blank_seed_table(by_slot[j])
        out.append(HostSketch(name=name, contig_names=names, device=dev,
                              lengths=[len(c) for c in kept]))
    return out
