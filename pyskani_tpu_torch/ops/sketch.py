"""FracMinHash sketching on PyTorch tensors.

Port of the JAX package's ``ops/sketch.py`` (``sketch_kernel``, the
budget helpers, ``sketch_genome_device``).  The semantics are the same:
all contigs of a genome are concatenated into one buffer, every position
gets its canonical k=15 seed window and k=21 marker window, both are
hashed with Wang's 64-bit mix and kept below ``(2^64-1)//c``, survivors
are compacted into the seed and marker budgets, and the seed table is
sorted by (kmer, contig, position) beside a (contig, position) view.

Where the JAX code bent around the TPU, this port takes the GPU-natural
form and stays bit-equal on every output:

* 64-bit values ride int64 tensors (multiply, add and ``<<`` wrap mod
  2^64 with the same bits; ``>>`` is masked to a logical shift), so the
  u32-pair emulation of the 64-bit hash is not needed;
* compaction is ``nonzero`` (ascending indices) instead of a blocked
  index sort, and each position finds its contig by a binary search of
  the starts table instead of a scatter-max and running-max fill;
* the survivors are already in (contig, position) order, so the
  kmer-sorted table is ONE stable sort by kmer, and the position-sorted
  view is the compacted table itself;
* genomes above ``GIANT_SKETCH_BUFFER`` are sketched in chunked calls
  whose tables are merged on the device (the JAX package merges them in
  numpy on the host).

Only the fused k=15 / marker_k=21 path is ported; other k raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from ..params import MIN_LENGTH_CONTIG, SketchParams

U32_SENTINEL = 0xFFFFFFFF
I32_SENTINEL = 0x7FFFFFFF
I64_MAX = (1 << 63) - 1

# 2-bit encoding: A=0, C=1, G=2, T=3 (upper and lower case); every other
# byte (N included) maps to 0, as skani's BYTE_TO_SEQ table does
BYTE_TO_SEQ = np.zeros(256, dtype=np.uint8)
for _b, _v in ((b"Aa", 0), (b"Cc", 1), (b"Gg", 2), (b"Tt", 3)):
    for _ch in _b:
        BYTE_TO_SEQ[_ch] = _v


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
    # marker sketch: sorted unique 42-bit canonical k-mers as (hi, lo)
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
    """All rolling windows the scan needs, by log-doubling (int64 lanes).

    Returns (fwd15, rev15, marker_fwd, marker_rev) where entry i covers the
    window ending at position i.  Forward k-mers pack the newest base in
    the low bits; reverse complements pack the newest base's complement in
    the high bits.  Every intermediate stays below 2^32 except the 42-bit
    markers, so int64 needs no masks.  The window at the start of the
    buffer wraps (``torch.roll``), as ``jnp.roll`` does; callers mask it
    with ``pos_in_contig >= k-1``.
    """
    # intermediates are dropped as soon as they are used: a genome-length
    # int64 array is 8 bytes per base
    c = codes.to(torch.int64)
    r1 = 3 - c
    f2 = (torch.roll(c, 1) << 2) | c
    del c
    f4 = (torch.roll(f2, 2) << 4) | f2
    del f2
    f8 = (torch.roll(f4, 4) << 8) | f4
    del f4
    f16 = (torch.roll(f8, 8) << 16) | f8
    fwd15 = f16 & 0x3FFFFFFF
    f5 = f8 & 0x3FF                       # newest 5 bases
    del f8
    m_f = (torch.roll(f5, 16) << 32) | f16     # 42-bit forward marker k-mer
    del f5, f16

    r2 = (r1 << 2) | torch.roll(r1, 1)
    del r1
    r4 = (r2 << 4) | torch.roll(r2, 2)
    del r2
    r8 = (r4 << 8) | torch.roll(r4, 4)
    del r4
    r16 = (r8 << 16) | torch.roll(r8, 8)
    rev15 = r16 >> 2
    r5 = r8 >> 6                          # newest 5 complements (top)
    del r8
    m_r = (r5 << 32) | torch.roll(r16, 5)      # 42-bit reverse marker k-mer
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
    """Unsigned ``h < thr`` for u64 bits in int64, with ``thr < 2^63``."""
    assert 0 < thr <= I64_MAX
    return (h >= 0) & (h < thr)


def _compact(mask: torch.Tensor, budget: int, arrays, sentinels):
    """Gather ``arrays`` at the set positions of ``mask`` (ascending),
    keeping the first ``budget`` and padding with per-array sentinels.
    Returns (count, gathered...)."""
    src = torch.nonzero(mask).flatten()[:budget]
    count = src.numel()
    out = []
    for arr, sent in zip(arrays, sentinels):
        col = torch.full((budget,), sent, dtype=arr.dtype, device=arr.device)
        col[:count] = arr[src]
        out.append(col)
    return count, out


def encode_pack_host(raw: np.ndarray) -> np.ndarray:
    """ASCII bytes -> 2-bit codes packed 4/byte (host side, vectorised).
    Length must be a multiple of 4 (length buckets are)."""
    codes = BYTE_TO_SEQ[raw]
    q = codes.reshape(-1, 4)
    return (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) |
            (q[:, 3] << 6)).astype(np.uint8)


def sketch_kernel(packed_codes: torch.Tensor, contig_starts: torch.Tensor,
                  n_contigs: int, valid_floor: torch.Tensor | None = None, *,
                  k: int, marker_k: int, c: int, marker_c: int,
                  seed_budget: int, marker_budget: int):
    """All-positions FracMinHash scan + compaction for one genome.

    ``packed_codes`` is uint8 [L//4] (``encode_pack_host``, oldest base in
    bits 1:0); ``contig_starts`` int32 [C+1] holds the global start of
    each contig with ``contig_starts[n_contigs] = total_len``.
    ``valid_floor`` (int32 [C+1], optional) is a global window-end floor
    per contig: the chunked giant-genome path feeds continuation pieces
    of a split contig with a K-1 overlap and masks the overlap's window
    ends with it.  Returns a dict with the same keys, values and (int64
    for u32) types as the JAX ``sketch_kernel``.
    """
    if k != 15 or marker_k != 21:
        raise NotImplementedError(
            f"k={k} / marker_k={marker_k}: the port implements the fused "
            f"k=15 / marker_k=21 sketch only (generic k is still to port)")
    dev = packed_codes.device
    thr = (2**64 - 1) // c
    mthr = (2**64 - 1) // marker_c
    L = packed_codes.shape[0] * 4
    C = contig_starts.shape[0] - 1
    n_contigs = int(n_contigs)

    shifts = torch.arange(4, device=dev, dtype=torch.uint8) * 2
    codes = ((packed_codes[:, None] >> shifts[None, :]) & 3).reshape(L)

    # in-contig position: i - (global start of my contig).  The JAX
    # package fills it with a scatter-max of the starts and a running
    # max; a binary search of the (tiny, ascending) starts table gives
    # the same start for every position
    starts64 = contig_starts.to(torch.int64)
    ii = torch.arange(L, device=dev, dtype=torch.int64)
    table = starts64[:n_contigs + 1]
    my_contig = torch.searchsorted(table, ii, right=True) - 1
    pos_in_contig = ii - table[my_contig]
    total_len = int(contig_starts[min(max(n_contigs, 0), C)])
    in_seq = ii < total_len
    if valid_floor is not None:
        # the floors increase with the contig (floor < next start), so the
        # contig found above also picks the floor
        in_seq &= ii >= valid_floor.to(torch.int64)[:n_contigs + 1][my_contig]
    del my_contig

    fwd, rev, mfwd, mrev = _rolling_windows(codes)
    del codes
    strand = fwd < rev
    canon = torch.where(strand, fwd, rev)
    del fwd, rev
    h = mm_hash64(canon)
    mcanon = torch.minimum(mfwd, mrev)
    del mfwd, mrev
    seed_mask = in_seq & (pos_in_contig >= k - 1) & _below(h, thr)
    del h
    mh = mm_hash64(mcanon)
    marker_mask = in_seq & (pos_in_contig >= marker_k - 1) & _below(mh, mthr)
    del mh, pos_in_contig, in_seq
    n_seeds_want = int(seed_mask.sum())
    n_markers_want = int(marker_mask.sum())

    # ---- union compaction (clipped to the summed budgets, as in JAX) ----
    union_budget = seed_budget + marker_budget
    u_src = torch.nonzero(seed_mask | marker_mask).flatten()[:union_budget]
    u_seed = seed_mask[u_src]
    u_marker = marker_mask[u_src]
    # survivor contig id: count of table starts <= position, minus one
    cid_u = (torch.searchsorted(table, u_src, right=True) - 1).clamp(0, C - 1)
    pos_u = u_src - starts64[cid_u]

    n_seeds, (s_kmer, s_pos, s_cid, s_strand) = _compact(
        u_seed, seed_budget,
        (canon[u_src], pos_u.to(torch.int32), cid_u.to(torch.int32),
         strand[u_src]),
        (U32_SENTINEL, I32_SENTINEL, I32_SENTINEL, False))
    # survivors are in ascending global position = (contig, position)
    # order, so ONE stable sort by kmer gives the (kmer, contig,
    # position) order, and the unsorted table IS the position view
    order = torch.sort(s_kmer, stable=True).indices
    kmers = s_kmer[order]
    _, inv, cnt = torch.unique_consecutive(kmers, return_inverse=True,
                                           return_counts=True)
    own_mult = cnt[inv].to(torch.int32)
    p_own = torch.empty_like(own_mult)
    p_own[order] = own_mult

    # ---- markers: compact, sort, dedupe (one int64 key per marker) ----
    _, (m_key,) = _compact(u_marker, marker_budget, (mcanon[u_src],),
                           (I64_MAX,))
    m_key = torch.sort(m_key).values
    first = torch.ones_like(m_key, dtype=torch.bool)
    first[1:] = m_key[1:] != m_key[:-1]
    first &= m_key != I64_MAX
    uniq = m_key[first][:marker_budget]
    n_markers = uniq.numel()
    mu = torch.full((marker_budget,), -1, dtype=torch.int64, device=dev)
    mu[:n_markers] = uniq
    mu_hi = torch.where(mu < 0, U32_SENTINEL, mu >> 32)
    mu_lo = mu & 0xFFFFFFFF

    return dict(
        n_seeds=n_seeds, kmers=kmers, positions=s_pos[order],
        contig_ids=s_cid[order], strands=s_strand[order], own_mult=own_mult,
        p_positions=s_pos, p_contig_ids=s_cid, p_own_mult=p_own,
        n_markers=n_markers, markers_hi=mu_hi, markers_lo=mu_lo,
        n_seeds_want=n_seeds_want, n_markers_want=n_markers_want,
    )


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
U32_MAX = (1 << 32) - 1


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
    return (torch.from_numpy(encode_pack_host(raw)).to(device),
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
        out = sketch_kernel(
            packed, starts, len(pieces), floors, k=params.k,
            marker_k=params.marker_k, c=params.c, marker_c=params.marker_c,
            seed_budget=sb_c, marker_budget=mb_c)
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
        mark_l.append((out["markers_hi"][:nm] << 32) | out["markers_lo"][:nm])

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
    markers = torch.unique(torch.cat(mark_l))

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
        markers_hi=pad_to(markers >> 32, mb, U32_SENTINEL),
        markers_lo=pad_to(markers & U32_MAX, mb, U32_SENTINEL),
        n_seeds=scalar(n), n_markers=scalar(m),
        contig_lengths=contig_lengths, n_contigs=scalar(len(kept)),
        total_len=torch.tensor(min(total, U32_MAX), dtype=torch.int64,
                               device=device))


def _sketch_genome_single(name: str, kept: List[bytes], params: SketchParams,
                          seed_budget: int | None, marker_budget: int | None,
                          length_bucket: int,
                          contig_lengths: torch.Tensor) -> DeviceSketch:
    """One :func:`sketch_kernel` call over all contigs, concatenated."""
    total = sum(len(c) for c in kept)
    device = contig_lengths.device
    packed, starts, _ = _pack_call([(c, 0) for c in kept],
                                   contig_lengths.shape[0], length_bucket,
                                   device)
    sb = seed_budget or seed_budget_for(total, params.c)
    mb = marker_budget or marker_budget_for(total, params.marker_c)
    out = sketch_kernel(
        packed, starts, len(kept), k=params.k, marker_k=params.marker_k,
        c=params.c, marker_c=params.marker_c, seed_budget=sb,
        marker_budget=mb)
    _warn_sketch_overflow(name, out.pop("n_seeds_want"),
                          out.pop("n_markers_want"), sb, mb)

    def scalar(v, dtype=torch.int32):
        return torch.tensor(v, dtype=dtype, device=device)

    return DeviceSketch(
        kmers=out["kmers"], positions=out["positions"],
        contig_ids=out["contig_ids"], strands=out["strands"],
        own_mult=out["own_mult"],
        p_positions=out["p_positions"], p_contig_ids=out["p_contig_ids"],
        p_own_mult=out["p_own_mult"],
        markers_hi=out["markers_hi"], markers_lo=out["markers_lo"],
        n_seeds=scalar(out["n_seeds"]), n_markers=scalar(out["n_markers"]),
        contig_lengths=contig_lengths, n_contigs=scalar(len(kept)),
        # u32 in the JAX package: saturates for genomes of 4.3 Gbp or more
        total_len=scalar(min(total, U32_MAX), torch.int64))


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
    """Encode contigs, pad, run :func:`sketch_kernel` on ``device``.

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
    total = sum(lengths)
    device = torch.device(device)
    clens = np.zeros(max_contigs, dtype=np.int32)
    clens[:len(lengths)] = lengths
    clens = torch.from_numpy(clens).to(device)
    if total > max_buffer:
        dev = _sketch_genome_chunked(name, kept, params, seed_budget,
                                     marker_budget, length_bucket,
                                     max_buffer, clens)
    else:
        dev = _sketch_genome_single(name, kept, params, seed_budget,
                                    marker_budget, length_bucket, clens)
    if not seed:
        dev = _blank_seed_table(dev)
    return HostSketch(name=name, contig_names=contig_names, device=dev,
                      lengths=lengths)
