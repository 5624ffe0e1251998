// The packed post-DP on the card: the per-chain stage over a [P*NF, PF]
// anchor grid (chain_post_kernel), then the per-pair tail over its outputs
// (chain_tail_kernel, after the first kernel's launcher below).
//
// Per-chain stage.  Replaces no TPU kernel: the JAX package computes this stage with XLA
// ops (a per-row sort by chain root and segmented scans).  Its plain
// PyTorch version is pyskani_tpu_torch/ops/chain_post.py::chain_post_plain
// (scatter-reduces into [R, PF] bins keyed by root, a cumsum and nonzero
// compaction, an index_add_ of the reference-fragment numerators); every
// output is integer, so the two are bit-equal.
//
// Row r = p*NF + f is query fragment f of pair p; its valid anchors are
// its first n = min(count, PF) columns.  A chain is the set of a row's
// anchors that share a root (a column of the row at or before them).
// Per chain the stage needs count, min/max of w1 (qpos<<2|rev<<1|1),
// min/max of w2 (rpos<<rcid_bits|rcid) and the best score; it keeps the
// chain by the keep rule, and gives per row the kept anchors and the
// extended query span of the kept chains, per pair the kept chain ends in
// (row, root) order cut at CE with their full count, and the kept anchors
// counted by reference fragment (a fragment >= NF sets ref_over).
//
// Bound: bytes.  24 B per valid grid cell (w1, w2 int64, score f32, root
// int32) read once, plus the outputs: 24 B per row, 49 B per [P, CE] slot
// and 8 B per [P, NF] numerator.  At the species cell's shapes (NF 384,
// PF 256, CE 2048, ~37,500 valid cells a pair) that is ~1.0 MB a pair,
// 0.30 us at 3.35 TB/s.
//
// Design: ONE BLOCK PER PAIR, ONE WARP PER ROW, W warps taking the pair's
// rows in rounds of W (row f0 + w for warp w).
//   * A warp reads its row's valid prefix once, 64 columns a step, lane t
//     columns 2t and 2t+1: 16-byte loads of the int64 words, 8-byte loads
//     of score and root, coalesced.
//   * The row's chain bins (count, min/max w1, min/max w2, an ordered key
//     of the best score; 24 B per root) live in the warp's shared memory.
//     Per step the lanes holding one root are matched (match.any) and
//     reduced (redux.sync); the group's first lane updates the bins with
//     six shared atomics, so a chain costs one update per 32 anchors.
//   * One pass over the bins applies the keep rule, writes the row's
//     aggregates, and leaves the keep flag in place of the score key.
//   * Kept anchors are counted by reference fragment from a second read of
//     the row's w2 and roots (the row was just read: it comes from L1/L2)
//     into a [NF] histogram in shared memory, or, where NF does not fit,
//     by atomics on the pair's own global bins.  No masked cell is added.
//   * Compaction without a host sync: after each round every warp posts
//     its row's kept count, warp 0 scans the W counts onto the pair's
//     running total, and each warp writes its kept ends at its offset
//     from the bins it still holds.  The block fills the slots past the
//     total with the sentinel values at its end.
// W = 8 at PF 256 (48 KB of bins and 1.5 KB of histogram per block, so
// four blocks and 32 warps per SM): a call of 8 genomes (28 pairs) runs
// 28 blocks, a call of 27 genomes or a cross tile of 16 x 16 or more
// (up to P = 341, 131,072 rows) fills the card's 132 SMs in one wave.
// Each row of a round costs about two dependent global reads, so a block
// takes NF / W rounds of a few microseconds.  The rows of a round wait
// for the round's longest row; the rows of one pair are fragments of one
// genome pair and hold similar counts.  chip_smoke.py times it against
// the bound; PERF.md keeps the numbers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPF = 8192;           // ops/chain_post.py's MAX_PF
constexpr int kMaxWarps = 8;
constexpr int kBinBytes = 24;           // per root: six 32-bit words
constexpr int kBinBudget = 48 * 1024;   // bins per block W aims at
// a launch's dynamic and static shared memory together must fit the
// default 48 KB unless the kernel's attribute is raised first; both
// kernels' static shared memory stays under kStaticRoom
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kStaticRoom = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr long long kPosBig = 1LL << 30;
constexpr long long kNegBig = -(1LL << 30);
constexpr long long kSentinel = 0x7FFFFFFFLL;  // I32_SENTINEL

struct Params {
  const long long* w1;
  const long long* w2;
  const float* score;
  const int* root;
  const long long* row_bounds;
  const long long* tail_r;
  const long long* frag_offs;
  int NF, PF, CE, Cr, rbits;
  int hist_shared;
  long long fl, ext_l, ext_r, min_anchors, long_span;
  int use_score;
  float min_score;
  int do_numer;
  long long* numer;
  long long* span_lo;
  long long* span_hi;
  int* n_chains;
  long long* row_sel;
  unsigned char* end_valid;
  long long* end_qmn;
  long long* end_qmx;
  long long* end_rmn;
  long long* end_rmx;
  long long* end_rcid;
  long long* numer_r;
  unsigned char* ref_over;
};

// f32 -> u32 key whose unsigned order is the float order
__device__ __forceinline__ unsigned score_key(float s) {
  const unsigned b = __float_as_uint(s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_score(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// columns c and c+1 of a row (c even, c < n); kVec: one aligned vector
// load (PF even, so c+1 < PF)
template <bool kVec, typename T, typename V2>
__device__ __forceinline__ void load2(const T* row, int c, int n, T& a,
                                      T& b) {
  if (kVec) {
    const V2 v = __ldg(reinterpret_cast<const V2*>(row + c));
    a = v.x;
    b = v.y;
  } else {
    a = __ldg(row + c);
    if (c + 1 < n) b = __ldg(row + c + 1);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kMaxWarps * 32)
chain_post_kernel(const Params p) {
  extern __shared__ unsigned smem[];
  __shared__ int s_kept[kMaxWarps];
  __shared__ int s_off[kMaxWarps];
  __shared__ int s_total;
  __shared__ int s_over;

  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int NF = p.NF, PF = p.PF, CE = p.CE;
  const int pair = blockIdx.x;
  const unsigned rmask = (1u << p.rbits) - 1u;

  unsigned* cnt = smem + (size_t)warp * 6 * PF;
  unsigned* qmn = cnt + PF;
  unsigned* qmx = qmn + PF;
  unsigned* rmn = qmx + PF;
  unsigned* rmx = rmn + PF;
  unsigned* skey = rmx + PF;   // best score key, then the keep flag
  int* hist = reinterpret_cast<int*>(smem + (size_t)W * 6 * PF);
  long long* numer_r = p.numer_r + (size_t)pair * NF;
  const long long* fo = p.frag_offs + p.tail_r[pair] * (long long)(p.Cr + 1);

  if (p.hist_shared)
    for (int i = threadIdx.x; i < NF; i += blockDim.x) hist[i] = 0;
  if (threadIdx.x == 0) s_over = 0;
  long long total = 0;   // warp 0: kept chains of the rows before
  __syncthreads();

  for (int f0 = 0; f0 < NF; f0 += W) {
    const int f = f0 + warp;
    const long long r = (long long)pair * NF + f;
    int n = 0, kept = 0;
    if (f < NF) {
      const long long c = p.row_bounds[r + 1] - p.row_bounds[r];
      n = (int)(c < 0 ? 0 : (c < PF ? c : PF));
    }
    const size_t off = (size_t)r * (size_t)PF;
    if (n > 0) {
      for (int b = lane; b < n; b += 32) {
        cnt[b] = 0u; qmn[b] = kFull; qmx[b] = 0u;
        rmn[b] = kFull; rmx[b] = 0u; skey[b] = 0u;
      }
      __syncwarp();
      // ---- chain bins ----
      for (int c0 = 0; c0 < n; c0 += 64) {
        const int c = c0 + 2 * lane;
        long long a1[2] = {0, 0}, a2[2] = {0, 0};
        float sc[2] = {0.f, 0.f};
        int rt[2] = {0, 0};
        if (c < n) {
          load2<kVec, long long, longlong2>(p.w1 + off, c, n, a1[0], a1[1]);
          load2<kVec, long long, longlong2>(p.w2 + off, c, n, a2[0], a2[1]);
          load2<kVec, float, float2>(p.score + off, c, n, sc[0], sc[1]);
          load2<kVec, int, int2>(p.root + off, c, n, rt[0], rt[1]);
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const bool v = c + k < n;
          const unsigned vm = __ballot_sync(kFull, v);
          if (v) {
            const int bin = min(max(rt[k], 0), n - 1);
            const unsigned g = __match_any_sync(vm, bin);
            const unsigned w1 = (unsigned)a1[k], w2 = (unsigned)a2[k];
            const unsigned q_lo = __reduce_min_sync(g, w1);
            const unsigned q_hi = __reduce_max_sync(g, w1);
            const unsigned r_lo = __reduce_min_sync(g, w2);
            const unsigned r_hi = __reduce_max_sync(g, w2);
            const unsigned s_hi = __reduce_max_sync(g, score_key(sc[k]));
            if (lane == __ffs(g) - 1) {
              atomicAdd(&cnt[bin], (unsigned)__popc(g));
              atomicMin(&qmn[bin], q_lo);
              atomicMax(&qmx[bin], q_hi);
              atomicMin(&rmn[bin], r_lo);
              atomicMax(&rmx[bin], r_hi);
              atomicMax(&skey[bin], s_hi);
            }
          }
          __syncwarp();
        }
      }
      __syncwarp();
      // ---- keep rule and the row's aggregates ----
      unsigned numer = 0u, q_lo = kFull, q_hi = 0u;
      for (int b0 = 0; b0 < n; b0 += 32) {
        const int b = b0 + lane;
        bool kp = false;
        if (b < n) {
          const unsigned cb = cnt[b];
          if (cb > 0u) {
            const long long lo = qmn[b] >> 2, hi = qmx[b] >> 2;
            kp = (long long)cb >= p.min_anchors;
            if (p.use_score) kp = kp && key_score(skey[b]) >= p.min_score;
            if (p.long_span > 0)
              kp = kp || (cb >= 2u && hi - lo >= p.long_span);
          }
          if (kp) {
            numer += cb;
            q_lo = min(q_lo, qmn[b]);
            q_hi = max(q_hi, qmx[b]);
          }
          skey[b] = kp ? 1u : 0u;
        }
        kept += __popc(__ballot_sync(kFull, kp));
      }
      numer = __reduce_add_sync(kFull, numer);
      q_lo = __reduce_min_sync(kFull, q_lo);
      q_hi = __reduce_max_sync(kFull, q_hi);
      if (lane == 0) {
        long long lo = kPosBig, hi = kNegBig;
        if (kept > 0) {
          // the plain version's amin / amax also see the unkept bins
          lo = (long long)(q_lo >> 2) - p.ext_l;
          hi = (long long)(q_hi >> 2) + p.ext_r;
          if (kept < PF) {
            lo = lo < kPosBig ? lo : kPosBig;
            hi = hi > kNegBig ? hi : kNegBig;
          }
        }
        p.numer[r] = numer;
        p.span_lo[r] = lo;
        p.span_hi[r] = hi;
      }
      __syncwarp();
      // ---- kept anchors by reference fragment ----
      if (p.do_numer && kept > 0) {
        for (int c0 = 0; c0 < n; c0 += 64) {
          const int c = c0 + 2 * lane;
          if (c >= n) continue;
          long long a2[2] = {0, 0};
          int rt[2] = {0, 0};
          load2<kVec, long long, longlong2>(p.w2 + off, c, n, a2[0], a2[1]);
          load2<kVec, int, int2>(p.root + off, c, n, rt[0], rt[1]);
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            if (c + k >= n || !skey[min(max(rt[k], 0), n - 1)]) continue;
            const unsigned w2 = (unsigned)a2[k];
            const int rcid = min((int)(w2 & rmask), p.Cr - 1);
            const long long frag =
                fo[max(rcid, 0)] + (long long)(w2 >> p.rbits) / p.fl;
            if (frag >= NF) {
              s_over = 1;
            } else if (p.hist_shared) {
              atomicAdd(&hist[frag], 1);
            } else {
              atomicAdd(reinterpret_cast<unsigned long long*>(numer_r + frag),
                        1ull);
            }
          }
        }
      }
    } else if (f < NF && lane == 0) {
      p.numer[r] = 0;
      p.span_lo[r] = kPosBig;
      p.span_hi[r] = kNegBig;
    }
    // ---- this round's offsets in the pair's kept-chain table ----
    if (lane == 0) s_kept[warp] = kept;
    __syncthreads();
    if (warp == 0) {
      const int v = lane < W ? s_kept[lane] : 0;
      int incl = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += u;
      }
      if (lane < W) {
        const long long at = total + incl - v;
        s_off[lane] = (int)(at < CE ? at : CE);
      }
      total += __shfl_sync(kFull, incl, 31);
    }
    __syncthreads();
    if (kept > 0) {
      int at = s_off[warp];
      for (int b0 = 0; b0 < n && at < CE; b0 += 32) {
        const int b = b0 + lane;
        const bool kp = b < n && skey[b] != 0u;
        const unsigned m = __ballot_sync(kFull, kp);
        const int slot = at + __popc(m & ((1u << lane) - 1u));
        if (kp && slot < CE) {
          const size_t e = (size_t)pair * CE + slot;
          p.row_sel[e] = f;
          p.end_valid[e] = 1;
          p.end_qmn[e] = qmn[b] >> 2;
          p.end_qmx[e] = qmx[b] >> 2;
          p.end_rmn[e] = rmn[b] >> p.rbits;
          p.end_rmx[e] = rmx[b] >> p.rbits;
          p.end_rcid[e] = rmn[b] & rmask;
        }
        at += __popc(m);
      }
    }
  }

  if (threadIdx.x == 0) {
    s_total = (int)(total < CE ? total : CE);
    p.n_chains[pair] = (int)total;
  }
  __syncthreads();
  for (int s = s_total + threadIdx.x; s < CE; s += blockDim.x) {
    const size_t e = (size_t)pair * CE + s;
    p.row_sel[e] = 0;
    p.end_valid[e] = 0;
    p.end_qmn[e] = kSentinel;
    p.end_qmx[e] = kSentinel;
    p.end_rmn[e] = kSentinel;
    p.end_rmx[e] = kSentinel;
    p.end_rcid[e] = 0;
  }
  if (p.hist_shared)
    for (int i = threadIdx.x; i < NF; i += blockDim.x) numer_r[i] = hist[i];
  if (threadIdx.x == 0) p.ref_over[pair] = s_over ? 1 : 0;
}

template <bool kVec>
int launch(const Params& p, int P, int W, size_t smem, cudaStream_t stream) {
  if (smem + kStaticRoom > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        chain_post_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  chain_post_kernel<kVec><<<P, W * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success).
// numer_r must be zeroed by the caller: where the [NF] histogram does not
// fit in shared memory the kernel adds into it.
extern "C" int chain_post_launch(
    const long long* w1, const long long* w2, const float* score,
    const int* root, const long long* row_bounds, const long long* tail_r,
    const long long* frag_offs, int P, int NF, int PF, int CE, int Cr,
    int rbits, long long fl, long long ext_l, long long ext_r,
    long long min_anchors, long long long_span, int use_score,
    float min_score, int do_numer, long long* numer, long long* span_lo,
    long long* span_hi, int* n_chains, long long* row_sel,
    unsigned char* end_valid, long long* end_qmn, long long* end_qmx,
    long long* end_rmn, long long* end_rmx, long long* end_rcid,
    long long* numer_r, unsigned char* ref_over, void* stream) {
  if (P <= 0 || NF <= 0 || PF < 0 || PF > kMaxPF || CE < 0 || Cr < 1 ||
      rbits < 1 || rbits > 31 || fl <= 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  int W = PF > 0 ? kBinBudget / (kBinBytes * PF) : kMaxWarps;
  W = W < 1 ? 1 : (W > kMaxWarps ? kMaxWarps : W);
  W = W > NF ? NF : W;
  const size_t bins = (size_t)W * kBinBytes * PF;
  const size_t with_hist = bins + (size_t)NF * sizeof(int);
  // room for the kernel's static shared memory
  const size_t room = optin > (int)kStaticRoom ? optin - kStaticRoom : 0;
  const bool hist_shared = with_hist <= room;
  const size_t smem = hist_shared ? with_hist : bins;
  if (smem > room) return (int)cudaErrorInvalidValue;
  Params p{w1, w2, score, root, row_bounds, tail_r, frag_offs,
           NF, PF, CE, Cr, rbits, hist_shared ? 1 : 0,
           fl, ext_l, ext_r, min_anchors, long_span, use_score, min_score,
           do_numer, numer, span_lo, span_hi, n_chains, row_sel, end_valid,
           end_qmn, end_qmx, end_rmn, end_rmx, end_rcid, numer_r, ref_over};
  const bool vec = PF % 2 == 0 && (uintptr_t)w1 % 16 == 0 &&
                   (uintptr_t)w2 % 16 == 0 && (uintptr_t)score % 8 == 0 &&
                   (uintptr_t)root % 8 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch<true>(p, P, W, smem, s)
             : launch<false>(p, P, W, smem, s);
}

// ---------------------------------------------------------------------------
// Per-pair tail of the packed post-DP.
//
// Replaces no TPU kernel: the JAX package computes it with XLA ops.  Its
// plain PyTorch version is ops/chain_post.py::chain_tail_plain (about 400
// small ops a call: searchsorted over [P, S] gathered seed tables, the
// reference spans' scatter-reduces, a sort and quantiles, two sorts and
// cummaxes for the unions).  Counts, flags and the aligned fractions are
// bit-equal to it; the quantiles, the median and the fragment ANIs use
// the same f32 operations (the build turns off fused multiply-add); the
// mean and the trimmed mean sum in double here and in f32 there, so they
// agree within a few ulp.
//
// Per pair p, with genome rows gq = tail_q[p], gr = tail_r[p]:
//   * query fragment f is covered when numer >= max(1, min_frag_anchors);
//     its span [lo, hi] is the kept chains' span clipped to the fragment,
//     and its denominator the eligible seeds of the query genome in it,
//     those before lower_bound(pos, hi + 1) less those before
//     lower_bound(pos, lo) over the genome's sorted global seed positions,
//     from its running count of eligible seeds, both read in place;
//   * fragment ANI = min(numer / max(denom, 1), 1) ^ (1/k), +inf when not
//     covered;
//   * with est_side "both": each kept end's reference interval, cut into
//     4 pieces at reference fragment boundaries, reduced by min / max into
//     [NF] bins (a piece at a fragment >= NF sets frag_overflow), then the
//     reference denominators and ANIs over numer_r;
//   * the M = NF or 2 NF values sorted: mean, the 10% and 90%
//     linear-interpolated quantiles, the trimmed mean inside them, the
//     median; with est_ci the sorted row is written for the bootstrap;
//   * the union lengths of the kept ends' query and reference intervals
//     (sorted by start, running max of the ends), over the genome lengths.
//
// Bound: bytes.  Per pair it reads the stage's outputs (24 B a row, 8 B a
// reference numerator, 49 B a kept end, 21 B of per-pair inputs) and
// writes 25 B; per covered fragment of either side it makes two binary
// searches into the genome's S sorted seed positions (ceil(log2(S + 1))
// dependent 8-byte reads each, from L2 once the pair's genomes are warm)
// and two 8-byte reads of the running count (chip_smoke.py's _tail_bytes
// counts the same).  That is well under a microsecond a call at 3.35 TB/s;
// the kernel is bound by its dependent reads and its block's sorts rather
// than bytes.  PERF.md keeps the numbers.
//
// Design: ONE BLOCK PER PAIR, threads over fragments and ends.  The M
// values, the reference spans and the intervals live in shared memory
// (the spans and the intervals share one buffer, used one after the
// other); the sorts are bitonic over the next power of two, the union's
// running max a chunked block scan.  A call is one launch, whatever P:
// 16 blocks in a search call, up to ~340 in a triangle call, all
// resident at once on the card's 132 SMs.

namespace {

constexpr int kTailMaxThreads = 256;
constexpr int kRefSpanPieces = 4;   // ops/chain.py's _REF_SPAN_PIECES

struct Side {   // one side's per-genome tables, row g = genome g
  const long long* starts;      // [G, C+1] contig starts
  const long long* frag_offs;   // [G, C+1]
  const int* clens;             // [G, C]
  const long long* pos;         // [G, S] sorted global seed positions
  const long long* pref;        // [G, S] eligible seeds up to and
                                // including each
                                // (pos and pref: the reference side's
                                //  only with est_side "both")
  const long long* total;       // [G]
  int C, S;
};

struct TailParams {
  const long long* numer;       // [P*NF]
  const long long* span_lo;
  const long long* span_hi;
  const int* n_chains;          // [P]
  const long long* row_sel;     // [P, CE]
  const unsigned char* end_valid;
  const long long* end_qmn;
  const long long* end_qmx;
  const long long* end_rmn;
  const long long* end_rmx;
  const long long* end_rcid;
  const long long* numer_r;     // [P, NF]
  const unsigned char* ref_over;  // [P]
  const long long* tail_r;
  const long long* tail_q;
  Side q, r;
  int NF, CE, both, Mp, cap;
  long long min_cov, fl, ext_l, ext_r;
  float inv_k;
  float* ani_mean;
  float* ani_robust;
  float* ani_median;
  int* n_fragments;
  float* af_query;
  float* af_ref;
  unsigned char* frag_overflow;
  float* ranked;                // [P, M] or null
};

// first i in [0, n) with a[i] >= v, else n (torch.searchsorted, left)
__device__ __forceinline__ long long lower_bound(const long long* a, int n,
                                                 long long v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// contig of fragment f: the last whose fragment offset is at or before f,
// clipped to [0, C-1] (ops/chain.py::_frag_contig)
__device__ __forceinline__ long long frag_contig(const long long* fo, int C,
                                                 long long f) {
  int lo = 0, hi = C + 1;   // first offset past f
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(fo + mid) <= f) lo = mid + 1; else hi = mid;
  }
  return min(max((long long)lo - 1, 0LL), (long long)C - 1);
}

// eligible seeds of genome g in the global span [lo, hi]: those before
// lower_bound(hi + 1) less those before lower_bound(lo)
__device__ __forceinline__ long long span_denom(const Side& s, long long g,
                                                long long lo, long long hi) {
  const long long* pos = s.pos + g * s.S;
  const long long* pref = s.pref + g * s.S;
  const long long a = lower_bound(pos, s.S, lo);
  const long long b = lower_bound(pos, s.S, hi + 1);
  return (b > 0 ? __ldg(pref + b - 1) : 0) - (a > 0 ? __ldg(pref + a - 1) : 0);
}

// ops/chain.py::_frag_ani for a covered fragment, in its f32 operations
__device__ __forceinline__ float frag_ani(long long numer, long long denom,
                                          float inv_k) {
  const float d = fmaxf((float)denom, 1.0f);
  return powf(fminf(__fdiv_rn((float)numer, d), 1.0f), inv_k);
}

// ops/chain.py::_interp_quantile of the first n of the sorted s[0, M)
__device__ __forceinline__ float interp_quantile(const float* s, int n, int M,
                                                 float q) {
  const float pos = __fmul_rn(q, __fsub_rn((float)n, 1.0f));
  const long long lo = (long long)floorf(pos);
  const long long hi = min(lo + 1, (long long)n - 1);
  const float w = __fsub_rn(pos, (float)lo);
  const float v_lo = s[min(max(lo, 0LL), (long long)M - 1)];
  const float v_hi = s[min(max(hi, 0LL), (long long)M - 1)];
  return __fadd_rn(__fmul_rn(v_lo, __fsub_rn(1.0f, w)), __fmul_rn(v_hi, w));
}

// sum over the block, the same in every thread and in a fixed order;
// scratch: 32 entries of shared memory
template <typename T>
__device__ T block_sum(T v, T* scratch) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(kFull, v, d);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  T t = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += scratch[w];
  return t;
}

// max of the values of the threads before this one, and `init`
__device__ long long block_excl_max(long long v, long long* scratch,
                                    long long init) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long u = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x = max(x, u);
  }
  const long long before_lane = __shfl_up_sync(kFull, x, 1);
  __syncthreads();
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  long long m = init;
  for (int w = 0; w < warp; ++w) m = max(m, scratch[w]);
  return lane > 0 ? max(m, before_lane) : m;
}

// ascending bitonic sort of key[0, n) (n a power of two), carrying val
// when given; ends with the block synchronised
template <typename K>
__device__ void bitonic_sort(K* key, long long* val, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i) {
          const K a = key[i], b = key[l];
          if ((a > b) == ((i & k) == 0)) {
            key[i] = b;
            key[l] = a;
            if (val) {
              const long long t = val[i];
              val[i] = val[l];
              val[l] = t;
            }
          }
        }
      }
      __syncthreads();
    }
  }
}

// ops/chain.py::_union_length of the intervals [lo[i], hi[i]], i < n (a
// power of two; padding has hi = NEG_BIG), in every thread
__device__ long long union_length(long long* lo, long long* hi, int n,
                                  long long* scratch) {
  __syncthreads();
  bitonic_sort(lo, hi, n);
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int a = min((int)threadIdx.x * per, n), b = min(a + per, n);
  long long m = kNegBig;
  for (int i = a; i < b; ++i) m = max(m, hi[i]);
  long long run = block_excl_max(m, scratch, kNegBig);
  long long sum = 0;
  for (int i = a; i < b; ++i) {
    const long long c = hi[i] - max(lo[i] - 1, run);
    if (c > 0 && hi[i] != kNegBig) sum += c;
    run = max(run, hi[i]);
  }
  return block_sum(sum, scratch);
}

__global__ void __launch_bounds__(kTailMaxThreads)
chain_tail_kernel(const TailParams p) {
  extern __shared__ long long tail_smem[];
  __shared__ long long s_ll[32];
  __shared__ double s_d[32];

  const int pair = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int NF = p.NF, CE = p.CE;
  const int M = p.both ? 2 * NF : NF;
  long long* buf_lo = tail_smem;          // reference spans, then intervals
  long long* buf_hi = tail_smem + p.cap;
  float* vals = reinterpret_cast<float*>(tail_smem + 2 * (size_t)p.cap);
  const long long gq = p.tail_q[pair], gr = p.tail_r[pair];
  const long long* q_st = p.q.starts + gq * (p.q.C + 1);
  const long long* q_fo = p.q.frag_offs + gq * (p.q.C + 1);
  const int* q_cl = p.q.clens + gq * p.q.C;
  const long long* r_st = p.r.starts + gr * (p.r.C + 1);
  const int* r_cl = p.r.clens + gr * p.r.C;
  const size_t e0 = (size_t)pair * CE;
  const int n_ends = min(max(p.n_chains[pair], 0), CE);

  // ---- query fragments ----
  long long n_cov = 0;
  double sum = 0.0;
  for (int f = tid; f < NF; f += T) {
    const size_t row = (size_t)pair * NF + f;
    const long long n = p.numer[row];
    float fa = INFINITY;
    if (n >= p.min_cov) {
      const long long cid = frag_contig(q_fo, p.q.C, f);
      const long long base = (f - q_fo[cid]) * p.fl;
      const long long end = min(base + p.fl - 1, (long long)q_cl[cid] - 1);
      const long long lo = max(p.span_lo[row], base);
      const long long hi = min(p.span_hi[row], end);
      fa = frag_ani(n, span_denom(p.q, gq, q_st[cid] + lo, q_st[cid] + hi),
                    p.inv_k);
      ++n_cov;
      sum += fa;
    }
    vals[f] = fa;
  }

  // ---- reference fragments ----
  long long over = p.ref_over[pair] ? 1 : 0;
  if (p.both) {
    const long long* r_fo = p.r.frag_offs + gr * (p.r.C + 1);
    for (int f = tid; f < NF; f += T) {
      buf_lo[f] = kSentinel;
      buf_hi[f] = kNegBig;
    }
    __syncthreads();
    for (int e = tid; e < n_ends; e += T) {
      if (!p.end_valid[e0 + e]) continue;
      const long long rcid =
          min(max(p.end_rcid[e0 + e], 0LL), (long long)p.r.C - 1);
      const long long lo = max(p.end_rmn[e0 + e] - p.ext_l, 0LL);
      const long long hi =
          min(p.end_rmx[e0 + e] + p.ext_r, (long long)r_cl[rcid] - 1);
      const long long f0 = lo / p.fl;
      const long long fo = r_fo[rcid];
#pragma unroll
      for (int j = 0; j < kRefSpanPieces; ++j) {
        const long long base = (f0 + j) * p.fl;
        const long long plo = max(lo, base);
        const long long phi = min(hi, base + p.fl - 1);
        const long long fj = fo + f0 + j;
        if (plo > phi) continue;
        if (fj < NF) {
          atomicMin(&buf_lo[fj], plo);
          atomicMax(&buf_hi[fj], phi);
        } else {
          over = 1;
        }
      }
    }
    __syncthreads();
    for (int f = tid; f < NF; f += T) {
      const long long n = p.numer_r[(size_t)pair * NF + f];
      float fa = INFINITY;
      if (n >= p.min_cov) {
        const long long st = r_st[frag_contig(r_fo, p.r.C, f)];
        fa = frag_ani(n, span_denom(p.r, gr, st + buf_lo[f], st + buf_hi[f]),
                      p.inv_k);
        ++n_cov;
        sum += fa;
      }
      vals[NF + f] = fa;
    }
  }
  for (int i = M + tid; i < p.Mp; i += T) vals[i] = INFINITY;

  // ---- pooled estimators ----
  const int n = (int)block_sum(n_cov, s_ll);
  sum = block_sum(sum, s_d);
  over = block_sum(over, s_ll);
  bitonic_sort(vals, (long long*)nullptr, p.Mp);
  const float q10 = interp_quantile(vals, n, M, 0.1f);
  const float q90 = interp_quantile(vals, n, M, 0.9f);
  long long in_win = 0;
  double win_sum = 0.0;
  for (int i = tid; i < n; i += T) {
    const float s = vals[i];
    if (s >= q10 && s <= q90) {
      ++in_win;
      win_sum += s;
    }
  }
  in_win = block_sum(in_win, s_ll);
  win_sum = block_sum(win_sum, s_d);
  if (tid == 0) {
    const int mid_hi = min(max(n / 2, 0), M - 1);
    const int mid_lo = min(max((n - 1) >> 1, 0), M - 1);  // floor division
    const bool none = n == 0;
    p.ani_mean[pair] =
        none ? 0.0f : __fdiv_rn((float)sum, fmaxf((float)n, 1.0f));
    p.ani_robust[pair] =
        none ? 0.0f : __fdiv_rn((float)win_sum, fmaxf((float)in_win, 1.0f));
    p.ani_median[pair] =
        none ? 0.0f : __fmul_rn(0.5f, __fadd_rn(vals[mid_lo], vals[mid_hi]));
    p.n_fragments[pair] = n;
    p.frag_overflow[pair] = over > 0 ? 1 : 0;
  }
  if (p.ranked)
    for (int i = tid; i < M; i += T) p.ranked[(size_t)pair * M + i] = vals[i];

  // ---- aligned fractions: unions of the kept ends' intervals ----
  int np2 = 1;
  while (np2 < n_ends) np2 <<= 1;
  __syncthreads();   // the reference spans are read
  for (int e = tid; e < np2; e += T) {
    long long lo = kPosBig, hi = kNegBig;
    if (e < n_ends && p.end_valid[e0 + e]) {
      const long long cid = frag_contig(q_fo, p.q.C, p.row_sel[e0 + e]);
      lo = q_st[cid] + max(p.end_qmn[e0 + e] - p.ext_l, 0LL);
      hi = q_st[cid] + min(p.end_qmx[e0 + e] + p.ext_r,
                           (long long)q_cl[cid] - 1);
    }
    buf_lo[e] = lo;
    buf_hi[e] = hi;
  }
  const long long u_q = union_length(buf_lo, buf_hi, np2, s_ll);
  for (int e = tid; e < np2; e += T) {
    long long lo = kPosBig, hi = kNegBig;
    if (e < n_ends && p.end_valid[e0 + e]) {
      const long long rcid =
          min(max(p.end_rcid[e0 + e], 0LL), (long long)p.r.C - 1);
      lo = r_st[rcid] + max(p.end_rmn[e0 + e] - p.ext_l, 0LL);
      hi = r_st[rcid] + min(p.end_rmx[e0 + e] + p.ext_r,
                            (long long)r_cl[rcid] - 1);
    }
    buf_lo[e] = lo;
    buf_hi[e] = hi;
  }
  const long long u_r = union_length(buf_lo, buf_hi, np2, s_ll);
  if (tid == 0) {
    p.af_query[pair] =
        __fdiv_rn((float)u_q, fmaxf((float)p.q.total[gq], 1.0f));
    p.af_ref[pair] = __fdiv_rn((float)u_r, fmaxf((float)p.r.total[gr], 1.0f));
  }
}

int pow2_at_least(int n) {
  int v = 1;
  while (v < n) v <<= 1;
  return v;
}

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success).  Each
// side's tables are (starts, frag_offs, clens, pos, pref, total, C, S);
// the reference side's pos and pref are read only when `both`.  `ranked`
// ([P, M] sorted values) may be null.
extern "C" int chain_tail_launch(
    const long long* numer, const long long* span_lo,
    const long long* span_hi, const int* n_chains, const long long* row_sel,
    const unsigned char* end_valid, const long long* end_qmn,
    const long long* end_qmx, const long long* end_rmn,
    const long long* end_rmx, const long long* end_rcid,
    const long long* numer_r, const unsigned char* ref_over,
    const long long* tail_r, const long long* tail_q,
    const long long* q_starts, const long long* q_frag_offs,
    const int* q_clens, const long long* q_pos, const long long* q_pref,
    const long long* q_total, int q_C, int q_S, const long long* r_starts,
    const long long* r_frag_offs, const int* r_clens, const long long* r_pos,
    const long long* r_pref, const long long* r_total, int r_C, int r_S,
    int P, int NF, int CE, int both, long long min_cov, long long fl,
    long long ext_l, long long ext_r, float inv_k, float* ani_mean,
    float* ani_robust, float* ani_median, int* n_fragments, float* af_query,
    float* af_ref, unsigned char* frag_overflow, float* ranked,
    void* stream) {
  if (P <= 0 || NF <= 0 || CE < 0 || q_C < 1 || r_C < 1 || q_S < 0 ||
      r_S < 0 || fl <= 0)
    return (int)cudaErrorInvalidValue;
  const int M = both ? 2 * NF : NF;
  const int Mp = pow2_at_least(M);
  const int ends = pow2_at_least(CE);
  const int cap = both && NF > ends ? NF : ends;
  // threads: a power of two from 32 to 256, about a quarter of the
  // longest sort
  const int longest = Mp > cap ? Mp : cap;
  int T = 32;
  while (T < kTailMaxThreads && 4 * T < longest) T <<= 1;
  const size_t smem = 2 * (size_t)cap * sizeof(long long) +
                      (size_t)Mp * sizeof(float);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem + kStaticRoom > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (smem + kStaticRoom > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        chain_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  TailParams p{numer, span_lo, span_hi, n_chains, row_sel, end_valid,
               end_qmn, end_qmx, end_rmn, end_rmx, end_rcid, numer_r,
               ref_over, tail_r, tail_q,
               Side{q_starts, q_frag_offs, q_clens, q_pos, q_pref, q_total,
                    q_C, q_S},
               Side{r_starts, r_frag_offs, r_clens, r_pos, r_pref, r_total,
                    r_C, r_S},
               NF, CE, both, Mp, cap, min_cov, fl, ext_l, ext_r, inv_k,
               ani_mean, ani_robust, ani_median, n_fragments, af_query,
               af_ref, frag_overflow, ranked};
  chain_tail_kernel<<<P, T, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
