// Per-chain stage of the packed post-DP over a [P*NF, PF] anchor grid.
//
// Replaces no TPU kernel: the JAX package computes this stage with XLA
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
  if (smem > 48 * 1024) {
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
  const size_t room = optin > 1024 ? (size_t)optin - 1024 : 0;
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
