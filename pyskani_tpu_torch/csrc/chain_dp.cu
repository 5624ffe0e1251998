// Banded sparse chain DP over row-major anchor grids [R, PF].
//
// Replaces the JAX package's Pallas TPU kernel
// pyskani_tpu/ops/chain_dp_pallas.py::_dp_kernel (wrapped there by
// dp_pallas).  Its plain PyTorch version is
// pyskani_tpu_torch/ops/chain_dp.py::chain_dp_plain; the two are held
// bit-equal on the card by chip_smoke.py.
//
// Each grid row is one fragment row of one pair: an independent
// recurrence walked in anchor order (columns).  Anchor j extends from the
// best qualifying predecessor i among the last `band` anchors of its row:
//   both valid, equal meta>>1 (query contig, ref contig, strand),
//   dr = rpos_j - rpos_i > 0, dq = qpos_j - qpos_i > 0 (negated on the
//   reverse strand), gap = |dr - dq| < max_gap;
//   cand = (score_i + anchor_score) - (float)gap * gap_scale,
//   the subtraction of the product fused (one rounding), which is what
//   XLA compiles the JAX expression to.
// It extends only if the best candidate beats anchor_score; ties go to the
// most recent predecessor.  Outputs: score (f32) and root (i32, the column
// of the chain head).  Meta packs qcid[30:17] rcid[16:3] rev[1] valid[0].
//
// Bound at the main-path shape [R, PF] = [4096, 256]: 20 bytes per cell
// (three int32 in, one f32 and one int32 out), 21 MB, 6.3 us at 3.35 TB/s;
// the predecessor tests the data needs (~2,200 per row of ~100 valid
// anchors, ~20 integer/f32 operations each) take 2.7 us at the card's
// f32 rate, so bytes bound it.
//
// A thread per row, with the window in registers, leaves the card idle:
// at R = 4096 that is about one warp per SM, each thread walking its 256
// dependent columns at full latency (~0.5 ms on an NVIDIA H100 80GB HBM3
// at 700 W, ~78x the bound).  This design runs ONE WARP PER ROW, 4 rows
// per block (~31 warps per SM):
//   * The band window (<= 32 anchors) is a ring across the warp: thread t
//     holds the newest VALID anchor processed at a column = t (mod 32):
//     its column, rpos, diagonal, meta, score and root.  Slot t is a
//     predecessor of column j only if j - column <= band.  Since band <=
//     32, an anchor left in a slot behind a skipped (invalid) column is at
//     least 33 columns old, so the distance test alone drops it.
//   * The warp reads its row in chunks of 32 columns, thread t column
//     32c+t of each plane: coalesced 128-byte loads, the next chunk
//     loaded while this one runs, and coalesced stores of the chunk's
//     outputs at its end (a valid column's from its slot, an invalid
//     column's (anchor_score, j)).
//   * Only valid columns do work.  The chunk's valid bits come from one
//     ballot; a fully valid chunk runs its 32 columns unrolled (no loop
//     control, constant offsets, one block the compiler schedules across
//     columns), any other walks the set bits, with no assumption that
//     valid anchors form a prefix.
//   * Per column: the anchor reaches every thread as one broadcast int4
//     load from the chunk staged in shared memory; every thread tests its
//     slot; one redux.sync gives the best candidate, a second the largest
//     column among the slots that tie with it (the most recent), whose
//     lane is that column mod 32, and a shuffle its root.
// What bounds it now is instruction issue, not memory: every worked
// column costs the warp some twenty integer instructions (the test, the
// two reductions, taking the anchor into its slot), which Hopper issues
// at half its f32 rate, and the longest rows finish last.  chip_smoke.py
// times it against the bound; PERF.md keeps the numbers.
// Strands: dq and dr - dq are differences of q' = rev ? -q : q and of the
// diagonal r - q', which each thread computes once for its loaded column;
// int32 arithmetic wraps, as it does in JAX.  The candidate is spelled out
// with intrinsics, __fadd_rn then __fmaf_rn(-gap, gap_scale, .), and the
// build uses --fmad=false, so its rounding does not depend on nvcc's
// contraction choices.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBand = 32;
constexpr int kRowsPerBlock = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// One window slot per thread: the newest valid anchor processed at a
// column = t (mod 32).
struct Slot {
  int j, r, d, m, root;
  float score;
};

// Column base+k of the chunk, valid, against the window; thread k then
// takes it into its slot.  cr/cqs/cd/cm are this thread's own column's
// rpos, strand-signed qpos, diagonal and meta.
__device__ __forceinline__ void dp_column(int k, int base, int t, int cr,
                                          int cqs, int cd, int cm, Slot& w,
                                          const int4* chunk,
                                          int band, float anchor_score,
                                          float gap_scale, int max_gap) {
  const int j = base + k;
  const int4 b = chunk[k];
  const int br = b.x, bqs = b.y, bd = b.z, bm = b.w;
  const int dr = wrap_sub(br, w.r);
  const int dq = wrap_sub(bqs, wrap_sub(w.r, w.d));
  const int d = wrap_sub(bd, w.d);
  const int gap = d < 0 ? wrap_sub(0, d) : d;
  // bm is valid, so equal meta means equal meta>>1 and a valid slot
  const bool ok = j - w.j <= band && w.m == bm && dr > 0 && dq > 0 &&
                  gap < max_gap;
  const float cand = __fmaf_rn(-__int2float_rn(gap), gap_scale,
                               __fadd_rn(w.score, anchor_score));
  // Only candidates above anchor_score (>= 0, checked by the launcher)
  // can extend.  They are positive floats (no -0, no NaN), whose bit
  // patterns order as unsigned integers, and equal bits are equal floats.
  // Key 0 marks the rest.
  const unsigned key =
      (ok && cand > anchor_score) ? (unsigned)__float_as_int(cand) : 0u;
  const unsigned best = __reduce_max_sync(kFull, key);
  // the most recent tied slot holds the largest column; its lane is that
  // column modulo 32, which the shuffle takes
  const int jbest = (int)__reduce_max_sync(
      kFull, key == best ? (unsigned)(w.j + (1 << 30)) : 0u);
  const int rbest = __shfl_sync(kFull, w.root, jbest);
  if (t == k) {
    w.j = j; w.r = cr; w.d = cd; w.m = cm;
    w.score = best ? __int_as_float((int)best) : anchor_score;
    w.root = best ? rbest : j;
  }
}

__global__ void __launch_bounds__(kRowsPerBlock * 32)
chain_dp_kernel(const int* __restrict__ qpos, const int* __restrict__ rpos,
                const int* __restrict__ meta, float* __restrict__ score,
                int* __restrict__ root, int R, int PF, int band,
                float anchor_score, float gap_scale, int max_gap) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;  // warp-uniform: the whole warp leaves
  const int t = threadIdx.x & 31;
  const size_t off = (size_t)row * (size_t)PF;
  const int* q_row = qpos + off;
  const int* r_row = rpos + off;
  const int* m_row = meta + off;
  float* s_row = score + off;
  int* t_row = root + off;

  __shared__ int4 chunk_s[kRowsPerBlock][32];
  int4* chunk = chunk_s[threadIdx.x >> 5];
  // the first column is far enough back to be out of band
  Slot w{-(1 << 30), 0, 0, 0, 0, 0.0f};
  int cq = 0, cr = 0, cm = 0;
  if (t < PF) { cq = q_row[t]; cr = r_row[t]; cm = m_row[t]; }
  for (int base = 0; base < PF; base += 32) {
    const int col = base + t;
    int nq = 0, nr = 0, nm = 0;
    if (col + 32 < PF) {
      nq = q_row[col + 32]; nr = r_row[col + 32]; nm = m_row[col + 32];
    }
    const int cqs = (cm & 2) ? wrap_sub(0, cq) : cq;
    const int cd = wrap_sub(cr, cqs);
    const unsigned valid = __ballot_sync(kFull, cm & 1);
    __syncwarp();
    chunk[t] = make_int4(cr, cqs, cd, cm);
    __syncwarp();
    if (valid == kFull) {
#pragma unroll
      for (int k = 0; k < 32; ++k)
        dp_column(k, base, t, cr, cqs, cd, cm, w, chunk, band, anchor_score,
                  gap_scale, max_gap);
    } else {
      for (unsigned todo = valid; todo != 0; todo &= todo - 1)
        dp_column(__ffs(todo) - 1, base, t, cr, cqs, cd, cm, w, chunk, band,
                  anchor_score, gap_scale, max_gap);
    }
    if (col < PF) {
      const bool v = (cm & 1) != 0;
      s_row[col] = v ? w.score : anchor_score;
      t_row[col] = v ? w.root : col;
    }
    cq = nq; cr = nr; cm = nm;
  }
}

}  // namespace

extern "C" int chain_dp_max_band() { return kMaxBand; }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int chain_dp_launch(const int* qpos, const int* rpos,
                               const int* meta, float* score, int* root,
                               int R, int PF, int band, float anchor_score,
                               float gap_scale, int max_gap, void* stream) {
  if (band < 0 || band > kMaxBand || !(anchor_score >= 0.0f))
    return (int)cudaErrorInvalidValue;
  const int blocks = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  chain_dp_kernel<<<blocks, kRowsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      qpos, rpos, meta, score, root, R, PF, band, anchor_score, gap_scale,
      max_gap);
  return (int)cudaGetLastError();
}
