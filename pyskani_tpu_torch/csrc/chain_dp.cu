// Banded sparse chain DP over transposed anchor grids [PF, NL].
//
// Replaces the JAX package's Pallas TPU kernel
// pyskani_tpu/ops/chain_dp_pallas.py::_dp_kernel (wrapped there by
// dp_pallas).  Its plain PyTorch version is
// pyskani_tpu_torch/ops/chain_dp.py::chain_dp_plain; the two are held
// bit-equal on the card by chip_smoke.py.
//
// Each lane (column) is one fragment row of one pair: an independent
// recurrence walked in anchor order (rows).  Anchor j extends from the
// best qualifying predecessor i among the last `band` anchors of its lane:
//   both valid, equal meta>>1 (query contig, ref contig, strand),
//   dr = rpos_j - rpos_i > 0, dq = qpos_j - qpos_i > 0 (negated on the
//   reverse strand), gap = |dr - dq| < max_gap;
//   cand = (score_i + anchor_score) - (float)gap * gap_scale,
//   the subtraction of the product fused (one rounding), which is what
//   XLA compiles the JAX expression to.
// It extends only if the best candidate beats anchor_score; ties go to the
// most recent predecessor.  Outputs: score (f32) and root (i32, the row of
// the chain head).  Meta packs qcid[30:17] rcid[16:3] rev[1] valid[0].
//
// Design: one thread per lane; lanes are minor in [PF, NL], so the 32
// threads of a warp read 32 neighbouring words per row.  The band window
// is a shift register of MAXB entries held in registers (all indices are
// compile-time after unrolling).  Predecessors are scanned newest first
// and the first strict maximum is kept, which is exactly the JAX
// min-recency tie-break.  The candidate is spelled out with intrinsics,
// __fadd_rn then __fmaf_rn(-gap, gap_scale, .), so its rounding does not
// depend on nvcc's contraction choices: XLA evaluates the JAX expression
// as one fused multiply-add, and a separately rounded product differs in
// the last bit for about a third of candidates, which can flip a tie.
//
// Bound at the main-path shape [PF, NL] = [256, 4096]: 20 bytes per cell
// (three int32 in, one f32 and one int32 out), ~21 MB, ~6 us at
// 3.35 TB/s; about 25 predecessor tests of ~20 integer/f32 operations per
// cell.  The walk over PF is sequential per lane, and NL = 4096 gives only
// 32 blocks of 128 threads for 132 SMs, so the kernel is latency-bound and
// under-occupied at that shape.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxBand = 32;

template <int MAXB>
__global__ void chain_dp_kernel(const int* __restrict__ qpos,
                                const int* __restrict__ rpos,
                                const int* __restrict__ meta,
                                float* __restrict__ score,
                                int* __restrict__ root,
                                int PF, int NL, int band,
                                float anchor_score, float gap_scale,
                                int max_gap) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= NL) return;

  int wq[MAXB], wr[MAXB], wm[MAXB], wt[MAXB];
  float ws[MAXB];
#pragma unroll
  for (int i = 0; i < MAXB; ++i) {
    wq[i] = 0; wr[i] = 0; wm[i] = 0; wt[i] = 0; ws[i] = 0.0f;
  }

  for (int j = 0; j < PF; ++j) {
    const size_t off = (size_t)j * (size_t)NL + (size_t)lane;
    const int cq = qpos[off];
    const int cr = rpos[off];
    const int cm = meta[off];
    const bool cvalid = (cm & 1) != 0;
    const bool crev = (cm & 2) != 0;
    const int ckey = cm >> 1;

    float best = -INFINITY;
    int rbest = 0;
#pragma unroll
    for (int i = 0; i < MAXB; ++i) {
      if (i < band) {
        // int32 differences wrap, as they do in JAX
        const int dr = (int)((unsigned)cr - (unsigned)wr[i]);
        const int dqf = (int)((unsigned)cq - (unsigned)wq[i]);
        const int dq = crev ? (int)(0u - (unsigned)dqf) : dqf;
        const int d = (int)((unsigned)dr - (unsigned)dq);
        const int gap = d < 0 ? (int)(0u - (unsigned)d) : d;
        const bool ok = cvalid && ((wm[i] & 1) != 0) &&
                        ((wm[i] >> 1) == ckey) && dr > 0 && dq > 0 &&
                        gap < max_gap;
        if (ok) {
          const float cand =
              __fmaf_rn(-__int2float_rn(gap), gap_scale,
                        __fadd_rn(ws[i], anchor_score));
          if (cand > best) {
            best = cand;
            rbest = wt[i];
          }
        }
      }
    }
    const bool extend = best > anchor_score;
    const float s = extend ? best : anchor_score;
    const int rt = (extend && cvalid) ? rbest : j;
    score[off] = s;
    root[off] = rt;

#pragma unroll
    for (int i = MAXB - 1; i > 0; --i) {
      wq[i] = wq[i - 1]; wr[i] = wr[i - 1]; wm[i] = wm[i - 1];
      wt[i] = wt[i - 1]; ws[i] = ws[i - 1];
    }
    wq[0] = cq; wr[0] = cr; wm[0] = cm; wt[0] = rt; ws[0] = s;
  }
}

}  // namespace

extern "C" int chain_dp_max_band() { return kMaxBand; }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int chain_dp_launch(const int* qpos, const int* rpos,
                               const int* meta, float* score, int* root,
                               int PF, int NL, int band, float anchor_score,
                               float gap_scale, int max_gap, void* stream) {
  if (band < 0 || band > kMaxBand) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (NL + threads - 1) / threads;
  chain_dp_kernel<kMaxBand><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      qpos, rpos, meta, score, root, PF, NL, band, anchor_score, gap_scale,
      max_gap);
  return (int)cudaGetLastError();
}
