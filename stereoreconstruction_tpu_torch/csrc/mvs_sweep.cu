// Multi-view stereo depth sweep (tap gather + weighted NCC + WTA or top-K)
// on Hopper.
//
// Replaces the TPU kernel stereoreconstruction_tpu/ops/pallas_mvs.py
// (pallas_mvs_wta -> _mvs_kernel), in both of its modes.  Same function as
// its plain PyTorch versions, ops/cuda_mvs.py mvs_wta_plain and
// mvs_topk_plain: for every reference pixel, depth label and neighbour view,
// the (2r+1)^2 integer taps of the neighbour's gray image at the projected
// coordinate, the seven-accumulator weighted NCC (ops/ncc.py ncc_accumulate,
// mvs_mode), the peak test NCC > thr, the neighbour-validity mask and the max
// over neighbours; then each label's candidate goes into an ascending list
// of the K best (ncc, depth) hypotheses (multiview.py mvs_topk_slab,
// multiviewstereo.cpp:574-602).  K = 1 is the WTA carry (mvs_wta_slab), in
// which a later (larger) depth wins ties.
//
// Tap semantics are the reference's (int) casts as the TPU kernel states
// them: coordinates clamp to +-1e6 before floorf (a float->int cast of 1e20
// or of the -3e6 sentinel is undefined), tap (r, c) reads
// clip(floor(x2) + c, 0, ws-1) and is valid iff -1 < x2 + c < ws (rows
// alike), and the base sample is valid iff x2 > -1e6.
//
// Bound on the H100 (one view, 384 x 512, D = 100 labels, N = 3): the
// coordinate volume [D, N, 2, H, W] f32 is ~472 MB, read once: 0.14 ms at
// 3.35 TB/s.  The taps and NCC are ~11 float32 operations a valid tap, ~1.5e10
// a view: 0.22 ms at 67 TFLOP/s.  The bound is the operations; the top-K
// insertion adds ~4K operations a (pixel, label), ~0.5% of them at K = 9.
//
// Design: one thread per reference pixel, 1-D over pixels so a warp reads
// each coordinate plane coalesced.  The thread holds its 25 left values x
// weights, the 25 weights and the 25 left-validity bits in registers for the
// whole sweep, loops over labels [label0, label0 + n_labels) and, inside, over
// neighbours, and gathers its 25 taps straight from the neighbour image
// through the read-only cache (neighbouring pixels tap neighbouring image
// rows, so the taps hit L1/L2).  Nothing is staged, so no tap can fall
// outside a staged patch: the wrapper's oob_frac is 0 by construction.  The
// K-entry list lives in registers (the insertion is unrolled over K).  In WTA
// mode a thread whose centre is masked writes (-inf, -1) and exits (the caller
// writes inf there); in top-K mode every pixel is swept, since the hypotheses
// of a masked pixel enter the MRF's pairwise terms of its neighbours.  Built
// with --fmad=false: the sums round as in the plain version, so the NCC
// values and the picks agree with it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr float kWeps = 1e-10f;

template <int R, int K>
__global__ void __launch_bounds__(kBlock)
mvs_sweep_kernel(const float* __restrict__ depths,
                 const float* __restrict__ coords,
                 const float* __restrict__ gray_nbr,
                 const float* __restrict__ gl,
                 const uint8_t* __restrict__ lv,
                 const float* __restrict__ wts,
                 const uint8_t* __restrict__ nbr_valid,
                 const uint8_t* __restrict__ center_valid,
                 float* __restrict__ ncc_out, float* __restrict__ depth_out,
                 int H, int W, int N, int hs, int ws, int label0,
                 int n_labels, float thr) {
  constexpr int S = 2 * R + 1;
  constexpr int T = S * S;
  static_assert(T <= 32, "tap mask is one 32-bit word");
  const int HW = H * W;
  const int p = blockIdx.x * kBlock + threadIdx.x;
  if (p >= HW) return;
  if (K == 1 && center_valid != nullptr && !center_valid[p]) {
    ncc_out[p] = -INFINITY;
    depth_out[p] = -1.f;
    return;
  }

  float w[T], wl[T];
  uint32_t lmask = 0;
#pragma unroll
  for (int k = 0; k < T; ++k) {
    w[k] = wts[k * HW + p];
    wl[k] = w[k] * gl[k * HW + p];
    if (lv[k * HW + p] && w[k] > kWeps) lmask |= 1u << k;
  }

  const float fws = (float)ws, fhs = (float)hs;
  // ascending (ncc, depth) list, padded with (-inf, -1)
  float top_n[K], top_d[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    top_n[j] = -INFINITY;
    top_d[j] = -1.f;
  }
  for (int i = 0; i < n_labels; ++i) {
    float m = -INFINITY;
    for (int n = 0; n < N; ++n) {
      const float* c = coords + (size_t)(i * N + n) * 2 * HW;
      const float x2 = c[p];
      const float y2 = c[HW + p];
      float ncc = -INFINITY;
      if (x2 > -1e6f) {
        const float ixf = floorf(fminf(fmaxf(x2, -1e6f), 1e6f));
        const float iyf = floorf(fminf(fmaxf(y2, -1e6f), 1e6f));
        const float* g = gray_nbr + (size_t)n * hs * ws;
        float s_w = 0.f, s_l = 0.f, s_r = 0.f, s_ll = 0.f, s_rr = 0.f,
              s_lr = 0.f, cnt = 0.f;
#pragma unroll
        for (int r = -R; r <= R; ++r) {
          const float yr = y2 + (float)r;
          const bool row_ok = yr > -1.f && yr < fhs;
          const int jy = (int)fminf(fmaxf(iyf + (float)r, 0.f), fhs - 1.f);
#pragma unroll
          for (int cc = -R; cc <= R; ++cc) {
            const int k = (r + R) * S + (cc + R);
            const float xc = x2 + (float)cc;
            if (row_ok && xc > -1.f && xc < fws && ((lmask >> k) & 1u)) {
              const int jx =
                  (int)fminf(fmaxf(ixf + (float)cc, 0.f), fws - 1.f);
              const float wr = w[k] * __ldg(g + jy * ws + jx);
              s_w = s_w + w[k];
              s_l = s_l + wl[k];
              s_r = s_r + wr;
              s_ll = s_ll + wl[k] * wl[k];
              s_rr = s_rr + wr * wr;
              s_lr = s_lr + wl[k] * wr;
              cnt = cnt + 1.f;
            }
          }
        }
        const bool have = s_w > kWeps;
        const float s_w_safe = have ? s_w : 1.f;
        const float mean_l = s_l / s_w_safe;
        const float mean_r = s_r / s_w_safe;
        const float sum1 = s_lr - mean_l * s_r - mean_r * s_l
                           + cnt * mean_l * mean_r;
        const float sum2 = s_ll - 2.f * mean_l * s_l + cnt * mean_l * mean_l;
        const float sum3 = s_rr - 2.f * mean_r * s_r + cnt * mean_r * mean_r;
        const float prod = sum2 * sum3;
        const bool denom_ok = prod >= kWeps;
        const float q = sum1 / sqrtf(denom_ok ? prod : 1.f);
        ncc = (have && denom_ok) ? q : 0.f;
      }
      // peak iff ncc > thr (multiviewstereo.cpp:589); padded neighbours
      // never count
      float v = (ncc > thr) ? ncc : -INFINITY;
      if (!nbr_valid[n]) v = -INFINITY;
      m = fmaxf(m, v);
    }
    // Insert the label's candidate (m, cd) as mvs_topk_slab's stable sort
    // and drop-smallest does: r[j] = t[j+1] if t[j+1] <= m, else m if
    // t[j] <= m, else t[j], with t[K] = +inf.  Among equal nccs the later
    // (larger) depth lands after the existing entries; at K = 1 this is the
    // WTA's ">=".  A label without a peak carries the reference's (0, -1)
    // no-peak default as (-inf, -1); the WTA carry keeps the label's depth
    // there (the caller finalises it to -1 by the ncc).
    const float depth = depths[label0 + i];
    const float cd = (K == 1 || m > -INFINITY) ? depth : -1.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool here = top_n[j] <= m;
      float nn = here ? m : top_n[j];
      float nd = here ? cd : top_d[j];
      if (j + 1 < K && top_n[j + 1] <= m) {
        nn = top_n[j + 1];
        nd = top_d[j + 1];
      }
      top_n[j] = nn;
      top_d[j] = nd;
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    ncc_out[(size_t)j * HW + p] = top_n[j];
    depth_out[(size_t)j * HW + p] = top_d[j];
  }
}

template <int R, int K>
void launch(const float* depths, const float* coords, const float* gray_nbr,
            const float* gl, const uint8_t* lv, const float* weights,
            const uint8_t* nbr_valid, const uint8_t* center_valid,
            float* ncc_out, float* depth_out, int H, int W, int N, int hs,
            int ws, int label0, int n_labels, float thr,
            cudaStream_t stream) {
  const dim3 grid((H * W + kBlock - 1) / kBlock);
  mvs_sweep_kernel<R, K><<<grid, kBlock, 0, stream>>>(
      depths, coords, gray_nbr, gl, lv, weights, nbr_valid, center_valid,
      ncc_out, depth_out, H, W, N, hs, ws, label0, n_labels, thr);
}

}  // namespace

// depths [D] f32; coords [n_labels, N, 2, H, W] f32 for labels
// [label0, label0 + n_labels); gray_nbr [N, hs, ws] f32; gl/weights
// [S*S, H, W] f32; lv [S*S, H, W] bool; nbr_valid [N] bool; center_valid
// [H, W] bool or null (all valid; read only when n_topk == 1) -> ncc_out,
// depth_out
// [n_topk, H, W] f32, ascending.  Built for radius 2 (MultiViewConfig) and
// n_topk 1 (WTA) or 9 (MultiViewConfig.top_k).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mvs_sweep_launch(const float* depths, const float* coords,
                                const float* gray_nbr, const float* gl,
                                const uint8_t* lv, const float* weights,
                                const uint8_t* nbr_valid,
                                const uint8_t* center_valid, float* ncc_out,
                                float* depth_out, int H, int W, int N, int hs,
                                int ws, int label0, int n_labels, int radius,
                                int n_topk, float thr, cudaStream_t stream) {
  if (radius != 2) return (int)cudaErrorInvalidValue;
  switch (n_topk) {
    case 1:
      launch<2, 1>(depths, coords, gray_nbr, gl, lv, weights, nbr_valid,
                   center_valid, ncc_out, depth_out, H, W, N, hs, ws, label0,
                   n_labels, thr, stream);
      break;
    case 9:
      launch<2, 9>(depths, coords, gray_nbr, gl, lv, weights, nbr_valid,
                   center_valid, ncc_out, depth_out, H, W, N, hs, ws, label0,
                   n_labels, thr, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
