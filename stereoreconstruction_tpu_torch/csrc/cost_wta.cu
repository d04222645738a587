// Two-view weighted-NCC cost + sequential WTA over all depths, on Hopper;
// or, in its volume mode, every depth's cost.
//
// Replaces the TPU kernel stereoreconstruction_tpu/ops/pallas_ncc.py
// (pallas_cost_wta -> _cost_kernel).  Same function as its plain PyTorch
// versions, ops/cuda_cost_wta.py cost_wta_plain (ops/ncc_fast.py
// fast_cost_plane + the WTA carry wta_scan) and cost_volume_plain
// (fast_cost_plane stacked over the labels, the MRF path's input): for every
// reference pixel and depth label, the (2r+1)^2-tap weighted NCC between the
// reference gray and the warped plane of the other view, taken in reference
// space (taps are shifts of the warped plane), turned into the two-view cost
// min(max_color_diff, 255 * (1 - |ncc|)) (NaN -> max_color_diff, bad_ret
// for empty windows, +inf where the pixel's own warp sample is invalid),
// then the reference's sequential WTA update (twoviewstereo.cpp:320-326):
// a label wins iff cost + 1e-10 < min; "second" is the previous minimum.
// The volume mode writes the cost of every (label, pixel) instead, masked
// pixels included (the MRF smooths across them).
//
// Taps are summed with s (rows) outer and t (columns) inner, the order of
// fast_cost_plane; a tap whose weight, left validity or warp validity fails
// is skipped (the plain version adds an exact 0 there); built with
// --fmad=false, so the float32 cost is bit-equal to the plain version's and
// the WTA picks agree.
//
// Bound on the H100 (384 x 512, D = 100 labels, r = 5): up to 2.4e9 tap
// evaluations of 12 float32 operations (2 products, 3 squares/cross
// products, 7 adds) plus a ~30-operation epilogue a (pixel, label): about
// 3e10 operations, ~0.45 ms at 67 TFLOP/s.  Bytes: the warped volume and
// its validity (98 MB) and the 121 weight planes (95 MB), read once:
// ~0.06 ms.  The bound is the operations.  The volume mode writes D x H x W
// float32 costs (79 MB, 0.02 ms) besides: still the operations.
//
// Design: the TPU kernel kept a row tile's 121 weight planes and its
// reference windows resident in VMEM across the whole depth sweep and
// streamed one warped slice per depth.  Here a block owns a 32 x 4 pixel
// tile, one thread a pixel: the tile's [121, 128] weights (62 KB) and its
// reference gray halo sit in shared memory for the whole sweep, each
// thread's left-tap bits (left validity & weight > 1e-10) in 4 registers,
// and the WTA carry (min, second, best) in registers.  The depth loop runs
// inside the kernel (the TPU's sequential grid axis): per depth the block
// stages the warped plane's halo tile and its validity into shared memory,
// then each thread sums its taps from there.  67 KB of shared memory a
// block at r = 5 (3 blocks, 12 warps an SM).  The volume mode is a template
// flag: the same arithmetic in the same tap order, so each cost is the one
// the WTA mode would compare, with one coalesced store a (label, pixel).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTW = 32;            // tile columns (one warp)
constexpr int kTH = 4;             // tile rows
constexpr int kThreads = kTW * kTH;

template <int R>
struct Tile {
  static constexpr int S = 2 * R + 1;
  static constexpr int T = S * S;
  static constexpr int HH = kTH + 2 * R;      // halo rows
  static constexpr int HW = kTW + 2 * R;      // halo columns
  static constexpr int NH = HH * HW;
  static constexpr size_t kSmem =
      (size_t)T * kThreads * sizeof(float) + 2 * NH * sizeof(float) + NH;
};

template <int R, bool kVolume>
__global__ void __launch_bounds__(kThreads)
cost_wta_kernel(const float* __restrict__ depths,
                const float* __restrict__ warped,
                const uint8_t* __restrict__ wvalid,
                const float* __restrict__ gray_ref,
                const uint8_t* __restrict__ left_valid,
                const float* __restrict__ weights,
                float* __restrict__ min_out, float* __restrict__ second_out,
                float* __restrict__ best_out, int H, int W, int D,
                float max_color_diff, float bad_ret) {
  using Tl = Tile<R>;
  constexpr int S = Tl::S, T = Tl::T, HW = Tl::HW, NH = Tl::NH;
  constexpr int NW = (T + 31) / 32;
  const float weps = (float)1e-10;

  extern __shared__ float smem[];
  float* w_s = smem;                         // [T][kThreads]
  float* g_s = w_s + T * kThreads;           // [HH][HW] reference gray
  float* r_s = g_s + NH;                     // [HH][HW] warped plane
  uint8_t* v_s = (uint8_t*)(r_s + NH);       // [HH][HW] its validity

  const int tid = threadIdx.x;
  const int tx = tid % kTW, ty = tid / kTW;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x < W && y < H;
  const int HWp = H * W;
  const int p = y * W + x;

  for (int i = tid; i < NH; i += kThreads) {
    const int hy = y0 - R + i / HW, hx = x0 - R + i % HW;
    const bool in = hy >= 0 && hy < H && hx >= 0 && hx < W;
    g_s[i] = in ? gray_ref[hy * W + hx] : 0.f;
  }
  uint32_t lmask[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) lmask[j] = 0u;
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const float wk = inside ? weights[(size_t)k * HWp + p] : 0.f;
    w_s[k * kThreads + tid] = wk;
    const int ly = y + k / S - R, lx = x + k % S - R;
    const bool lv = inside && ly >= 0 && ly < H && lx >= 0 && lx < W &&
                    left_valid[ly * W + lx] && wk > weps;
    if (lv) lmask[k >> 5] |= 1u << (k & 31);
  }

  float min_c = INFINITY, second = INFINITY, best = NAN;
  for (int d = 0; d < D; ++d) {
    __syncthreads();                         // the last plane is consumed
    const float* wp = warped + (size_t)d * HWp;
    const uint8_t* vp = wvalid + (size_t)d * HWp;
    for (int i = tid; i < NH; i += kThreads) {
      const int hy = y0 - R + i / HW, hx = x0 - R + i % HW;
      const bool in = hy >= 0 && hy < H && hx >= 0 && hx < W;
      r_s[i] = in ? wp[hy * W + hx] : 0.f;
      v_s[i] = in ? vp[hy * W + hx] : 0;
    }
    __syncthreads();
    if (!inside) continue;

    float cost = INFINITY;
    if (v_s[(ty + R) * HW + tx + R]) {
      float s_w = 0.f, s_l = 0.f, s_r = 0.f, s_ll = 0.f, s_rr = 0.f,
            s_lr = 0.f, n = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int t = 0; t < S; ++t) {
          const int k = s * S + t;
          const int h = (ty + s) * HW + tx + t;
          if (((lmask[k >> 5] >> (k & 31)) & 1u) && v_s[h]) {
            const float wk = w_s[k * kThreads + tid];
            const float wl = wk * g_s[h];
            const float wr = wk * r_s[h];
            s_w = s_w + wk;
            s_l = s_l + wl;
            s_r = s_r + wr;
            s_ll = s_ll + wl * wl;
            s_rr = s_rr + wr * wr;
            s_lr = s_lr + wl * wr;
            n = n + 1.f;
          }
        }
      }
      // ops/ncc.py ncc_from_sums, two-view mode, operation for operation
      const bool have = s_w > weps;
      const float s_w_safe = have ? s_w : 1.f;
      const float mean_l = s_l / s_w_safe;
      const float mean_r = s_r / s_w_safe;
      const float sum1 =
          s_lr - mean_l * s_r - mean_r * s_l + n * mean_l * mean_r;
      const float sum2 = s_ll - 2.f * mean_l * s_l + n * mean_l * mean_l;
      const float sum3 = s_rr - 2.f * mean_r * s_r + n * mean_r * mean_r;
      float v = 255.f * (1.f - fabsf(sum1) / sqrtf(sum2 * sum3));
      v = isnan(v) ? max_color_diff : (v < max_color_diff ? v : max_color_diff);
      cost = have ? v : bad_ret;
    }
    if (kVolume) {
      min_out[(size_t)d * HWp + p] = cost;
    } else if (cost + (float)1e-10 < min_c) {
      second = min_c;
      min_c = cost;
      best = depths[d];
    }
  }
  if (!kVolume && inside) {
    min_out[p] = min_c;
    second_out[p] = second;
    best_out[p] = best;
  }
}

template <int R, bool kVolume>
int launch(const float* depths, const float* warped, const uint8_t* wvalid,
           const float* gray_ref, const uint8_t* left_valid,
           const float* weights, float* min_out, float* second_out,
           float* best_out, int H, int W, int D, float max_color_diff,
           float bad_ret, cudaStream_t stream) {
  const size_t smem = Tile<R>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      cost_wta_kernel<R, kVolume>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH);
  cost_wta_kernel<R, kVolume><<<grid, kThreads, smem, stream>>>(
      depths, warped, wvalid, gray_ref, left_valid, weights, min_out,
      second_out, best_out, H, W, D, max_color_diff, bad_ret);
  return (int)cudaGetLastError();
}

}  // namespace

// depths [D] f32; warped [D, H, W] f32; wvalid [D, H, W] bool; gray_ref
// [H, W] f32; left_valid [H, W] bool (mask & sample() validity of the
// reference); weights [S*S, H, W] f32 -> min_cost, second, best [H, W] f32
// (inf, inf, NaN where no label won).
// Returns the CUDA error of the launch (0 on success).
extern "C" int cost_wta_launch(const float* depths, const float* warped,
                               const uint8_t* wvalid, const float* gray_ref,
                               const uint8_t* left_valid,
                               const float* weights, float* min_out,
                               float* second_out, float* best_out, int H,
                               int W, int D, int radius,
                               float max_color_diff, float bad_ret,
                               cudaStream_t stream) {
  // radius 5 is the two-view engine's (TwoViewConfig.window_radius)
  if (radius != 5) return (int)cudaErrorInvalidValue;
  return launch<5, false>(depths, warped, wvalid, gray_ref, left_valid,
                          weights, min_out, second_out, best_out, H, W, D,
                          max_color_diff, bad_ret, stream);
}

// warped [D, H, W] f32; wvalid [D, H, W] bool; gray_ref [H, W] f32;
// left_valid [H, W] bool; weights [S*S, H, W] f32 -> volume [D, H, W] f32:
// each label's cost (+inf where the pixel's own warp sample is invalid).
// Returns the CUDA error of the launch (0 on success).
extern "C" int cost_volume_launch(const float* warped, const uint8_t* wvalid,
                                  const float* gray_ref,
                                  const uint8_t* left_valid,
                                  const float* weights, float* volume, int H,
                                  int W, int D, int radius,
                                  float max_color_diff, float bad_ret,
                                  cudaStream_t stream) {
  if (radius != 5) return (int)cudaErrorInvalidValue;
  return launch<5, true>(nullptr, warped, wvalid, gray_ref, left_valid,
                         weights, volume, nullptr, nullptr, H, W, D,
                         max_color_diff, bad_ret, stream);
}
