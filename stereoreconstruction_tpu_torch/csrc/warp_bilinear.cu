// Bilinear warp of the other view (gray and mask) on Hopper.
//
// Replaces the TPU kernel stereoreconstruction_tpu/ops/pallas_warp.py
// (pallas_warp_bilinear -> _warp_kernel).  Same function as its plain
// PyTorch version, ops/warp.py warp_bilinear: for every depth label and
// reference pixel, the other view's gray and mask*255 sampled at the match
// coordinate (x2, y2) with
//   - the source values rounded to bfloat16 (__float2bfloat16_rn),
//   - the x weights max(0, 1 - |x - kx|) at kx = floor(x) and floor(x) + 1,
//     rounded to bfloat16; the two products are exact in float32 and one
//     rounded add sums them,
//   - the float32 y-lerp a0 * ty0 + a1 * ty1 with the unrounded triangle
//     weights of rows floor(y) and floor(y) + 1,
//   - VectorImage::sample validity (x >= 0, y >= 0, x + 1 < ws,
//     y + 1 < hs) and a warped mask > 254.
// The mask threshold is the delicate part: bf16(1 - fx) + bf16(fx) need not
// be 1, so next to a masked texel the warped mask*255 may land just above
// or below 254.  The kernel computes that float32 value with the same
// operations in the same order as the plain version (built with
// --fmad=false, so no product is fused into an add), and so rejects exactly
// the pixels the plain version rejects.
//
// Bound on the H100 (D = 100 labels, 384 x 512): the coordinate volume
// [D, 2, H, W] f32 (157 MB) is read once and the warped plane (f32) and
// validity (u8) are written once (98 MB): ~0.08 ms at 3.35 TB/s.  About 20
// float32 operations a sample make it byte-bound.
//
// Design: a grid-stride loop, one thread per (depth, pixel) sample, so a
// warp reads each coordinate plane coalesced; the four texels of both
// channels come straight from the source through the read-only cache (the
// 384 x 512 source stays in L2).  The TPU kernel DMA'd a patch of the source
// per (tile, depth) and skipped tiles outside the support-window-dilated
// mask ('relevant'); here nothing is staged, so no tap can fall outside a
// patch, and every sample is computed (the skipped values were never
// consumed, so 'relevant' is not needed).  oob_frac is the fraction of
// sample()-valid positions whose texels fell outside the source: counted,
// and 0 by construction.  Counts are summed in registers and reduced per
// block, one atomic per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxBlocks = 4096;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float tri(float d) {
  return fmaxf(1.f - fabsf(d), 0.f);
}

__global__ void __launch_bounds__(kBlock)
warp_bilinear_kernel(const float* __restrict__ coords,
                     const float* __restrict__ gray,
                     const uint8_t* __restrict__ mask,
                     float* __restrict__ warped,
                     uint8_t* __restrict__ wvalid,
                     unsigned long long* __restrict__ counts, int D, int HW,
                     int hs, int ws) {
  const long long total = (long long)D * HW;
  const float fws = (float)ws, fhs = (float)hs;
  unsigned n_samp = 0, n_oob = 0;
  for (long long i = (long long)blockIdx.x * kBlock + threadIdx.x; i < total;
       i += (long long)gridDim.x * kBlock) {
    const long long d = i / HW;
    const long long p = i - d * HW;
    const float x2 = __ldg(coords + 2 * d * HW + p);
    const float y2 = __ldg(coords + (2 * d + 1) * HW + p);
    float g = 0.f;
    bool ok = false;
    if (x2 >= 0.f && y2 >= 0.f && x2 + 1.f < fws && y2 + 1.f < fhs) {
      ++n_samp;
      // the clamp keeps the float->int cast defined; a no-op here
      const float ixf = floorf(fminf(x2, 1e6f));
      const float iyf = floorf(fminf(y2, 1e6f));
      const int ix = (int)ixf, iy = (int)iyf;
      if (ix + 1 < ws && iy + 1 < hs) {
        const float tx0 = bf16_round(tri(x2 - ixf));
        const float tx1 = bf16_round(tri(x2 - (ixf + 1.f)));
        const float ty0 = tri(y2 - iyf);
        const float ty1 = tri(y2 - (iyf + 1.f));
        const int r0 = iy * ws + ix, r1 = r0 + ws;
        const float g00 = bf16_round(__ldg(gray + r0));
        const float g01 = bf16_round(__ldg(gray + r0 + 1));
        const float g10 = bf16_round(__ldg(gray + r1));
        const float g11 = bf16_round(__ldg(gray + r1 + 1));
        // mask*255 is 0 or 255, both exact in bfloat16
        const float m00 = __ldg(mask + r0) ? 255.f : 0.f;
        const float m01 = __ldg(mask + r0 + 1) ? 255.f : 0.f;
        const float m10 = __ldg(mask + r1) ? 255.f : 0.f;
        const float m11 = __ldg(mask + r1 + 1) ? 255.f : 0.f;
        const float ga0 = g00 * tx0 + g01 * tx1;
        const float ga1 = g10 * tx0 + g11 * tx1;
        const float ma0 = m00 * tx0 + m01 * tx1;
        const float ma1 = m10 * tx0 + m11 * tx1;
        g = ga0 * ty0 + ga1 * ty1;
        ok = ma0 * ty0 + ma1 * ty1 > 254.f;
      } else {
        ++n_oob;
      }
    }
    warped[i] = g;
    wvalid[i] = ok ? 1 : 0;
  }

  __shared__ unsigned s_samp[kBlock / 32], s_oob[kBlock / 32];
  n_samp = __reduce_add_sync(0xffffffffu, n_samp);
  n_oob = __reduce_add_sync(0xffffffffu, n_oob);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
    s_samp[wid] = n_samp;
    s_oob[wid] = n_oob;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long a = 0, b = 0;
    for (int k = 0; k < kBlock / 32; ++k) {
      a += s_samp[k];
      b += s_oob[k];
    }
    if (a) atomicAdd(counts, a);
    if (b) atomicAdd(counts + 1, b);
  }
}

}  // namespace

// coords [D, 2, H, W] f32 (-3e6 where the match point is invalid);
// gray [hs, ws] f32; mask [hs, ws] bool -> warped [D, H, W] f32 (0 where the
// sample is invalid), wvalid [D, H, W] bool; counts [2] u64 (zeroed by the
// caller) += (sample()-valid positions, those outside the source).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int warp_bilinear_launch(const float* coords, const float* gray,
                                    const uint8_t* mask, float* warped,
                                    uint8_t* wvalid,
                                    unsigned long long* counts, int D, int HW,
                                    int hs, int ws, cudaStream_t stream) {
  const long long total = (long long)D * HW;
  long long blocks = (total + kBlock - 1) / kBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  warp_bilinear_kernel<<<(unsigned)blocks, kBlock, 0, stream>>>(
      coords, gray, mask, warped, wvalid, counts, D, HW, hs, ws);
  return (int)cudaGetLastError();
}
