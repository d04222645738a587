// Nearest sampling of source maps at clamped, truncated coordinates, on
// Hopper.
//
// Replaces the TPU kernel stereoreconstruction_tpu/ops/pallas_sample.py
// (pallas_sample_nearest -> _sample_kernel).  Same function as its plain
// PyTorch version, ops/cuda_sample.py sample_nearest_plain: for every sample
// of map j, g = srcs[j][clip(trunc(y2), 0, hs-1), clip(trunc(x2), 0, ws-1)],
// returned as vals = g where g is finite, else 0, and finite = isfinite(g):
// the cross-checks' scattered depth[iy, ix] read (multiviewstereo.cpp:698,
// twoviewstereo.cpp:596-672).  A coordinate is made finite and clamped to
// [-1, n] before the truncation, so NaN, inf and huge values index inside
// the map (a float->int cast of them is undefined); the callers mask those
// samples (their `contains` test fails).
//
// Bound on the H100: no arithmetic to speak of; each sample reads its two
// coordinates (8 B) and writes 5 B, and the maps are read once: bytes.
//
// Design: the TPU kernel staged a bounded patch of the map per tile by DMA
// and selected values with one-hot matmuls (and so missed coordinates outside
// the patch: 8-40% of the cross-check's confirmations).  Here one thread
// reads one sample straight from the map through the read-only cache: no
// patch, so nothing is missed, and oob_frac is 0 by construction.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ int trunc_index(float x, int n) {
  const float c = isfinite(x) ? fminf(fmaxf(x, -1.f), (float)n) : -1.f;
  const int i = (int)truncf(c);
  return min(max(i, 0), n - 1);
}

__global__ void __launch_bounds__(kBlock)
sample_nearest_kernel(const float* __restrict__ srcs,
                      const float* __restrict__ x2,
                      const float* __restrict__ y2, float* __restrict__ vals,
                      uint8_t* __restrict__ finite, int n_samples, int HW,
                      int hs, int ws) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_samples) return;
  const int j = i / HW;
  const int ix = trunc_index(x2[i], ws);
  const int iy = trunc_index(y2[i], hs);
  const float g = __ldg(srcs + (size_t)j * hs * ws + (size_t)iy * ws + ix);
  const bool fin = isfinite(g);
  vals[i] = fin ? g : 0.f;
  finite[i] = fin;
}

}  // namespace

// srcs [V, hs, ws] f32; x2, y2 [V, H, W] f32 -> vals [V, H, W] f32,
// finite [V, H, W] bool.  Returns cudaGetLastError() after the launch.
extern "C" int sample_nearest_launch(const float* srcs, const float* x2,
                                     const float* y2, float* vals,
                                     uint8_t* finite, int V, int H, int W,
                                     int hs, int ws, cudaStream_t stream) {
  const int n = V * H * W;
  if (n == 0) return 0;
  const dim3 grid((n + kBlock - 1) / kBlock);
  sample_nearest_kernel<<<grid, kBlock, 0, stream>>>(srcs, x2, y2, vals,
                                                     finite, n, H * W, hs,
                                                     ws);
  return (int)cudaGetLastError();
}
