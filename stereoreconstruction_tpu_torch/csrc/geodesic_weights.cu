// Geodesic support weights (Hosni et al. 2009) on Hopper.
//
// Replaces the TPU kernel stereoreconstruction_tpu/ops/pallas_weights.py
// (pallas_geodesic_weights -> _weights_kernel).  Same function as its plain
// PyTorch version, ops/weights.py geodesic_weights(exact=False): for every
// centre pixel, 3 rounds of forward then backward min-plus raster sweeps over
// its S x S window on 8-neighbour RGB distances, distances clamped at 4096,
// chains broken (cost 8192) at invalid pixels, weight exp(-d / sigma).
//
// Bound on the H100 (384 x 512, radius 2): the function reads the RGB image
// (2.4 MB) and writes S^2 = 25 weight planes (19.7 MB): ~22 MB, 6.6 us at
// 3.35 TB/s.  Its min-plus sweep is ~1e3 float32 operations a pixel,
// ~2e8 in all, 3 us at 67 TFLOP/s: the bound is the bytes.
//
// Design: one thread per centre pixel.  A 32 x 8 block stages its RGB tile
// plus a halo of radius+1 (and the validity plane) in shared memory; each
// thread keeps its S^2 window state in registers and computes the 8
// directional colour distances on the fly from shared memory (the TPU
// kernel's pre-rolled distance planes were a lane-shift workaround).  The
// state never leaves the SM, so device memory sees each input once and each
// weight once.  Recomputing a distance per use costs ~4x the sweep's
// operations, still far under the time the writes take.  At radius 5 the
// 121-float state spills to local memory; the radius-5 (two-view) path does
// not depend on this kernel yet.
//
// The row update keeps the reference's order exactly (pallas_weights.py
// row_update == weights.py fwd_row/bwd_row): candidates from the previous
// window row for dx in (-1, 0, 1), the validity select, the within-row chain
// (toward +t forward, -t backward), the validity select again.  Built with
// --fmad=false: every sum rounds as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kClamp = 4096.0f;   // weights below exp(-80) are zero
constexpr float kBrk = 8192.0f;     // "no edge": breaks min-plus chains
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <int R>
struct Window {
  static constexpr int S = 2 * R + 1;
  static constexpr int HALO = R + 1;
  static constexpr int TW = kBlockX + 2 * HALO;
  static constexpr int TH = kBlockY + 2 * HALO;
};

// Colour distance between window pixel (s, t) of this thread's centre and
// its (dx, dy) neighbour; kBrk unless both pixels are valid.
template <int R>
__device__ __forceinline__ float edge(float4 (*tile)[Window<R>::TW],
                                      int s, int t, int dx, int dy) {
  const int ty = threadIdx.y + Window<R>::HALO + s - R;
  const int tx = threadIdx.x + Window<R>::HALO + t - R;
  const float4 a = tile[ty][tx];
  const float4 b = tile[ty + dy][tx + dx];
  if (!(a.w > 0.5f && b.w > 0.5f)) return kBrk;
  const float d0 = b.x - a.x, d1 = b.y - a.y, d2 = b.z - a.z;
  float acc = d0 * d0;
  acc = acc + d1 * d1;
  acc = acc + d2 * d2;
  return fminf(sqrtf(acc), kBrk);
}

template <int R>
__device__ __forceinline__ bool pixel_valid(
    float4 (*tile)[Window<R>::TW], int s, int t) {
  return tile[threadIdx.y + Window<R>::HALO + s - R]
             [threadIdx.x + Window<R>::HALO + t - R].w > 0.5f;
}

// One sweep row update of window row s; DY = -1 forward (previous row s-1,
// chain toward +t), DY = +1 backward (previous row s+1, chain toward -t).
template <int R, int DY>
__device__ __forceinline__ void row_update(
    float (&st)[Window<R>::S][Window<R>::S],
    float4 (*tile)[Window<R>::TW], int s) {
  constexpr int S = Window<R>::S;
  const bool has_prev = (DY == -1) ? (s > 0) : (s < S - 1);
  float u[S];
#pragma unroll
  for (int t = 0; t < S; ++t) {
    float c = st[s][t];
    if (has_prev) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int tn = t + dx;
        if (tn >= 0 && tn < S) {
          c = fminf(c, st[s + DY][tn] + edge<R>(tile, s, t, dx, DY));
        }
      }
    }
    u[t] = pixel_valid<R>(tile, s, t) ? c : st[s][t];
  }
  float v[S];
#pragma unroll
  for (int t = 0; t < S; ++t) v[t] = u[t];
  if (DY == -1) {
#pragma unroll
    for (int t = 1; t < S; ++t)
      v[t] = fminf(v[t], v[t - 1] + edge<R>(tile, s, t, -1, 0));
  } else {
#pragma unroll
    for (int t = S - 2; t >= 0; --t)
      v[t] = fminf(v[t], v[t + 1] + edge<R>(tile, s, t, 1, 0));
  }
#pragma unroll
  for (int t = 0; t < S; ++t)
    st[s][t] = pixel_valid<R>(tile, s, t) ? v[t] : u[t];
}

template <int R>
__global__ void __launch_bounds__(kBlockX * kBlockY)
geodesic_weights_kernel(const float* __restrict__ rgb,
                        const uint8_t* __restrict__ valid,
                        float* __restrict__ out, int H, int W, int iters,
                        float sigma) {
  constexpr int S = Window<R>::S;
  constexpr int HALO = Window<R>::HALO;
  constexpr int TW = Window<R>::TW;
  constexpr int TH = Window<R>::TH;
  __shared__ float4 tile[TH][TW];   // r, g, b, validity

  const int gx0 = blockIdx.x * kBlockX - HALO;
  const int gy0 = blockIdx.y * kBlockY - HALO;
  for (int i = threadIdx.y * kBlockX + threadIdx.x; i < TH * TW;
       i += kBlockX * kBlockY) {
    const int ty = i / TW, tx = i % TW;
    const int gy = gy0 + ty, gx = gx0 + tx;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t p = (size_t)gy * W + gx;
      v = make_float4(rgb[3 * p], rgb[3 * p + 1], rgb[3 * p + 2],
                      (valid == nullptr || valid[p]) ? 1.f : 0.f);
    }
    tile[ty][tx] = v;
  }
  __syncthreads();

  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= W || y >= H) return;

  float st[S][S];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int t = 0; t < S; ++t) st[s][t] = kClamp;
  st[R][R] = 0.f;

#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < S; ++s) row_update<R, -1>(st, tile, s);
#pragma unroll
    for (int s = S - 1; s >= 0; --s) row_update<R, 1>(st, tile, s);
  }

  const size_t plane = (size_t)H * W;
  const size_t p = (size_t)y * W + x;
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int t = 0; t < S; ++t)
      out[(s * S + t) * plane + p] = expf(-st[s][t] / sigma);
}

}  // namespace

// rgb [H, W, 3] f32, valid [H, W] bool or null -> out [S*S, H, W] f32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int geodesic_weights_launch(const float* rgb, const uint8_t* valid,
                                       float* out, int H, int W, int radius,
                                       int iters, float sigma,
                                       cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  switch (radius) {
    case 2:
      geodesic_weights_kernel<2><<<grid, block, 0, stream>>>(
          rgb, valid, out, H, W, iters, sigma);
      break;
    case 5:
      geodesic_weights_kernel<5><<<grid, block, 0, stream>>>(
          rgb, valid, out, H, W, iters, sigma);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
