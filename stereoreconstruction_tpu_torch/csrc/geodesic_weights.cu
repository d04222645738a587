// Geodesic support weights (Hosni et al. 2009) on Hopper.
//
// Replaces the TPU kernel stereoreconstruction_tpu/ops/pallas_weights.py
// (pallas_geodesic_weights -> _weights_kernel).  Same function as its plain
// PyTorch version, ops/weights.py geodesic_weights(exact=False): for every
// centre pixel, 3 rounds of forward then backward min-plus raster sweeps over
// its S x S window on 8-neighbour RGB distances, distances clamped at 4096,
// chains broken (cost 8192) at invalid pixels, weight exp(-d / sigma).
//
// Bound on the H100 (384 x 512): the function reads the RGB image (2.4 MB)
// and writes S^2 weight planes (19.7 MB at radius 2, 95 MB at radius 5):
// 6.6 us and 29 us at 3.35 TB/s.  Its min-plus sweep is ~2 float32
// operations a candidate, ~1e3 a pixel at radius 2 and ~9e3 at radius 5:
// 3 us and 27 us at 67 TFLOP/s.  The bound is the bytes.
//
// Design: one thread per centre pixel, a block a 32 x BY pixel tile.
// 1. The block stages its RGB tile plus a halo of R (and the validity
//    plane) in shared memory, and computes every edge distance among the
//    tile's pixels once: for each pixel, to its right, down-left, down and
//    down-right neighbours (four planes).  A window reads an upward or
//    leftward edge as its neighbour's downward or rightward one:
//    (b - a)^2 == (a - b)^2 exactly, so each is the distance the reference
//    computes.  An edge touching an invalid (or off-image) pixel is 8192.
// 2. Each thread's S x S window state lives in dynamic shared memory, laid
//    out [cell][thread] so that a warp's accesses hit 32 distinct banks (at
//    radius 5, 121 cells x 128 threads = 62 KB: in registers it spilled).
//    The sweep walks the window rows at run time, with only the row being
//    updated and the previous row in registers, so the code is one row
//    update per direction whatever the radius.
// Device memory sees each input once and each weight once; the sweep's
// traffic is shared-memory loads (a cell's update reads its state and four
// edges), which bound the kernel on the card.
//
// The row update keeps the reference's order (pallas_weights.py row_update
// == weights.py fwd_row/bwd_row): candidates from the previous window row
// for dx in (-1, 0, 1), then the within-row chain (toward +t forward, -t
// backward).  The reference also keeps an invalid window pixel's old value
// (its validity selects); here that needs no test: every state value is at
// most 4096 (the initial clamp; updates only take minima) and every edge of
// an invalid pixel is 8192, so no candidate or chain step can lower it, and
// no chain passes through it.  Built with --fmad=false: every sum rounds as
// in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kClamp = 4096.0f;   // weights below exp(-80) are zero
constexpr float kBrk = 8192.0f;     // "no edge": breaks min-plus chains

template <int R>
struct Tile {
  static constexpr int S = 2 * R + 1;
  static constexpr int BX = 32;                  // a warp: one pixel row
  static constexpr int BY = R <= 2 ? 8 : 4;
  static constexpr int NT = BX * BY;             // threads (centre pixels)
  static constexpr int EW = BX + 2 * R;          // tile with its halo
  static constexpr int EH = BY + 2 * R;
  static constexpr int NE = EW * EH;             // entries of one edge plane
  static constexpr int kEdgeFloats = 4 * NE;
  static constexpr int kStateFloats = S * S * NT;
  static constexpr size_t kSmemBytes =
      (size_t)(kEdgeFloats + kStateFloats) * sizeof(float);
  // the RGB tile is staged where the state will be
  static_assert(NE * sizeof(float4) <= kStateFloats * sizeof(float),
                "RGB tile must fit in the state's space");
};

// Colour distance between two tile pixels (r, g, b, validity); kBrk unless
// both are valid.
__device__ __forceinline__ float edge(float4 a, float4 b) {
  if (!(a.w > 0.5f && b.w > 0.5f)) return kBrk;
  const float d0 = b.x - a.x, d1 = b.y - a.y, d2 = b.z - a.z;
  float acc = d0 * d0;
  acc = acc + d1 * d1;
  acc = acc + d2 * d2;
  return fminf(sqrtf(acc), kBrk);
}

// One min-plus sweep over this thread's window.  DY = -1 forward (rows
// 0 .. S-1, previous row s-1, chain toward +t), DY = +1 backward (rows
// S-1 .. 0, previous row s+1, chain toward -t).  st: this thread's cell 0;
// e0: the tile index of its window pixel (0, 0); er, ed, edl, edr: the
// edge planes (right, down, down-left, down-right).
template <int R, int DY>
__device__ __forceinline__ void sweep(float* st, const float* er,
                                      const float* ed, const float* edl,
                                      const float* edr, int e0) {
  constexpr int S = Tile<R>::S;
  constexpr int NT = Tile<R>::NT;
  constexpr int EW = Tile<R>::EW;
  float prev[S];
#pragma unroll 1
  for (int i = 0; i < S; ++i) {
    const int s = DY < 0 ? i : S - 1 - i;
    float* row = st + s * S * NT;
    const int e = e0 + s * EW;              // tile index of pixel (s, 0)
    float u[S];
#pragma unroll
    for (int t = 0; t < S; ++t) u[t] = row[t * NT];
    if (i > 0) {
#pragma unroll
      for (int t = 0; t < S; ++t) {
        float c = u[t];
        if (DY < 0) {
          // previous row s - 1: the downward edges of its pixels
          const int q = e - EW + t;         // tile index of pixel (s-1, t)
          if (t > 0) c = fminf(c, prev[t - 1] + edr[q - 1]);
          c = fminf(c, prev[t] + ed[q]);
          if (t < S - 1) c = fminf(c, prev[t + 1] + edl[q + 1]);
        } else {
          // previous row s + 1: this pixel's downward edges
          if (t > 0) c = fminf(c, prev[t - 1] + edl[e + t]);
          c = fminf(c, prev[t] + ed[e + t]);
          if (t < S - 1) c = fminf(c, prev[t + 1] + edr[e + t]);
        }
        u[t] = c;
      }
    }
    if (DY < 0) {
#pragma unroll
      for (int t = 1; t < S; ++t) u[t] = fminf(u[t], u[t - 1] + er[e + t - 1]);
    } else {
#pragma unroll
      for (int t = S - 2; t >= 0; --t) u[t] = fminf(u[t], u[t + 1] + er[e + t]);
    }
#pragma unroll
    for (int t = 0; t < S; ++t) {
      row[t * NT] = u[t];
      prev[t] = u[t];
    }
  }
}

template <int R>
__global__ void __launch_bounds__(Tile<R>::NT)
geodesic_weights_kernel(const float* __restrict__ rgb,
                        const uint8_t* __restrict__ valid,
                        float* __restrict__ out, int H, int W, int iters,
                        float sigma) {
  using T = Tile<R>;
  constexpr int S = T::S;
  constexpr int NT = T::NT;
  constexpr int EW = T::EW;
  constexpr int EH = T::EH;
  constexpr int NE = T::NE;
  extern __shared__ float4 smem4[];
  float* er = reinterpret_cast<float*>(smem4);
  float* ed = er + NE;
  float* edl = ed + NE;
  float* edr = edl + NE;
  float* state = er + T::kEdgeFloats;
  float4* tile = reinterpret_cast<float4*>(state);   // until the sweep

  const int tid = threadIdx.y * T::BX + threadIdx.x;
  const int gx0 = blockIdx.x * T::BX - R;
  const int gy0 = blockIdx.y * T::BY - R;
  for (int i = tid; i < NE; i += NT) {
    const int gy = gy0 + i / EW, gx = gx0 + i % EW;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t p = (size_t)gy * W + gx;
      v = make_float4(rgb[3 * p], rgb[3 * p + 1], rgb[3 * p + 2],
                      (valid == nullptr || valid[p]) ? 1.f : 0.f);
    }
    tile[i] = v;
  }
  __syncthreads();
  // Edges past the tile's last row or column join no two window pixels.
  for (int i = tid; i < NE; i += NT) {
    const int ty = i / EW, tx = i % EW;
    const float4 a = tile[i];
    const bool down = ty + 1 < EH;
    er[i] = tx + 1 < EW ? edge(a, tile[i + 1]) : kBrk;
    ed[i] = down ? edge(a, tile[i + EW]) : kBrk;
    edl[i] = down && tx > 0 ? edge(a, tile[i + EW - 1]) : kBrk;
    edr[i] = down && tx + 1 < EW ? edge(a, tile[i + EW + 1]) : kBrk;
  }
  __syncthreads();

  const int x = blockIdx.x * T::BX + threadIdx.x;
  const int y = blockIdx.y * T::BY + threadIdx.y;
  if (x >= W || y >= H) return;

  float* st = state + tid;
#pragma unroll
  for (int k = 0; k < S * S; ++k) st[k * NT] = kClamp;
  st[(R * S + R) * NT] = 0.f;
  const int e0 = threadIdx.y * EW + threadIdx.x;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    sweep<R, -1>(st, er, ed, edl, edr, e0);
    sweep<R, 1>(st, er, ed, edl, edr, e0);
  }

  const size_t plane = (size_t)H * W;
  const size_t p = (size_t)y * W + x;
#pragma unroll 5
  for (int k = 0; k < S * S; ++k)
    out[k * plane + p] = expf(-st[k * NT] / sigma);
}

template <int R>
int launch(const float* rgb, const uint8_t* valid, float* out, int H, int W,
           int iters, float sigma, cudaStream_t stream) {
  using T = Tile<R>;
  cudaError_t err = cudaFuncSetAttribute(
      geodesic_weights_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(geodesic_weights_kernel<R>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(T::BX, T::BY);
  const dim3 grid((W + T::BX - 1) / T::BX, (H + T::BY - 1) / T::BY);
  geodesic_weights_kernel<R><<<grid, block, T::kSmemBytes, stream>>>(
      rgb, valid, out, H, W, iters, sigma);
  return (int)cudaGetLastError();
}

}  // namespace

// The radii the library is built for: 1 .. 7 (the window state takes
// (2r+1)^2 x 32 x BY x 4 B of dynamic shared memory: 71 KB a block at
// r = 5, 128 KB at r = 7).
#define WEIGHTS_RADII(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7)

// rgb [H, W, 3] f32, valid [H, W] bool or null -> out [S*S, H, W] f32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int geodesic_weights_launch(const float* rgb, const uint8_t* valid,
                                       float* out, int H, int W, int radius,
                                       int iters, float sigma,
                                       cudaStream_t stream) {
  switch (radius) {
#define WEIGHTS_CASE(r) \
  case r:               \
    return launch<r>(rgb, valid, out, H, W, iters, sigma, stream);
    WEIGHTS_RADII(WEIGHTS_CASE)
#undef WEIGHTS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory a block of the radius's kernel takes, in bytes
// (0 for a radius the library is not built for).
extern "C" int geodesic_weights_smem_bytes(int radius) {
  switch (radius) {
#define WEIGHTS_CASE(r) \
  case r:               \
    return (int)Tile<r>::kSmemBytes;
    WEIGHTS_RADII(WEIGHTS_CASE)
#undef WEIGHTS_CASE
    default:
      return 0;
  }
}
