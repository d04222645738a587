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
//
// Radii: the design above is one template on r, built for r = 1 .. 7; any
// other radius >= 1 takes the run-time-radius instance below, whose window
// state lives in device memory (the output tensor) instead of shared
// memory.

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

template <int R>
int blocks_per_sm() {
  using T = Tile<R>;
  int n = 0;
  if (cudaFuncSetAttribute(geodesic_weights_kernel<R>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)T::kSmemBytes) != cudaSuccess)
    return 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n, geodesic_weights_kernel<R>, T::NT, T::kSmemBytes) ==
                 cudaSuccess
             ? n
             : 0;
}

// ---------------------------------------------------------------------------
// The run-time-radius instance (r >= 8, any radius).  At r = 8 the
// templates' window state would take 289 x 128 x 4 B = 148 KB of shared
// memory a block, and from r = 10 no longer fits at all, so this instance
// keeps no window in shared memory:
// - a first kernel writes the four edge planes (right, down, down-left,
//   down-right) of every pixel of the image padded by r on each side to a
//   scratch buffer [4, H + 2r, W + 2r] in device memory, which the caller
//   allocates (the wrapper, from PyTorch's allocator): 8192
//   where either end is off the image or invalid, else the colour
//   distance edge() computes in the templates, so each edge is the same
//   float;
// - the sweep keeps each thread's window state in the output tensor
//   itself, cell k of pixel p at out[k * H * W + p] ([cell][pixel]: a
//   warp's 32 pixels of one row read and write a cell coalesced), and
//   sweeps it in place, then turns it into weights.  A cell update reads
//   its state, the previous window row's value (written earlier in the
//   same sweep by the same thread) and four edges (L1/L2), and writes the
//   state back: 1 + 1 + 4 loads and a store a cell, 6 sweeps.  Nothing
//   bounds the radius but the output's size.
// The row update is the templates' (candidates from the previous row for
// dx in (-1, 0, 1), then the within-row chain), streamed along the row:
// the candidates of cell t read only the previous row, and its chain step
// only cell t-1's final value, so one pass computes both in that order.
// ---------------------------------------------------------------------------

constexpr int kRtBX = 32;                 // a warp: one pixel row
constexpr int kRtBY = 4;

// edges [4][PH][PW] of the image padded by R (PH = H + 2R, PW = W + 2R):
// for padded pixel (py, px), the edge to its right, down, down-left and
// down-right neighbour.
__global__ void __launch_bounds__(kRtBX * kRtBY)
geodesic_edges_kernel(const float* __restrict__ rgb,
                      const uint8_t* __restrict__ valid,
                      float* __restrict__ edges, int H, int W, int R) {
  const int PW = W + 2 * R, PH = H + 2 * R;
  const int px = blockIdx.x * kRtBX + threadIdx.x;
  const int py = blockIdx.y * kRtBY + threadIdx.y;
  if (px >= PW || py >= PH) return;
  const int gx = px - R, gy = py - R;
  auto pixel = [&](int yy, int xx) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const size_t q = (size_t)yy * W + xx;
      v = make_float4(rgb[3 * q], rgb[3 * q + 1], rgb[3 * q + 2],
                      (valid == nullptr || valid[q]) ? 1.f : 0.f);
    }
    return v;
  };
  const float4 a = pixel(gy, gx);
  const size_t plane = (size_t)PH * PW;
  const size_t i = (size_t)py * PW + px;
  edges[i] = edge(a, pixel(gy, gx + 1));
  edges[plane + i] = edge(a, pixel(gy + 1, gx));
  edges[2 * plane + i] = edge(a, pixel(gy + 1, gx - 1));
  edges[3 * plane + i] = edge(a, pixel(gy + 1, gx + 1));
}

// One min-plus sweep of a window of run-time size S over its state in
// device memory.  DY = -1 forward, +1 backward, as sweep<R, DY>.  st: cell
// 0 of this thread's pixel, cells `plane` apart; er .. edr: the padded edge
// planes, e0 the padded index of window pixel (0, 0), PW their row length.
template <int DY>
__device__ void sweep_rt(float* st, size_t plane, int S,
                         const float* __restrict__ er,
                         const float* __restrict__ ed,
                         const float* __restrict__ edl,
                         const float* __restrict__ edr, size_t e0,
                         int PW) {
  for (int i = 0; i < S; ++i) {
    const int s = DY < 0 ? i : S - 1 - i;
    float* row = st + (size_t)s * S * plane;
    const float* prow = i == 0 ? row : DY < 0 ? row - S * plane
                                              : row + S * plane;
    const size_t e = e0 + (size_t)s * PW;   // padded index of pixel (s, 0)
    if (DY < 0) {
      // previous row s - 1: the downward edges of its pixels
      const size_t q = e - PW;
      float p_lo = 0.f, p_mid = i > 0 ? prow[0] : 0.f, left = 0.f;
      for (int t = 0; t < S; ++t) {
        float c = row[t * plane];
        if (i > 0) {
          const float p_hi = t + 1 < S ? prow[(t + 1) * plane] : 0.f;
          if (t > 0) c = fminf(c, p_lo + edr[q + t - 1]);
          c = fminf(c, p_mid + ed[q + t]);
          if (t < S - 1) c = fminf(c, p_hi + edl[q + t + 1]);
          p_lo = p_mid;
          p_mid = p_hi;
        }
        if (t > 0) c = fminf(c, left + er[e + t - 1]);
        row[t * plane] = c;
        left = c;
      }
    } else {
      // previous row s + 1: this pixel's downward edges
      float p_hi = 0.f, p_mid = i > 0 ? prow[(S - 1) * plane] : 0.f,
            right = 0.f;
      for (int t = S - 1; t >= 0; --t) {
        float c = row[t * plane];
        if (i > 0) {
          const float p_lo = t > 0 ? prow[(t - 1) * plane] : 0.f;
          if (t > 0) c = fminf(c, p_lo + edl[e + t]);
          c = fminf(c, p_mid + ed[e + t]);
          if (t < S - 1) c = fminf(c, p_hi + edr[e + t]);
          p_hi = p_mid;
          p_mid = p_lo;
        }
        if (t < S - 1) c = fminf(c, right + er[e + t]);
        row[t * plane] = c;
        right = c;
      }
    }
  }
}

__global__ void __launch_bounds__(kRtBX * kRtBY)
geodesic_weights_rt_kernel(const float* __restrict__ edges,
                           float* __restrict__ out, int H, int W, int R,
                           int iters, float sigma) {
  const int x = blockIdx.x * kRtBX + threadIdx.x;
  const int y = blockIdx.y * kRtBY + threadIdx.y;
  if (x >= W || y >= H) return;
  const int S = 2 * R + 1;
  const int PW = W + 2 * R;
  const size_t eplane = (size_t)(H + 2 * R) * PW;
  const float* er = edges;
  const float* ed = er + eplane;
  const float* edl = ed + eplane;
  const float* edr = edl + eplane;

  const size_t plane = (size_t)H * W;
  float* st = out + (size_t)y * W + x;
  for (int k = 0; k < S * S; ++k) st[k * plane] = kClamp;
  st[(size_t)(R * S + R) * plane] = 0.f;
  // window pixel (0, 0) is image pixel (y - R, x - R): padded (y, x)
  const size_t e0 = (size_t)y * PW + x;
  for (int it = 0; it < iters; ++it) {
    sweep_rt<-1>(st, plane, S, er, ed, edl, edr, e0, PW);
    sweep_rt<1>(st, plane, S, er, ed, edl, edr, e0, PW);
  }
  for (int k = 0; k < S * S; ++k)
    st[k * plane] = expf(-st[k * plane] / sigma);
}

int launch_rt(const float* rgb, const uint8_t* valid, float* out,
              float* edges, int H, int W, int radius, int iters, float sigma,
              cudaStream_t stream) {
  const int PW = W + 2 * radius, PH = H + 2 * radius;
  const dim3 block(kRtBX, kRtBY);
  geodesic_edges_kernel<<<dim3((PW + kRtBX - 1) / kRtBX,
                               (PH + kRtBY - 1) / kRtBY),
                          block, 0, stream>>>(rgb, valid, edges, H, W,
                                              radius);
  geodesic_weights_rt_kernel<<<dim3((W + kRtBX - 1) / kRtBX,
                                    (H + kRtBY - 1) / kRtBY),
                               block, 0, stream>>>(edges, out, H, W, radius,
                                                   iters, sigma);
  return (int)cudaGetLastError();
}

}  // namespace

// The radii of the compile-time instances: 1 .. 7 (the window state takes
// (2r+1)^2 x 32 x BY x 4 B of dynamic shared memory: 71 KB a block at
// r = 5, 128 KB at r = 7).  Which instance a call takes is the caller's
// choice (ops/cuda_weights.py runtime_instance): these entry points launch
// or describe the instance they are told to, and refuse a compile-time
// instance the library does not have.
#define WEIGHTS_RADII(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7)

// rgb [H, W, 3] f32, valid [H, W] bool or null -> out [S*S, H, W] f32.
// edges null: the radius's compile-time instance; else the run-time
// instance, edges its scratch [4, H + 2r, W + 2r] f32.
// Returns cudaGetLastError() after the launch (0 on success), and
// cudaErrorInvalidValue for a radius below 1 or a compile-time instance
// the library does not have.
extern "C" int geodesic_weights_launch(const float* rgb, const uint8_t* valid,
                                       float* out, int H, int W, int radius,
                                       int iters, float sigma,
                                       cudaStream_t stream, float* edges) {
  if (radius < 1) return (int)cudaErrorInvalidValue;
  if (edges)
    return launch_rt(rgb, valid, out, edges, H, W, radius, iters, sigma,
                     stream);
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

// The dynamic shared memory a block of the radius's compile-time instance
// (rt = 0) or of the run-time instance (rt = 1, none) takes, in bytes; -1
// for a compile-time instance the library does not have.
extern "C" int geodesic_weights_smem_bytes(int radius, int rt) {
  if (rt) return 0;
  switch (radius) {
#define WEIGHTS_CASE(r) \
  case r:               \
    return (int)Tile<r>::kSmemBytes;
    WEIGHTS_RADII(WEIGHTS_CASE)
#undef WEIGHTS_CASE
    default:
      return -1;
  }
}

// The blocks of the sweep kernel of the radius's compile-time instance (rt
// = 0) or of the run-time instance (rt = 1) resident on one SM, as the
// runtime computes them for its threads and shared memory; 0 on an error
// or for a compile-time instance the library does not have.
extern "C" int geodesic_weights_blocks_per_sm(int radius, int rt) {
  if (rt) {
    int n = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &n, geodesic_weights_rt_kernel, kRtBX * kRtBY, 0) ==
                   cudaSuccess
               ? n
               : 0;
  }
  switch (radius) {
#define WEIGHTS_CASE(r) \
  case r:               \
    return blocks_per_sm<r>();
    WEIGHTS_RADII(WEIGHTS_CASE)
#undef WEIGHTS_CASE
    default:
      return 0;
  }
}
