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
// other radius >= 1 takes the run-time-radius instance below: up to r = 31
// its window state stays in shared memory, each window's rows dealt to two
// or four lanes; from r = 32 it lives in device memory (the output
// tensor).

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
// The run-time-radius instance (r >= 8, any radius): its device-memory
// path, which r >= 32 takes (below, the shared-memory path takes r = 8 ..
// 31).  From r = 32 a window's state (17 KB) with its edges no longer
// fits a block's shared memory even for 8 pixels, so this path keeps no
// window in shared memory:
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

// ---------------------------------------------------------------------------
// The run-time instance's shared-memory path (r = 8 .. 31).  The device-
// memory path above is bound by its own state's traffic: 6 sweeps read and
// write every cell of every window in device memory (~15x the output's
// bytes at r = 8), where the TPU kernel keeps a row tile's windows in VMEM
// for the whole sweep.  Here a window's state stays in shared memory for
// all six sweeps and reaches device memory once, as weights:
// - the edges kernel above writes the edge planes of the image padded by
//   r once (each edge is computed once, where per-block tiles would
//   compute them S x (NP + 2r) / NP times); a block, NP = 32 / L x
//   `warps` pixels of one image row, copies its tile of them to shared
//   memory as a float4 a tile pixel (right, down, down-left, down-right:
//   one 16-byte load brings every edge a backward cell takes) and the
//   right edges once more as a plane of their own (the forward chain's),
//   and keeps every window's S x S state in dynamic shared memory;
// - each pixel's window rows are dealt round robin to L lanes of its warp
//   (lane g the rows g, g + L, ...; a warp is 32 / L pixels x L lanes):
//   L = 4 gives a block of 32 pixels 4 warps even at r = 17, where its
//   state takes 157 KB and one block fits an SM; at r = 8, L = 2 (blocks
//   of 64 pixels, two an SM) wastes fewer steps on the skew below.  A
//   row's chain runs within its lane, in the reference's order;
// - a lane updates two cells of its row a step (a pair: the row's S cells
//   and a pad that stays +inf), so a step's fixed work (pointers, masks,
//   the loop) serves two cells, and the two cells' candidates are
//   independent work beside the chain;
// - the rows run skewed: row s starts `skew` = ceil((r + 2) / L) >= 3
//   steps after the row it reads (forward s - 1, backward s + 1), after a
//   pre-start step that loads the previous row's first pair, so a lane's
//   rows never overlap and a pair's candidates read cells of the previous
//   row written at least two steps earlier by another lane (visible after
//   that step's __syncwarp).  Each step loads the next step's operands
//   before it updates its own pair, so their latency hides behind the
//   update.  A lane keeps the previous row's pairs of its last two steps
//   (and, forward, their edges);  where a candidate or the chain does not
//   apply (the row's ends, no previous row, before the row's first pair)
//   its operand is +inf, so no step branches;
// - lane g's row s pair q lives at [warp][s / L][q][lane][2] (a
//   half-warp's 8-byte accesses on 32 banks); the 16-byte edge loads of a
//   step take 8 lanes of one row a phase, 128 contiguous bytes, and the
//   right-edge plane's rows, padded to EWr with EWr - 2 x skew = 32 / L
//   (mod 32), put a step's reads of its pixels on L consecutive rows on
//   32 banks.
// The block takes the most warps (4, 2, 1) whose state and edges fit
// 227 KB; from r = 32 none does (rt_config() gives 0 warps) and the
// device-memory path runs.  ops/cuda_weights.py rt_config mirrors the
// rule.
// ---------------------------------------------------------------------------

// The lanes a pixel's window rows are dealt to (the pixels a warp are 32
// / lanes): 2 where a block of 4 warps with 2 lanes takes at most half an
// SM's shared memory (two blocks an SM: r = 8), else 4.  Loads a step
// ahead need a skew of 3 steps or more: ceil((Q + 1) / lanes) with Q = r +
// 1 >= 9 pairs, so 4 lanes at most.
constexpr int kRtTwoLanes = 1;                   // 0: 4 lanes at every r
constexpr int kRtMaxWarps = 4;                   // warps a block, at most
// floats before the states and after the right-edge plane: a lane's loads
// on the steps around its rows reach up to 4 pairs past a row
constexpr int kRtGuard = 4 * 64;
constexpr size_t kRtMaxSmem = 232448;            // a block's smem on sm_90

// The shared-memory path's layout at (radius, warps a block), in floats
// from the start of the dynamic shared memory.
struct RtLayout {
  int S, Q, M, skew;    // window side, cell pairs a row, rows a lane,
                        // steps between rows
  int NP, ew, EWr;      // pixels a block; tile width; right plane's stride
  int F, Rp;            // the edge tile (float4) and the right-edge plane
  size_t bytes;
};

template <int L>
__host__ __device__ inline RtLayout rt_layout(int radius, int warps) {
  static_assert(L == 2 || L == 4, "2 or 4 lanes a pixel");
  constexpr int P = 32 / L;
  RtLayout l;
  l.S = 2 * radius + 1;
  l.Q = radius + 1;                    // S cells and a pad
  l.M = (l.S + L - 1) / L;
  // a row takes a pre-start step and Q steps
  l.skew = (l.Q + 1 + L - 1) / L;
  l.NP = warps * P;
  l.ew = l.NP + 2 * radius;
  l.EWr = l.ew + ((2 * l.skew + P - l.ew) % 32 + 32) % 32;
  l.F = kRtGuard + warps * l.M * l.Q * 64;
  l.Rp = l.F + 4 * l.S * l.ew;
  l.bytes = (size_t)(l.Rp + l.S * l.EWr + kRtGuard) * sizeof(float);
  return l;
}

// The shared-memory path at this radius: the lanes a pixel and the warps
// a block (the most of 4, 2, 1 whose state and edges fit 227 KB); warps
// 0: none fits, the device-memory path runs.
struct RtConfig {
  int lanes, warps;
};

RtConfig rt_config(int radius) {
  if (kRtTwoLanes &&
      rt_layout<2>(radius, kRtMaxWarps).bytes <= kRtMaxSmem / 2)
    return {2, kRtMaxWarps};
  for (int w = kRtMaxWarps; w >= 1; w /= 2)
    if (rt_layout<4>(radius, w).bytes <= kRtMaxSmem) return {4, w};
  return {4, 0};
}

// One min-plus sweep of the warp's windows, DY = -1 forward, +1 backward
// (as sweep<R, DY>), two cells a step.  sm2: the block's shared memory as
// cell pairs; st: the pair offset of the lane's slot of its warp's
// states; F, Rp: the edge tile and right-edge plane, window pixel (s, t)
// at s * ew + bp + t and s * EWr + bp + t; g: the lane's row slot.
template <int L, int DY>
__device__ __forceinline__ void sweep_lanes(float2* sm2, const float4* F,
                                            const float* Rp, int st, int S,
                                            int Q, int skew, int ew,
                                            int EWr, int g, int bp) {
  constexpr int P = 32 / L;
  constexpr int DS = DY < 0 ? L : -L;          // to the lane's next row
  constexpr int DQ = DY < 0 ? 1 : -1;          // to the row's next pair
  const float inf = __int_as_float(0x7f800000);
  const float2 inf2 = make_float2(inf, inf);
  const int period = skew * L;
  const int steps = skew * (S - 1) + Q;
  // the previous row's pair (forward s - 1, backward s + 1): the same
  // pixel's lane g - 1 (g + 1), a row slot back (on) where g wraps
  const int prev_off = DY < 0 ? (g > 0 ? -P : (L - 1) * P - Q * 32)
                              : (g < L - 1 ? P : Q * 32 - (L - 1) * P);
  const int s_first = DY < 0 ? g : g + L * ((S - 1 - g) / L);
  const int start = skew * (DY < 0 ? s_first : S - 1 - s_first);
  // The cursor: row s, and k, the steps since its pre-start step (the
  // step before its first pair, whose load brings the previous row's
  // first pair); its pairs are at k = 1 .. Q (forward pair k - 1, cells
  // 2k - 2 and 2k - 1; backward pair Q - k, cells 2(Q - k) + 1 and
  // 2(Q - k)), then idle steps.  Row s begins at step skew x m (m = s
  // forward, S - 1 - s backward), so the steps run in blocks of skew, and
  // only a block's first step moves the lanes of one row slot to their
  // next row: the other steps do not branch.  A row beginning after step 0
  // is preceded by a virtual row (no cell, no previous row).  set_row()
  // puts the cursor a step before row s's pre-start step (k = -1), its
  // pointers those of step k: the pair; the previous row's next pair
  // (forward k, backward Q - 1 - k); the edges (forward F(s - 1, 2k - 1)
  // and F(s - 1, 2k), backward F(s, 2(Q - k) + 1) and F(s, 2(Q - k)));
  // and forward the right edges (s, 2k - 3) and (s, 2k - 2).
  float2 *pu, *pp;
  const float* pr;
  const float4* pf;
  bool rv, hp;
  int k;
  auto set_row = [&](int row_s) {
    rv = (unsigned)row_s < (unsigned)S;
    hp = rv && (DY < 0 ? row_s > 0 : row_s < S - 1);
    const int sc = row_s < 0 ? 0 : row_s >= S ? S - 1 : row_s;
    const int row = st + (rv ? (row_s - g) / L * Q * 32 : 0);
    pu = sm2 + row + (DY < 0 ? -2 : Q + 1) * 32;
    pp = sm2 + (hp ? row + prev_off : row) + (DY < 0 ? -1 : Q) * 32;
    pf = F + (DY < 0 ? (sc - 1) * ew + bp - 3 : sc * ew + bp + 2 * Q + 2);
    pr = Rp + sc * EWr + bp - 5;
    k = -1;
  };
  auto advance = [&](int n) {
    pu += n * DQ * 32;
    pp += n * DQ * 32;
    pf += 2 * n * DQ;
    pr += 2 * n;
    k += n;
  };
  int s = start ? s_first - DS : s_first;
  set_row(s);
  advance(start ? period - start : 0);

  // a step's operands, loaded a step ahead: the pair, the previous row's
  // next pair (+inf where it takes no candidate), the edges, whether the
  // step updates a pair, and where
  struct Ops {
    float2 u, pn;
    float4 fa, fb;
    float er0, er1;
    float2* at;
    bool on, first, last;
  };
  auto load = [&](Ops& o) {
    o.u = *pu;
    o.pn = hp && k < Q ? *pp : inf2;
    o.fa = DY < 0 ? pf[0] : pf[1];
    o.fb = DY < 0 ? pf[1] : pf[0];
    o.er0 = DY < 0 ? pr[0] : 0.f;
    o.er1 = DY < 0 ? pr[1] : 0.f;
    o.at = pu;
    o.on = rv && k >= 1 && k <= Q;
    o.first = k == 1;
    o.last = k == Q;
  };
  Ops a;
  // the previous row's pairs of the last two steps, and forward the edges
  // of the cells before this step's; the chain
  float2 pa = inf2, pb = inf2;
  float e_w1 = 0.f, e_y0 = 0.f, e_w0 = 0.f;
  float carry = inf;
  auto update = [&]() {
    // each cell: the previous row's candidates for dx in (-1, 0, 1), then
    // the chain; the row's pad (cell S) stays +inf
    float v0, v1;
    if (DY < 0) {
      // cells 2i, 2i + 1 (i = k - 1): previous row's 2i - 1 .. 2i + 2
      v0 = fminf(a.u.x, pb.y + e_w1);
      v0 = fminf(v0, pa.x + e_y0);
      v0 = fminf(v0, pa.y + a.fa.z);
      v0 = fminf(v0, carry + a.er0);
      v1 = fminf(a.u.y, pa.x + e_w0);
      v1 = fminf(v1, pa.y + a.fa.y);
      v1 = fminf(v1, a.pn.x + a.fb.z);
      v1 = fminf(v1, v0 + a.er1);
      if (a.last) v1 = inf;
      if (a.on) *a.at = make_float2(v0, v1);
      carry = a.on ? v1 : inf;
      e_w1 = a.fa.w;
      e_y0 = a.fb.y;
      e_w0 = a.fb.w;
    } else {
      // cells 2p + 1, 2p (p = Q - k): previous row's 2p - 1 .. 2p + 2
      v0 = fminf(a.u.y, pa.x + a.fa.z);
      v0 = fminf(v0, pa.y + a.fa.y);
      v0 = fminf(v0, pb.x + a.fa.w);
      v0 = fminf(v0, carry + a.fa.x);
      if (a.first) v0 = inf;
      v1 = fminf(a.u.x, a.pn.y + a.fb.z);
      v1 = fminf(v1, pa.x + a.fb.y);
      v1 = fminf(v1, pa.y + a.fb.w);
      v1 = fminf(v1, v0 + a.fb.x);
      if (a.on) *a.at = make_float2(v1, v0);
      carry = a.on ? v1 : inf;
    }
    pb = pa;
    pa = a.pn;
  };

  advance(1);
  load(a);                                     // step -1
  int step = -1;
  for (int n = 0; step < steps; ++n) {
    // the lanes whose next row begins with this block (its first step
    // updates step skew x n - 2, loads step skew x n - 1: that row's
    // pre-start step)
    if (n > 0 && s + DS == (DY < 0 ? n : S - 1 - n)) {
      s += DS;
      set_row(s);
    }
    const int end = min(steps, skew * (n + 1) - 2);
#pragma unroll 2
    for (; step < end; ++step) {
      advance(1);
      Ops b;
      load(b);
      update();
      __syncwarp();
      a = b;
    }
  }
}

template <int L>
__global__ void __launch_bounds__(kRtMaxWarps * 32)
geodesic_weights_rt_smem_kernel(const float* __restrict__ edges,
                                float* __restrict__ out, int H, int W, int R,
                                int iters, float sigma, int warps) {
  constexpr int P = 32 / L;
  const RtLayout l = rt_layout<L>(R, warps);
  const int S = l.S, ew = l.ew;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float4* F = reinterpret_cast<float4*>(sm + l.F);
  float* Rp = sm + l.Rp;
  const int x0 = blockIdx.x * l.NP, y = blockIdx.y;
  const int tid = threadIdx.x, nt = warps * 32;

  // the block's edge tile, copied from the padded planes: window pixel
  // (s, t) of block pixel bp is padded pixel (y + s, x0 + bp + t); columns
  // past the padded image serve only lanes past the image's last column
  const int PW = W + 2 * R;
  const size_t plane = (size_t)(H + 2 * R) * PW;
#pragma unroll 4
  for (int i = tid; i < S * ew; i += nt) {
    const int ty = i / ew, tx = i % ew;
    float4 e = make_float4(kBrk, kBrk, kBrk, kBrk);
    if (x0 + tx < PW) {
      const float* q = edges + (size_t)(y + ty) * PW + x0 + tx;
      e = make_float4(q[0], q[plane], q[2 * plane], q[3 * plane]);
    }
    F[i] = e;
    Rp[ty * l.EWr + tx] = e.x;
  }
  __syncthreads();

  const int lane = tid & 31, wp = tid >> 5;
  const int g = lane / P;
  const int bp = wp * P + lane % P;
  const int x = x0 + bp;
  // lane g's row s = g + 4j, cells 2q and 2q + 1, at pair
  // [warp][j][q][lane]; cell S, the pad, +inf
  float2* sm2 = reinterpret_cast<float2*>(sm + kRtGuard);
  const int Q = l.Q;
  const int st = wp * l.M * Q * 32 + lane;
  for (int j = 0; j < l.M; ++j)
    for (int q = 0; q < Q; ++q) {
      const bool centre = g + L * j == R;
      sm2[st + (j * Q + q) * 32] = make_float2(
          centre && 2 * q == R ? 0.f : kClamp,
          2 * q + 1 == S ? __int_as_float(0x7f800000)
                         : centre && 2 * q + 1 == R ? 0.f : kClamp);
    }
  __syncwarp();
  // a lane past the image's last column sweeps the tile's zeros (its
  // result is not written), so that the warp steps together
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    sweep_lanes<L, -1>(sm2, F, Rp, st, S, Q, l.skew, ew, l.EWr, g, bp);
    sweep_lanes<L, 1>(sm2, F, Rp, st, S, Q, l.skew, ew, l.EWr, g, bp);
  }
  if (x >= W) return;
  // exp(-d x (1 / sigma)) where the plain version takes exp(-d / sigma):
  // the exponent within 2^-23 x 82 relative, a weight within 1e-7, and no
  // division (with its branch to a slow path) a weight
  const float scale = -1.f / sigma;
  const size_t hw = (size_t)H * W;
  float* o = out + (size_t)y * W + x;
  for (int j = 0; j < l.M && g + L * j < S; ++j) {
    const int s = g + L * j;
#pragma unroll 4
    for (int q = 0; q < Q; ++q) {
      const float2 d = sm2[st + (j * Q + q) * 32];
      o[(size_t)(s * S + 2 * q) * hw] = expf(d.x * scale);
      if (2 * q + 1 < S) o[(size_t)(s * S + 2 * q + 1) * hw] =
          expf(d.y * scale);
    }
  }
}

template <int L>
int set_rt_smem(const RtLayout& l) {
  cudaError_t err = cudaFuncSetAttribute(
      geodesic_weights_rt_smem_kernel<L>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(geodesic_weights_rt_smem_kernel<L>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return (int)err;
}

template <int L>
int launch_rt_smem(const float* rgb, const uint8_t* valid, float* out,
                   float* edges, int H, int W, int radius, int iters,
                   float sigma, int warps, cudaStream_t stream) {
  const RtLayout l = rt_layout<L>(radius, warps);
  const int err = set_rt_smem<L>(l);
  if (err != cudaSuccess) return err;
  const int PW = W + 2 * radius, PH = H + 2 * radius;
  geodesic_edges_kernel<<<dim3((PW + kRtBX - 1) / kRtBX,
                               (PH + kRtBY - 1) / kRtBY),
                          dim3(kRtBX, kRtBY), 0, stream>>>(rgb, valid, edges,
                                                           H, W, radius);
  geodesic_weights_rt_smem_kernel<L><<<dim3((W + l.NP - 1) / l.NP, H),
                                       warps * 32, l.bytes, stream>>>(
      edges, out, H, W, radius, iters, sigma, warps);
  return (int)cudaGetLastError();
}

template <int L>
int rt_smem_blocks_per_sm(int radius, int warps) {
  const RtLayout l = rt_layout<L>(radius, warps);
  int n = 0;
  return set_rt_smem<L>(l) == cudaSuccess &&
                 cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, geodesic_weights_rt_smem_kernel<L>, warps * 32,
                     l.bytes) == cudaSuccess
             ? n
             : 0;
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
// instance, edges its scratch [4, H + 2r, W + 2r] f32 (the padded edge
// planes): its shared-memory path where rt_config(radius) gives warps,
// else its device-memory path.
// Returns cudaGetLastError() after the launch (0 on success), and
// cudaErrorInvalidValue for a radius below 1 or a compile-time instance
// the library does not have.
extern "C" int geodesic_weights_launch(const float* rgb, const uint8_t* valid,
                                       float* out, int H, int W, int radius,
                                       int iters, float sigma,
                                       cudaStream_t stream, float* edges) {
  if (radius < 1) return (int)cudaErrorInvalidValue;
  if (edges) {
    const RtConfig c = rt_config(radius);
    if (c.warps && c.lanes == 2)
      return launch_rt_smem<2>(rgb, valid, out, edges, H, W, radius, iters,
                               sigma, c.warps, stream);
    if (c.warps)
      return launch_rt_smem<4>(rgb, valid, out, edges, H, W, radius, iters,
                               sigma, c.warps, stream);
    return launch_rt(rgb, valid, out, edges, H, W, radius, iters, sigma,
                     stream);
  }
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

// The warps a block of the run-time instance's shared-memory path at this
// radius (4, 2 or 1); 0 where it takes the device-memory path.
extern "C" int geodesic_weights_rt_warps(int radius) {
  return radius < 1 ? 0 : rt_config(radius).warps;
}

// The lanes a pixel of the run-time instance's shared-memory path at this
// radius (2 or 4).
extern "C" int geodesic_weights_rt_lanes(int radius) {
  return radius < 1 ? 0 : rt_config(radius).lanes;
}

// The dynamic shared memory a block of the radius's compile-time instance
// (rt = 0) or of the run-time instance (rt = 1; 0 on its device-memory
// path) takes, in bytes; -1 for a compile-time instance the library does
// not have.
extern "C" int geodesic_weights_smem_bytes(int radius, int rt) {
  if (rt) {
    const RtConfig c = radius < 1 ? RtConfig{4, 0} : rt_config(radius);
    if (!c.warps) return 0;
    return (int)(c.lanes == 2 ? rt_layout<2>(radius, c.warps)
                              : rt_layout<4>(radius, c.warps)).bytes;
  }
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
// = 0) or of the run-time instance (rt = 1, on the path the radius takes)
// resident on one SM, as the runtime computes them for its threads and
// shared memory; 0 on an error or for a compile-time instance the library
// does not have.
extern "C" int geodesic_weights_blocks_per_sm(int radius, int rt) {
  if (rt) {
    int n = 0;
    const RtConfig c = radius < 1 ? RtConfig{4, 0} : rt_config(radius);
    if (c.warps)
      return c.lanes == 2 ? rt_smem_blocks_per_sm<2>(radius, c.warps)
                          : rt_smem_blocks_per_sm<4>(radius, c.warps);
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
