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
// Bound on the H100 (384 x 512, D = 100 labels, r = 5): the inputs are read
// once in ~0.06 ms (the warped volume and its validity, 98 MB, and the 121
// weight planes, 95 MB; the volume mode also writes 79 MB of costs).  The
// arithmetic bounds it: ~1.7e9 evaluated (pixel, label, tap) triples, most
// of them 6 float32 operations in the form below (3 products, 3 adds),
// ~1.2e10 a view with the rest.  Built with --fmad=false, every operation
// is an instruction: at the card's 33.5e12 float32 instructions a second
// (half its 67 TFLOP/s, which counts an FMA as two) that is ~0.35 ms, and
// the kernel issues more than that (taps outside the left mask, the shared
// loads, the validity pre-pass, the NCC epilogue's IEEE divisions).
//
// Tensor cores do not apply: each pixel has its own 121-weight vector, so
// the sums are per-pixel weighted dot products with no operand shared
// across pixels, and bit-equality fixes the order (and rounding) of every
// sum.  wgmma and mma need both a shared operand and a free order.
//
// Design.  The TPU kernel kept a row tile's weights and reference windows
// in VMEM for the whole depth sweep and streamed one warped slice a depth.
// Here a block of four warps owns a 32 x 4 pixel tile, one thread a pixel,
// and walks the labels in chunks of kL = 4:
// - shared memory holds, for the whole sweep, the tile's 121 weight planes
//   ([tap][thread], 62 KB; a tap outside the pixel's left mask, left
//   validity & weight > 1e-10, is stored as -0.0, so that its sign is the
//   mask bit and its products add exact zeros) and the reference gray
//   halo; and, for the current chunk, the warped halo with the chunk's four
//   labels in one 16-byte cell (one load a tap for all four) and the
//   validity, one 32-bit word a cell (bit l = label l of the chunk; one
//   load a tap for all labels).  76,064 B a block: 3 blocks, 12 warps, an
//   SM, with the largest shared-memory carveout asked for.
// - staging: cp.async copies of 4 bytes (the halo starts at any column, and
//   a 61 x 83 image's 332-byte rows rule out TMA's 16-byte strides; outside
//   the image and past D they zero-fill), validity bytes packed into words,
//   a barrier.  Not double-buffered: with 3 blocks an SM the others cover a
//   block's staging, and the prefetch's registers and shared memory cost
//   more than it saved (kernel_variants.py's ablation).
// - the label-independent sums (weights, left values, their squares, the
//   count) over the left mask are computed once a pixel, in tap order.  A
//   pre-pass ANDs the chunk's validity words over the left-mask taps: a
//   (pixel, label) whose left-mask taps all have a valid warp sample sums,
//   in the plain version, exactly those terms in that order.  If every
//   label of every lane of a warp passes (most warps), the warp sums only
//   the right value, its square and the cross product, 6 operations a tap
//   and label, taps outside the left mask adding exact zeros.  Otherwise
//   the whole warp sums all seven sums of every label, a failing tap taking
//   weight +0 so that everything it adds is an exact 0, with no branch.
//   Taps run outside and labels inside, each label's sums in tap order
//   (rows outer, columns inner), so every sum is the plain version's.
// - the epilogue is ops/ncc.py ncc_from_sums operation for operation; the
//   WTA carry walks the chunk's costs in label order (labels past D never
//   enter it); the volume mode stores each label's costs coalesced.  Built
//   with --fmad=false, the float32 costs, and so the picks, are the plain
//   version's bit for bit.
//
// Radii: the kernel is one template on r, built for r = 1 .. 7.  The
// weight planes take (2r+1)^2 x 128 x 4 B of a block's shared memory (62 KB
// at r = 5, 115 KB at r = 7: 135 KB a block with the halos, so one block an
// SM there); cost_wta_smem_bytes and cost_wta_blocks_per_sm report both for
// each r.  Any other radius >= 1 takes the run-time-radius instance below,
// which reads its weights from device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTW = 32;            // tile columns (a warp)
constexpr int kTH = 4;             // tile rows
constexpr int kThreads = kTW * kTH;
// the shared-memory stride of a halo row up to r = 5 (>= kTW + 2r; a warp
// narrower than 32 columns needs one that puts its rows on distinct
// banks); a wider halo takes its own width
constexpr int kHS = 42;
constexpr int kL = 4;              // labels a chunk
constexpr int kLP = kL % 4 == 0 ? 4 : 1;   // labels a warped-halo cell
constexpr int kNP = kL / kLP;              // warped-halo planes a chunk
constexpr int kFullGroup = kLP;            // labels a sweep of the full pass
// design switches; kernel_variants.py times the other setting of each
constexpr bool kDoubleBuffer = false;
constexpr bool kPackedValidity = true;
constexpr bool kHoist = true;
constexpr float kWeps = 1e-10f;
static_assert(kL <= 32, "a chunk's validity bits fill one word");

template <int R>
struct Tile {
  static constexpr int S = 2 * R + 1;
  static constexpr int T = S * S;
  static constexpr int HH = kTH + 2 * R;      // halo rows
  static constexpr int HW = kTW + 2 * R;      // halo columns
  static constexpr int HS = kHS >= HW ? kHS : HW;   // their stride
  static_assert(HS >= HW, "a halo row fits its stride");
  static constexpr int NC = HH * HW;          // halo cells
  static constexpr int NH = (HH - 1) * HS + HW;   // their shared-memory span
  static constexpr int kCells = (NC + kThreads - 1) / kThreads;
  // 32-bit words of shared memory: weights, gray halo, and a buffer's
  // warped halo and validity
  static constexpr int kW = T * kThreads;
  static constexpr int kG = (NH + 3) / 4 * 4;   // the warped halo 16 B aligned
  static constexpr int kRBuf = NH * kL;
  static constexpr int kVBuf = kPackedValidity ? NH : (NH * kL + 3) / 4;
  static constexpr int kBufs = kDoubleBuffer ? 2 : 1;
  static_assert(kLP != 4 || ((kW + kG) % 4 == 0 && kRBuf % 4 == 0),
                "the warped halos' float4 loads are aligned");
  static constexpr size_t kSmem =
      (size_t)(kW + kG + kBufs * (kRBuf + kVBuf)) * sizeof(float);
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool copy) {
  // copies 4 bytes, or zero-fills them when !copy (src is then not read)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(copy ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the validity bits of halo cell h: bit l = label l of the chunk
template <int NH>
__device__ __forceinline__ uint32_t valid_word(const uint32_t* v, int h) {
  if constexpr (kPackedValidity) {
    return v[h];
  } else {
    const uint8_t* b = reinterpret_cast<const uint8_t*>(v);
    uint32_t word = 0u;
#pragma unroll
    for (int l = 0; l < kL; ++l) word |= (uint32_t)b[l * NH + h] << l;
    return word;
  }
}

// the warped values of labels l0 .. l0 + n - 1 of the chunk at halo cell h
// (l0 and n multiples of kLP)
template <int NH, int n>
__device__ __forceinline__ void load_r_group(const float* rb, int h, int l0,
                                             float (&r)[n]) {
  if constexpr (kLP == 4) {
#pragma unroll
    for (int p = 0; p < n / 4; ++p) {
      const float4 q =
          reinterpret_cast<const float4*>(rb + (l0 / 4 + p) * NH * 4)[h];
      r[4 * p] = q.x;
      r[4 * p + 1] = q.y;
      r[4 * p + 2] = q.z;
      r[4 * p + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < n; ++j) r[j] = rb[(l0 + j) * NH + h];
  }
}

// ops/ncc.py ncc_from_sums, two-view mode, operation for operation
__device__ __forceinline__ float ncc_cost(float s_w, float s_l, float s_r,
                                          float s_ll, float s_rr, float s_lr,
                                          float n, float max_color_diff,
                                          float bad_ret) {
  const bool have = s_w > kWeps;
  const float s_w_safe = have ? s_w : 1.f;
  const float mean_l = s_l / s_w_safe;
  const float mean_r = s_r / s_w_safe;
  const float sum1 = s_lr - mean_l * s_r - mean_r * s_l + n * mean_l * mean_r;
  const float sum2 = s_ll - 2.f * mean_l * s_l + n * mean_l * mean_l;
  const float sum3 = s_rr - 2.f * mean_r * s_r + n * mean_r * mean_r;
  float v = 255.f * (1.f - fabsf(sum1) / sqrtf(sum2 * sum3));
  v = isnan(v) ? max_color_diff : (v < max_color_diff ? v : max_color_diff);
  return have ? v : bad_ret;
}

// Starts staging chunk c (labels c*kL ...) into one buffer: the warped halo
// by cp.async (zeros outside the image and past D), the validity bytes into
// registers (0 there), to be packed by store_valid.  A thread stages its
// own cells for every label of the chunk.
template <int R>
__device__ __forceinline__ void stage_begin(
    float* rb, const float* __restrict__ warped,
    const uint8_t* __restrict__ wvalid, uint32_t (&raw)[Tile<R>::kCells][kL],
    int c, int D, int H, int W, int x0, int y0, int tid) {
  using Tl = Tile<R>;
  constexpr int HW = Tl::HW, HS = Tl::HS, NH = Tl::NH;
  const size_t HWp = (size_t)H * W;
#pragma unroll
  for (int j = 0; j < Tl::kCells; ++j) {
    const int i = tid + j * kThreads;
    const int si = i / HW * HS + i % HW;
    const int hy = y0 - R + i / HW, hx = x0 - R + i % HW;
    const bool in = i < Tl::NC && hy >= 0 && hy < H && hx >= 0 && hx < W;
    const size_t q = in ? (size_t)hy * W + hx : 0;
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      const int d = c * kL + l;
      const bool ok = in && d < D;
      const size_t off = ok ? (size_t)d * HWp + q : 0;
      if (i < Tl::NC)
        cp_async4(rb + (l / kLP) * NH * kLP + si * kLP + l % kLP,
                  warped + off, ok);
      raw[j][l] = ok ? (uint32_t)wvalid[off] : 0u;
    }
  }
  cp_async_commit();
}

template <int R>
__device__ __forceinline__ void store_valid(
    uint32_t* vb, const uint32_t (&raw)[Tile<R>::kCells][kL], int tid) {
  using Tl = Tile<R>;
  constexpr int NH = Tl::NH;
#pragma unroll
  for (int j = 0; j < Tl::kCells; ++j) {
    const int n = tid + j * kThreads;
    if (n >= Tl::NC) continue;
    const int i = n / Tl::HW * Tl::HS + n % Tl::HW;
    if constexpr (kPackedValidity) {
      uint32_t word = 0u;
#pragma unroll
      for (int l = 0; l < kL; ++l) word |= (raw[j][l] != 0u ? 1u : 0u) << l;
      vb[i] = word;
    } else {
      uint8_t* b = reinterpret_cast<uint8_t*>(vb);
#pragma unroll
      for (int l = 0; l < kL; ++l) b[l * NH + i] = raw[j][l] != 0u ? 1 : 0;
    }
  }
}

template <int R, bool kVolume>
__global__ void __launch_bounds__(kThreads, 3)
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
  constexpr int S = Tl::S, T = Tl::T, HW = Tl::HW, HS = Tl::HS, NH = Tl::NH;

  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                         // [T][kThreads]
  float* g_s = w_s + Tl::kW;                 // [HH][HS] reference gray
  float* r_s = g_s + Tl::kG;                 // [kBufs][kNP][HH][HS][kLP]
  uint32_t* v_s = reinterpret_cast<uint32_t*>(r_s + Tl::kBufs * Tl::kRBuf);

  const int tid = threadIdx.x;
  const int tx = tid % kTW, ty = tid / kTW;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x < W && y < H;
  const int HWp = H * W;
  const int p = y * W + x;
  const int n_chunks = (D + kL - 1) / kL;

  // the first chunk, the weights and the gray halo, all by cp.async
  uint32_t raw[Tl::kCells][kL];
  stage_begin<R>(r_s, warped, wvalid, raw, 0, D, H, W, x0, y0, tid);
  for (int k = 0; k < T; ++k)
    cp_async4(w_s + k * kThreads + tid,
              weights + (inside ? (size_t)k * HWp + p : 0), inside);
  for (int i = tid; i < Tl::NC; i += kThreads) {
    const int hy = y0 - R + i / HW, hx = x0 - R + i % HW;
    const bool in = hy >= 0 && hy < H && hx >= 0 && hx < W;
    cp_async4(g_s + i / HW * HS + i % HW,
              gray_ref + (in ? hy * W + hx : 0), in);
  }
  cp_async_commit();
  store_valid<R>(v_s, raw, tid);
  cp_async_wait_all();
  __syncthreads();

  // each thread's own weights: -0.0 outside its left mask; and the
  // label-independent sums over the mask, in tap order (a skipped tap adds
  // an exact +0)
  float h_w = 0.f, h_l = 0.f, h_ll = 0.f, h_n = 0.f;
#pragma unroll 1
  for (int s = 0; s < S; ++s) {
    const int ly = y + s - R;
#pragma unroll
    for (int t = 0; t < S; ++t) {
      float* wk_s = w_s + (s * S + t) * kThreads + tid;
      const float wk = *wk_s;
      const int lx = x + t - R;
      const bool on = inside && ly >= 0 && ly < H && lx >= 0 && lx < W &&
                      left_valid[ly * W + lx] && wk > kWeps;
      const float wl = wk * g_s[(ty + s) * HS + tx + t];
      h_w = h_w + (on ? wk : 0.f);
      h_l = h_l + (on ? wl : 0.f);
      h_ll = h_ll + (on ? wl * wl : 0.f);
      h_n = h_n + (on ? 1.f : 0.f);
      *wk_s = on ? wk : -0.f;
    }
  }

  float min_c = INFINITY, second = INFINITY, best = NAN;
  for (int c = 0; c < n_chunks; ++c) {
    int buf = 0;
    if constexpr (kDoubleBuffer) {
      buf = c & 1;
      if (c + 1 < n_chunks)
        stage_begin<R>(r_s + (buf ^ 1) * Tl::kRBuf, warped, wvalid, raw,
                       c + 1, D, H, W, x0, y0, tid);
    } else if (c > 0) {
      stage_begin<R>(r_s, warped, wvalid, raw, c, D, H, W, x0, y0, tid);
      store_valid<R>(v_s, raw, tid);
      cp_async_wait_all();
      __syncthreads();
    }
    const float* rb = r_s + buf * Tl::kRBuf;
    const uint32_t* vb = v_s + buf * Tl::kVBuf;

    // labels whose own warp sample is valid (none past D)
    const uint32_t centre =
        inside ? valid_word<NH>(vb, (ty + R) * HS + tx + R) : 0u;
    // labels with an invalid warp sample on a left-mask tap
    uint32_t broken = 0u;
    if (centre) {
      uint32_t all_valid = ~0u;
      if constexpr (kHoist) {
#pragma unroll 1
        for (int s = 0; s < S; ++s) {
          const float* wrow = w_s + s * S * kThreads + tid;
          const int hrow = (ty + s) * HS + tx;
#pragma unroll
          for (int t = 0; t < S; ++t)
            all_valid &= valid_word<NH>(vb, hrow + t) |
                         (uint32_t)(__float_as_int(wrow[t * kThreads]) >> 31);
        }
      } else {
        all_valid = 0u;
      }
      broken = centre & ~all_valid;
    }
    float cost[kL];
#pragma unroll
    for (int l = 0; l < kL; ++l) cost[l] = INFINITY;
    if (!__any_sync(0xffffffffu, broken != 0u)) {
      // every label of every lane hoisted: the right-hand sums alone
      if (centre) {
        float sr[kL], srr[kL], slr[kL];
#pragma unroll
        for (int l = 0; l < kL; ++l) sr[l] = srr[l] = slr[l] = 0.f;
#pragma unroll 1
        for (int s = 0; s < S; ++s) {
          const float* wrow = w_s + s * S * kThreads + tid;
          const int hrow = (ty + s) * HS + tx;
#pragma unroll
          for (int t = 0; t < S; ++t) {
            const int h = hrow + t;
            const float wk = wrow[t * kThreads];
            const float wl = wk * g_s[h];
            float r[kL];
            load_r_group<NH, kL>(rb, h, 0, r);
#pragma unroll
            for (int l = 0; l < kL; ++l) {
              const float wr = wk * r[l];
              sr[l] = sr[l] + wr;
              srr[l] = srr[l] + wr * wr;
              slr[l] = slr[l] + wl * wr;
            }
          }
        }
#pragma unroll
        for (int l = 0; l < kL; ++l)
          if ((centre >> l) & 1u)
            cost[l] = ncc_cost(h_w, h_l, sr[l], h_ll, srr[l], slr[l], h_n,
                               max_color_diff, bad_ret);
      }
    } else if (centre) {
      // the warp has a label that is not: every sum of every label over
      // the taps where its left mask and warp sample hold.  A tap that
      // fails takes weight +0, so every term it adds is an exact 0 (a sum
      // is never -0) and no branch is needed; its count is an integer.
      // kFullGroup labels a sweep, so that the sums stay in registers.
#pragma unroll
      for (int l0 = 0; l0 < kL; l0 += kFullGroup) {
        float sw[kFullGroup], sl[kFullGroup], sr[kFullGroup],
            sll[kFullGroup], srr[kFullGroup], slr[kFullGroup];
        int sn[kFullGroup];
#pragma unroll
        for (int j = 0; j < kFullGroup; ++j) {
          sw[j] = sl[j] = sr[j] = sll[j] = srr[j] = slr[j] = 0.f;
          sn[j] = 0;
        }
#pragma unroll 1
        for (int s = 0; s < S; ++s) {
          const float* wrow = w_s + s * S * kThreads + tid;
          const int hrow = (ty + s) * HS + tx;
#pragma unroll
          for (int t = 0; t < S; ++t) {
            const int h = hrow + t;
            const float wk = wrow[t * kThreads];
            const float g = g_s[h];
            const uint32_t on = (valid_word<NH>(vb, h) &
                                 ~(uint32_t)(__float_as_int(wk) >> 31)) >>
                                l0;
            float r[kFullGroup];
            load_r_group<NH, kFullGroup>(rb, h, l0, r);
#pragma unroll
            for (int j = 0; j < kFullGroup; ++j) {
              const bool b = on & (1u << j);
              const float wj = b ? wk : 0.f;
              const float wl = wj * g;
              const float wr = wj * r[j];
              sw[j] = sw[j] + wj;
              sl[j] = sl[j] + wl;
              sr[j] = sr[j] + wr;
              sll[j] = sll[j] + wl * wl;
              srr[j] = srr[j] + wr * wr;
              slr[j] = slr[j] + wl * wr;
              sn[j] += b;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kFullGroup; ++j)
          if ((centre >> (l0 + j)) & 1u)
            cost[l0 + j] = ncc_cost(sw[j], sl[j], sr[j], sll[j], srr[j],
                                    slr[j], (float)sn[j], max_color_diff,
                                    bad_ret);
      }
    }
    if (inside) {
#pragma unroll
      for (int l = 0; l < kL; ++l) {
        const int d = c * kL + l;
        if (d >= D) break;
        if (kVolume) {
          min_out[(size_t)d * HWp + p] = cost[l];
        } else if (cost[l] + (float)1e-10 < min_c) {
          second = min_c;
          min_c = cost[l];
          best = depths[d];
        }
      }
    }

    if constexpr (kDoubleBuffer) {
      if (c + 1 < n_chunks) store_valid<R>(v_s + (buf ^ 1) * Tl::kVBuf, raw,
                                           tid);
      cp_async_wait_all();
    }
    __syncthreads();                         // this chunk's buffer is free
  }
  if (!kVolume && inside) {
    min_out[p] = min_c;
    second_out[p] = second;
    best_out[p] = best;
  }
}

// Lets the kernel take its dynamic shared memory and asks for the largest
// shared-memory share of the SM (by default the split may hold fewer
// blocks than the shared memory would).
template <int R, bool kVolume>
cudaError_t configure() {
  cudaError_t err = cudaFuncSetAttribute(
      cost_wta_kernel<R, kVolume>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile<R>::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cost_wta_kernel<R, kVolume>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

template <int R, bool kVolume>
int launch(const float* depths, const float* warped, const uint8_t* wvalid,
           const float* gray_ref, const uint8_t* left_valid,
           const float* weights, float* min_out, float* second_out,
           float* best_out, int H, int W, int D, float max_color_diff,
           float bad_ret, cudaStream_t stream) {
  const size_t smem = Tile<R>::kSmem;
  const cudaError_t err = configure<R, kVolume>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH);
  cost_wta_kernel<R, kVolume><<<grid, kThreads, smem, stream>>>(
      depths, warped, wvalid, gray_ref, left_valid, weights, min_out,
      second_out, best_out, H, W, D, max_color_diff, bad_ret);
  return (int)cudaGetLastError();
}

template <int R, bool kVolume>
int blocks_per_sm() {
  int n = 0;
  if (configure<R, kVolume>() != cudaSuccess) return 0;
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, cost_wta_kernel<R, kVolume>, kThreads, Tile<R>::kSmem);
  return occ == cudaSuccess ? n : 0;
}

// ---------------------------------------------------------------------------
// The run-time-radius instance (r >= 8, any radius).  At r = 8 the
// templates' weight planes alone take 289 x 128 x 4 B = 148 KB of a
// block's shared memory, and from r = 10 the block no longer fits.  Here
// the radius is a kernel argument, a block of eight warps owns a 32 x 8
// pixel tile (a wide window's halo is shared by more pixels than a 32 x 4
// tile's: 42 x 66 cells for 256 pixels at r = 17), one thread a pixel, and
// the labels go in chunks of kRtL:
// - shared memory holds, for the current chunk, the warped halo with four
//   labels in one 16-byte cell, and a validity word a cell (bit l = label
//   l of the chunk, bit 31 = the cell's left validity, mask & sample()
//   validity), staged as the templates stage them (cp.async of 4 bytes,
//   zeros outside the image and past D; the validity bytes packed); and
//   the reference gray halo for the whole sweep.  NH (4 kRtL + 8) bytes
//   with NH halo cells: 110,880 B at r = 17, two blocks an SM.
// - the weights stay in their [S*S, H, W] planes in device memory (1,225
//   of them a pixel at r = 17): each chunk reads a pixel's once, coalesced
//   across a warp, for all kRtL labels, with a tap's left-mask test
//   (validity bit 31 & weight > 1e-10) applied as it is read (-0.0 outside
//   the mask, as the templates store it).
// - the templates' passes: the label-independent sums once a pixel; a
//   pre-pass ANDs the chunk's validity words over the taps of the left
//   validity (a superset of the left mask: a unit it flags takes the full
//   pass, which gives the same sums).  A label that no lane of the warp
//   flags, in a group of kRtFullGroup labels (the chunk) none flagged,
//   sums the right-hand sums alone (6 operations a tap and label); a group
//   with a flagged label sums all seven on the whole warp, a failing tap
//   taking weight +0 (a unit's sums are the same on either pass).  Taps
//   run outside and labels inside, each label's sums in tap order.
// - a radius whose halo does not fit a block's shared memory (r >= 29)
//   takes the same kernel unstaged: every label the full pass, its warp
//   samples and validity read from device memory.
// Epilogue, WTA carry and volume stores are the templates'.  Built with
// --fmad=false, the costs and picks are the plain version's bit for bit.
// kernel_variants.py times the other setting of each constant.
// ---------------------------------------------------------------------------

constexpr int kRtTW = 32;          // tile columns (a warp)
constexpr int kRtTH = 8;           // tile rows (warps a block)
constexpr int kRtThreads = kRtTW * kRtTH;
constexpr int kRtL = 8;            // labels a chunk
constexpr int kRtFullGroup = 8;    // labels a sweep of the full pass
constexpr int kRtWLoads = 8;       // weights loaded at once
constexpr bool kRtStage = true;    // the halos in shared memory
constexpr bool kRtHoist = true;    // the pre-pass and the 3-sum pass
constexpr uint32_t kLeftBit = 0x80000000u;
static_assert(kRtL % 4 == 0 && kRtL <= 31,
              "a chunk fills 16-byte cells and its bits fit below bit 31");
static_assert(kRtL % kRtFullGroup == 0 && kRtFullGroup % 4 == 0,
              "the full pass's groups tile a chunk in 16-byte cells");
// a block's shared memory, at most (the card's limit for one block)
constexpr size_t kRtMaxSmem = 232448;

// The dynamic shared memory of a block at radius rad (the warped halo,
// validity words and gray halo of its tile); 0 where they do not fit (the
// unstaged path).
size_t rt_smem_bytes(int rad) {
  if (!kRtStage) return 0;
  const size_t nh = (size_t)(kRtTH + 2 * rad) * (kRtTW + 2 * rad);
  const size_t bytes = nh * (4 * kRtL + 8);
  return bytes <= kRtMaxSmem ? bytes : 0;
}

// Every sum of labels [l0, l0 + kRtFullGroup) of a chunk over the taps
// where the left mask and the label's warp sample hold (a failing tap
// takes weight +0, so every term it adds is an exact 0), in tap order;
// the costs of the centre-valid ones into cost.  tap(s, t, w, g, v, r)
// gives a tap's weight, left gray, validity word (bit 31 the left
// validity, bit j label l0 + j) and the group's warp samples.
template <class Tap>
__device__ __forceinline__ void full_group(int S, int l0, uint32_t centre,
                                           float max_color_diff,
                                           float bad_ret, float* cost,
                                           const Tap& tap) {
  float sw[kRtFullGroup], sl[kRtFullGroup], sr[kRtFullGroup],
      sll[kRtFullGroup], srr[kRtFullGroup], slr[kRtFullGroup];
  int sn[kRtFullGroup];
#pragma unroll
  for (int j = 0; j < kRtFullGroup; ++j) {
    sw[j] = sl[j] = sr[j] = sll[j] = srr[j] = slr[j] = 0.f;
    sn[j] = 0;
  }
  for (int s = 0; s < S; ++s) {
#pragma unroll (kRtWLoads)
    for (int t = 0; t < S; ++t) {
      float wk, g, r[kRtFullGroup];
      uint32_t v;
      tap(s, t, wk, g, v, r);
      const uint32_t on = (v & kLeftBit) && wk > kWeps ? v : 0u;
#pragma unroll
      for (int j = 0; j < kRtFullGroup; ++j) {
        const bool b = on & (1u << j);
        const float wj = b ? wk : 0.f;
        const float wl = wj * g;
        const float wr = wj * r[j];
        sw[j] = sw[j] + wj;
        sl[j] = sl[j] + wl;
        sr[j] = sr[j] + wr;
        sll[j] = sll[j] + wl * wl;
        srr[j] = srr[j] + wr * wr;
        slr[j] = slr[j] + wl * wr;
        sn[j] += b;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRtFullGroup; ++j)
    if ((centre >> (l0 + j)) & 1u)
      cost[l0 + j] = ncc_cost(sw[j], sl[j], sr[j], sll[j], srr[j], slr[j],
                              (float)sn[j], max_color_diff, bad_ret);
}

template <bool kVolume>
__global__ void __launch_bounds__(kRtThreads, 2)
cost_wta_rt_kernel(const float* __restrict__ depths,
                   const float* __restrict__ warped,
                   const uint8_t* __restrict__ wvalid,
                   const float* __restrict__ gray_ref,
                   const uint8_t* __restrict__ left_valid,
                   const float* __restrict__ weights,
                   float* __restrict__ min_out, float* __restrict__ second_out,
                   float* __restrict__ best_out, int H, int W, int D, int rad,
                   float max_color_diff, float bad_ret, int staged) {
  extern __shared__ __align__(16) float rt_smem[];
  const int tid = threadIdx.x;
  const int tx = tid % kRtTW, ty = tid / kRtTW;
  const int x0 = blockIdx.x * kRtTW, y0 = blockIdx.y * kRtTH;
  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x < W && y < H;
  const int S = 2 * rad + 1;
  const size_t HWp = (size_t)H * W;
  const size_t p = inside ? (size_t)y * W + x : 0;
  const float* w_p = weights + p;
  float min_c = INFINITY, second = INFINITY, best = NAN;
  // the WTA carry, or the volume's stores, of a chunk's costs
  auto emit = [&](int c0, const float* cost) {
    for (int l = 0; l < kRtL; ++l) {
      const int d = c0 + l;
      if (d >= D) break;
      if (kVolume) {
        min_out[d * HWp + p] = cost[l];
      } else if (cost[l] + (float)1e-10 < min_c) {
        second = min_c;
        min_c = cost[l];
        best = depths[d];
      }
    }
  };

  if (!staged) {
    // every label the full pass, read from device memory
    if (!inside) return;
    for (int c0 = 0; c0 < D; c0 += kRtL) {
      uint32_t centre = 0u;
      for (int l = 0; l < kRtL; ++l)
        if (c0 + l < D && wvalid[(c0 + l) * HWp + p]) centre |= 1u << l;
      float cost[kRtL];
#pragma unroll
      for (int l = 0; l < kRtL; ++l) cost[l] = INFINITY;
      for (int l0 = 0; centre && l0 < kRtL; l0 += kRtFullGroup) {
        full_group(S, l0, centre, max_color_diff, bad_ret, cost,
                   [&](int s, int t, float& wk, float& g, uint32_t& v,
                       float (&r)[kRtFullGroup]) {
          const int ly = y + s - rad, lx = x + t - rad;
          const bool in = ly >= 0 && ly < H && lx >= 0 && lx < W;
          const size_t q = in ? (size_t)ly * W + lx : 0;
          wk = w_p[(size_t)(s * S + t) * HWp];
          g = in ? gray_ref[q] : 0.f;
          v = in && left_valid[q] ? kLeftBit : 0u;
#pragma unroll
          for (int j = 0; j < kRtFullGroup; ++j) {
            const int d = c0 + l0 + j;
            const bool smp = in && d < D;
            // 0 outside the image and past D, as the staged halo
            r[j] = smp ? warped[d * HWp + q] : 0.f;
            if (smp && wvalid[d * HWp + q]) v |= 1u << j;
          }
        });
      }
      emit(c0, cost);
    }
    if (!kVolume) {
      min_out[p] = min_c;
      second_out[p] = second;
      best_out[p] = best;
    }
    return;
  }

  const int HC = kRtTW + 2 * rad;            // halo columns (the stride)
  const int NH = (kRtTH + 2 * rad) * HC;     // halo cells
  float* r_s = rt_smem;                      // [kRtL / 4][NH][4] warped
  uint32_t* v_s = reinterpret_cast<uint32_t*>(r_s + kRtL * NH);   // [NH]
  float* g_s = reinterpret_cast<float*>(v_s + NH);                // [NH]
  // Stages chunk c0's warped halo (cp.async) and validity words.
  auto stage = [&](int c0) {
    for (int i = tid; i < NH; i += kRtThreads) {
      const int hy = y0 - rad + i / HC, hx = x0 - rad + i % HC;
      const bool in = hy >= 0 && hy < H && hx >= 0 && hx < W;
      const size_t q = in ? (size_t)hy * W + hx : 0;
      uint32_t word = in && left_valid[q] ? kLeftBit : 0u;
#pragma unroll
      for (int l = 0; l < kRtL; ++l) {
        const int d = c0 + l;
        const bool ok = in && d < D;
        const size_t off = ok ? (size_t)d * HWp + q : 0;
        cp_async4(r_s + ((l / 4) * NH + i) * 4 + l % 4, warped + off, ok);
        if (ok && wvalid[off]) word |= 1u << l;
      }
      v_s[i] = word;
    }
    cp_async_commit();
  };
  stage(0);
  for (int i = tid; i < NH; i += kRtThreads) {
    const int hy = y0 - rad + i / HC, hx = x0 - rad + i % HC;
    const bool in = hy >= 0 && hy < H && hx >= 0 && hx < W;
    cp_async4(g_s + i, gray_ref + (in ? (size_t)hy * W + hx : 0), in);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // the label-independent sums over the left mask, in tap order (a
  // skipped tap adds an exact +0)
  float h_w = 0.f, h_l = 0.f, h_ll = 0.f, h_n = 0.f;
  for (int s = 0; inside && s < S; ++s) {
    const int hrow = (ty + s) * HC + tx;
    for (int t = 0; t < S; ++t) {
      const float wk = w_p[(size_t)(s * S + t) * HWp];
      const bool on = (v_s[hrow + t] & kLeftBit) && wk > kWeps;
      const float wl = wk * g_s[hrow + t];
      h_w = h_w + (on ? wk : 0.f);
      h_l = h_l + (on ? wl : 0.f);
      h_ll = h_ll + (on ? wl * wl : 0.f);
      h_n = h_n + (on ? 1.f : 0.f);
    }
  }

  constexpr uint32_t kLabels = (1u << kRtL) - 1u;
  const int hc = (ty + rad) * HC + tx + rad;   // the pixel's own cell
  for (int c0 = 0; c0 < D; c0 += kRtL) {
    if (c0 > 0) {
      stage(c0);
      cp_async_wait_all();
      __syncthreads();
    }
    // labels whose own warp sample is valid (none past D)
    const uint32_t centre = inside ? v_s[hc] & kLabels : 0u;
    // labels with an invalid warp sample on a tap of the left validity
    uint32_t broken = 0u;
    if (centre) {
      uint32_t all_valid = kRtHoist ? ~0u : 0u;
      for (int s = 0; kRtHoist && s < S; ++s) {
        const uint32_t* vrow = v_s + (ty + s) * HC + tx;
        for (int t = 0; t < S; ++t) {
          const uint32_t v = vrow[t];
          all_valid &= v | ~(uint32_t)((int32_t)v >> 31);
        }
      }
      broken = centre & ~all_valid;
    }
    float cost[kRtL];
#pragma unroll
    for (int l = 0; l < kRtL; ++l) cost[l] = INFINITY;
    // a group of labels with a unit that is not, on any lane of the warp,
    // takes the full pass on the whole warp; the others the hoisted pass
    const uint32_t full_labels = __reduce_or_sync(0xffffffffu, broken);
    uint32_t full_groups = 0u;
#pragma unroll
    for (int l0 = 0; l0 < kRtL; l0 += kRtFullGroup) {
      const uint32_t group = ((1u << kRtFullGroup) - 1u) << l0;
      if (full_labels & group) full_groups |= group;
    }
    // the right-hand sums alone, taps outside the left mask adding exact
    // zeros
    if (centre & ~full_groups) {
      float sr[kRtL], srr[kRtL], slr[kRtL];
#pragma unroll
      for (int l = 0; l < kRtL; ++l) sr[l] = srr[l] = slr[l] = 0.f;
      // tap h with weight w: -0.0 off the left mask
      auto add = [&](int h, float w) {
        const float wk = (v_s[h] & kLeftBit) && w > kWeps ? w : -0.f;
        const float wl = wk * g_s[h];
        float r[kRtL];
#pragma unroll
        for (int q = 0; q < kRtL / 4; ++q) {
          const float4 c4 =
              reinterpret_cast<const float4*>(r_s)[q * NH + h];
          r[4 * q] = c4.x;
          r[4 * q + 1] = c4.y;
          r[4 * q + 2] = c4.z;
          r[4 * q + 3] = c4.w;
        }
#pragma unroll
        for (int l = 0; l < kRtL; ++l) {
          const float wr = wk * r[l];
          sr[l] = sr[l] + wr;
          srr[l] = srr[l] + wr * wr;
          slr[l] = slr[l] + wl * wr;
        }
      };
      for (int s = 0; s < S; ++s) {
        const float* wrow = w_p + (size_t)(s * S) * HWp;
        const int hrow = (ty + s) * HC + tx;
        // kRtWLoads weights in flight at a time
        int t = 0;
        for (; t + kRtWLoads <= S; t += kRtWLoads) {
          float wv[kRtWLoads];
#pragma unroll
          for (int j = 0; j < kRtWLoads; ++j) wv[j] = wrow[(t + j) * HWp];
#pragma unroll
          for (int j = 0; j < kRtWLoads; ++j) add(hrow + t + j, wv[j]);
        }
        for (; t < S; ++t) add(hrow + t, wrow[t * HWp]);
      }
#pragma unroll
      for (int l = 0; l < kRtL; ++l)
        if ((centre >> l) & 1u)
          cost[l] = ncc_cost(h_w, h_l, sr[l], h_ll, srr[l], slr[l], h_n,
                             max_color_diff, bad_ret);
    }
    // every sum, for the groups of labels with a full-pass label
#pragma unroll
    for (int l0 = 0; l0 < kRtL; l0 += kRtFullGroup) {
      if (!((full_groups >> l0) & 1u) || !centre) continue;
      full_group(S, l0, centre, max_color_diff, bad_ret, cost,
                 [&](int s, int t, float& wk, float& g, uint32_t& v,
                     float (&r)[kRtFullGroup]) {
        const int h = (ty + s) * HC + tx + t;
        wk = w_p[(size_t)(s * S + t) * HWp];
        g = g_s[h];
        const uint32_t word = v_s[h];
        v = (word & kLeftBit) | (word >> l0 & ((1u << kRtFullGroup) - 1u));
#pragma unroll
        for (int q = 0; q < kRtFullGroup / 4; ++q) {
          const float4 c4 =
              reinterpret_cast<const float4*>(r_s)[(l0 / 4 + q) * NH + h];
          r[4 * q] = c4.x;
          r[4 * q + 1] = c4.y;
          r[4 * q + 2] = c4.z;
          r[4 * q + 3] = c4.w;
        }
      });
    }
    if (inside) emit(c0, cost);
    __syncthreads();                         // this chunk's buffer is free
  }
  if (!kVolume && inside) {
    min_out[p] = min_c;
    second_out[p] = second;
    best_out[p] = best;
  }
}

template <bool kVolume>
cudaError_t configure_rt(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      cost_wta_rt_kernel<kVolume>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cost_wta_rt_kernel<kVolume>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

template <bool kVolume>
int launch_rt(const float* depths, const float* warped,
              const uint8_t* wvalid, const float* gray_ref,
              const uint8_t* left_valid, const float* weights,
              float* min_out, float* second_out, float* best_out, int H,
              int W, int D, int radius, float max_color_diff, float bad_ret,
              cudaStream_t stream) {
  const size_t smem = rt_smem_bytes(radius);
  const cudaError_t err = configure_rt<kVolume>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kRtTW - 1) / kRtTW, (H + kRtTH - 1) / kRtTH);
  cost_wta_rt_kernel<kVolume><<<grid, kRtThreads, smem, stream>>>(
      depths, warped, wvalid, gray_ref, left_valid, weights, min_out,
      second_out, best_out, H, W, D, radius, max_color_diff, bad_ret,
      smem > 0);
  return (int)cudaGetLastError();
}

template <bool kVolume>
int rt_blocks_per_sm(int radius) {
  const size_t smem = rt_smem_bytes(radius);
  int n = 0;
  if (configure_rt<kVolume>(smem) != cudaSuccess) return 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n, cost_wta_rt_kernel<kVolume>, kRtThreads, smem) == cudaSuccess
             ? n
             : 0;
}

}  // namespace

// The radii of the compile-time instances: 1 .. 7
// (TwoViewConfig.window_radius is 5).  Which instance a call takes is the
// caller's choice (ops/cuda_cost_wta.py runtime_instance): rt = 1 takes the
// run-time instance, rt = 0 the radius's compile-time one, which these
// entry points refuse where the library does not have it.
#define COST_RADII(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7)

// depths [D] f32; warped [D, H, W] f32; wvalid [D, H, W] bool; gray_ref
// [H, W] f32; left_valid [H, W] bool (mask & sample() validity of the
// reference); weights [S*S, H, W] f32 -> min_cost, second, best [H, W] f32
// (inf, inf, NaN where no label won).
// Returns the CUDA error of the launch (0 on success), and
// cudaErrorInvalidValue for a radius below 1 or a compile-time instance
// the library does not have.
extern "C" int cost_wta_launch(const float* depths, const float* warped,
                               const uint8_t* wvalid, const float* gray_ref,
                               const uint8_t* left_valid,
                               const float* weights, float* min_out,
                               float* second_out, float* best_out, int H,
                               int W, int D, int radius,
                               float max_color_diff, float bad_ret,
                               cudaStream_t stream, int rt) {
  if (radius < 1) return (int)cudaErrorInvalidValue;
  if (rt)
    return launch_rt<false>(depths, warped, wvalid, gray_ref, left_valid,
                            weights, min_out, second_out, best_out, H, W, D,
                            radius, max_color_diff, bad_ret, stream);
  switch (radius) {
#define COST_CASE(r)                                                        \
  case r:                                                                   \
    return launch<r, false>(depths, warped, wvalid, gray_ref, left_valid,   \
                            weights, min_out, second_out, best_out, H, W, D, \
                            max_color_diff, bad_ret, stream);
    COST_RADII(COST_CASE)
#undef COST_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// warped [D, H, W] f32; wvalid [D, H, W] bool; gray_ref [H, W] f32;
// left_valid [H, W] bool; weights [S*S, H, W] f32 -> volume [D, H, W] f32:
// each label's cost (+inf where the pixel's own warp sample is invalid).
// Returns the CUDA error of the launch (0 on success), and
// cudaErrorInvalidValue for a radius below 1 or a compile-time instance
// the library does not have.
extern "C" int cost_volume_launch(const float* warped, const uint8_t* wvalid,
                                  const float* gray_ref,
                                  const uint8_t* left_valid,
                                  const float* weights, float* volume, int H,
                                  int W, int D, int radius,
                                  float max_color_diff, float bad_ret,
                                  cudaStream_t stream, int rt) {
  if (radius < 1) return (int)cudaErrorInvalidValue;
  if (rt)
    return launch_rt<true>(nullptr, warped, wvalid, gray_ref, left_valid,
                           weights, volume, nullptr, nullptr, H, W, D, radius,
                           max_color_diff, bad_ret, stream);
  switch (radius) {
#define COST_CASE(r)                                                       \
  case r:                                                                  \
    return launch<r, true>(nullptr, warped, wvalid, gray_ref, left_valid,  \
                           weights, volume, nullptr, nullptr, H, W, D,     \
                           max_color_diff, bad_ret, stream);
    COST_RADII(COST_CASE)
#undef COST_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The blocks of the radius's compile-time instance (rt = 0) or of the
// run-time instance (rt = 1), volume mode or not, resident on one SM, as
// the runtime computes them for its threads and shared memory; 0 on an
// error or for a compile-time instance the library does not have.
extern "C" int cost_wta_blocks_per_sm(int volume, int radius, int rt) {
  if (rt)
    return volume ? rt_blocks_per_sm<true>(radius)
                  : rt_blocks_per_sm<false>(radius);
  switch (radius) {
#define COST_CASE(r)                                                    \
  case r:                                                               \
    return volume ? blocks_per_sm<r, true>() : blocks_per_sm<r, false>();
    COST_RADII(COST_CASE)
#undef COST_CASE
    default:
      return 0;
  }
}

// The dynamic shared memory a block of the radius's compile-time instance
// (rt = 0) or of the run-time instance (rt = 1; 0 where it runs unstaged)
// takes, in bytes; -1 for a compile-time instance the library does not
// have.
extern "C" int cost_wta_smem_bytes(int radius, int rt) {
  if (rt) return (int)rt_smem_bytes(radius);
  switch (radius) {
#define COST_CASE(r) \
  case r:            \
    return (int)Tile<r>::kSmem;
    COST_RADII(COST_CASE)
#undef COST_CASE
    default:
      return -1;
  }
}
