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
// inputs, mostly the coordinate volume [D, N, 2, H, W] f32 (~472 MB), are
// read once: ~0.155 ms at 3.35 TB/s.  The arithmetic, in the form below, is
// ~6 float32 operations a valid tap of an interior window (11 on a border
// window) and ~20 a (pixel, label, neighbour) unit, ~7e9 a view: ~0.11 ms
// at 67 TFLOP/s.  The bound is the bytes.
//
// Design: one thread per reference pixel, a block a 32 x 4 pixel tile (a
// warp is 32 pixels of one row, so it reads each coordinate plane
// coalesced, and the block's four rows share tap lines in L1).  The thread
// holds its 25 weights, left values x weights and left-validity bits in
// registers for the whole sweep and loops over labels [label0, label0 +
// n_labels) and, inside, over the valid neighbours (a padded neighbour is
// skipped before any tap: its NCC would be -inf).  It reads each unit's
// coordinates one unit ahead, so that their load from device memory
// overlaps the current unit's taps.  The taps are gathered straight from
// the neighbour image through the read-only cache; nothing is staged, so no
// tap can fall outside a staged patch: the wrapper's oob_frac is 0 by
// construction.
//
// Most of a unit's instructions are its taps', so a (pixel, label,
// neighbour) unit takes one of three paths:
// - interior window (floor(x2) - R >= 0, floor(x2) + R <= ws - 1,
//   x2 - R > -1, x2 + R < ws, rows alike; float addition rounds
//   monotonically, so every tap is then in range and unclamped): the valid
//   taps are exactly the pixel's left mask.  So the label-independent sums
//   (weights, left values, their squares, the count) and what the NCC
//   derives from them alone (the left mean, the left variance term) are
//   computed once a pixel, before the label loop, in the plain version's
//   row-major tap order.  A tap is then a load at a constant offset from
//   one row pointer and the three right-hand sums; a pixel whose mask is
//   full (most of them) tests no bit;
// - window wholly outside the image (x2 + R <= -1, x2 - R >= ws, rows
//   alike; a third of the units on the main path): no valid tap, the plain
//   version's empty window (NCC 0);
// - border window: the range tests and clamped indices per row and per
//   column, then every tap loaded and its sums predicated, without a
//   branch (a warp whose lanes mix interior and border windows runs both).
// Every path adds the same values in the same order as the plain version,
// and the library is built with --fmad=false (every a*b+c rounds twice, as
// there), so the NCC values and the picks are the plain version's bit for
// bit.  The WTA carry (K = 1) lives in registers; a longer list in shared
// memory ([entry][thread], 9 KB a block at K = 9), and a label enters it
// only when it peaks at or above the list's smallest entry (the insertion
// is unrolled over K).  In WTA mode a thread whose centre is masked writes
// (-inf, -1) and exits (the caller writes inf there); in top-K mode every
// pixel is swept, since the hypotheses of a masked pixel enter the MRF's
// pairwise terms of its neighbours.
//
// Radii and list lengths: every radius 1 .. 7 has a WTA instance and a
// list instance whose length (1 .. 16) is read at run time; r = 2 with
// K = 9 (MultiViewConfig's defaults) keeps its compile-time list.  Up to
// r = 2 a window's tap bits fit one word and its loops unroll fully, with
// the weights in registers; from r = 3 (49 .. 225 taps) the mask takes
// several words and the weight arrays live in local memory (cached in L1),
// the loops unrolled a row at a time.  The arithmetic and its order are
// the same at every radius.  Any other radius >= 1, a list longer than 16
// or more than 32 neighbours takes the run-time instance at the end of
// this file, which computes the same values tap by tap.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 4;
constexpr float kWeps = 1e-10f;
// the longest hypothesis list of the run-time-K instances
constexpr int kMaxK = 16;

// Loops over a window's taps unroll fully while its bits fit one word
// (r <= 2: the weights stay in registers); a wider window's T taps would
// unroll into thousands of instructions whose weight arrays live in local
// memory anyway, so its loops unroll one row at a time.
template <int R>
struct Win {
  static constexpr int S = 2 * R + 1;
  static constexpr int T = S * S;
  static constexpr int NW = (T + 31) / 32;     // words of a tap mask
  static constexpr int kRowUnroll = NW == 1 ? S : 1;
  static constexpr int kTapUnroll = NW == 1 ? T : S;
  static_assert(S <= 32, "a row or column mask is one 32-bit word");
};

// A window's tap mask, bit k = tap k (row-major), in NW words.
template <int NW>
struct TapMask {
  uint32_t w[NW];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = 0u;
  }
  __device__ __forceinline__ void set(int k) { w[k >> 5] |= 1u << (k & 31); }
  __device__ __forceinline__ uint32_t bit(int k) const {
    return (w[k >> 5] >> (k & 31)) & 1u;
  }
  // every one of the T taps set
  __device__ __forceinline__ bool all(int T) const {
    bool f = true;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int n = T - 32 * i;
      f = f && w[i] == (n >= 32 ? ~0u : (1u << n) - 1u);
    }
    return f;
  }
};

// The terms of the NCC (ncc_from_sums, mvs_mode) that depend on the left
// window alone, in the plain version's order of operations.
struct LeftTerms {
  bool have;        // s_w > eps
  float s_w_safe;   // s_w, or 1 for an empty window
  float s_l, mean_l, sum2, cnt;
};

__device__ __forceinline__ LeftTerms left_terms(float s_w, float s_l,
                                                float s_ll, float cnt) {
  LeftTerms t;
  t.have = s_w > kWeps;
  t.s_w_safe = t.have ? s_w : 1.f;
  t.s_l = s_l;
  t.cnt = cnt;
  t.mean_l = s_l / t.s_w_safe;
  t.sum2 = s_ll - 2.f * t.mean_l * s_l + cnt * t.mean_l * t.mean_l;
  return t;
}

// The NCC from the left terms and the three right-hand sums.
__device__ __forceinline__ float ncc_from_sums(const LeftTerms& t, float s_r,
                                               float s_rr, float s_lr) {
  const float mean_r = s_r / t.s_w_safe;
  const float sum1 = s_lr - t.mean_l * s_r - mean_r * t.s_l
                     + t.cnt * t.mean_l * mean_r;
  const float sum3 = s_rr - 2.f * mean_r * s_r + t.cnt * mean_r * mean_r;
  const float prod = t.sum2 * sum3;
  const bool denom_ok = prod >= kWeps;
  const float q = sum1 / sqrtf(denom_ok ? prod : 1.f);
  return (t.have && denom_ok) ? q : 0.f;
}

// Right-hand sums of an interior window whose top-left tap is at g: every
// tap is in range, so a tap counts iff its left-mask bit is set (FULL: all
// are).
template <int R, bool FULL>
__device__ __forceinline__ void interior_sums(
    const float* __restrict__ g, int ws,
    const TapMask<Win<R>::NW>& lmask,
    const float (&w)[(2 * R + 1) * (2 * R + 1)],
    const float (&wl)[(2 * R + 1) * (2 * R + 1)], float& s_r, float& s_rr,
    float& s_lr) {
  constexpr int S = 2 * R + 1;
  constexpr int kRU = Win<R>::kRowUnroll;
#pragma unroll (kRU)
  for (int r = 0; r < S; ++r) {
    const float* row = g + r * ws;
#pragma unroll
    for (int c = 0; c < S; ++c) {
      const int k = r * S + c;
      if (FULL || lmask.bit(k)) {
        const float wr = w[k] * __ldg(row + c);
        s_r = s_r + wr;
        s_rr = s_rr + wr * wr;
        s_lr = s_lr + wl[k] * wr;
      }
    }
  }
}

// The NCC of a border window: every tap clamped and range-tested.  The
// range tests and clamped indices are per row and per column; a tap is
// valid iff its row, its column and its left-mask bit are.  Every tap is
// loaded (the clamped index is always in the image) and the sums are
// predicated on its validity, so the path has no branch.
template <int R>
__device__ __forceinline__ float border_ncc(
    const float* __restrict__ g, float x2, float y2, float ixf, float iyf,
    int ws, float fws, float fhs, const TapMask<Win<R>::NW>& lmask,
    const float (&w)[(2 * R + 1) * (2 * R + 1)],
    const float (&wl)[(2 * R + 1) * (2 * R + 1)]) {
  constexpr int S = 2 * R + 1;
  uint32_t cols = 0;
  int jx[S];
#pragma unroll
  for (int c = 0; c < S; ++c) {
    const float xc = x2 + (float)(c - R);
    if (xc > -1.f && xc < fws) cols |= 1u << c;
    jx[c] = (int)fminf(fmaxf(ixf + (float)(c - R), 0.f), fws - 1.f);
  }
  // one word of tap bits at r <= 2; a wider window tests its row, column
  // and mask bits tap by tap
  constexpr bool kOneWord = Win<R>::NW == 1;
  constexpr int kRU = Win<R>::kRowUnroll;
  uint32_t vmask = 0, rows = 0;
  int jy[S];
#pragma unroll
  for (int r = 0; r < S; ++r) {
    const float yr = y2 + (float)(r - R);
    if (yr > -1.f && yr < fhs) {
      if (kOneWord) vmask |= cols << (r * S);
      else rows |= 1u << r;
    }
    jy[r] = (int)fminf(fmaxf(iyf + (float)(r - R), 0.f), fhs - 1.f) * ws;
  }
  if (kOneWord) vmask &= lmask.w[0];
  float s_w = 0.f, s_l = 0.f, s_r = 0.f, s_ll = 0.f, s_rr = 0.f, s_lr = 0.f,
        cnt = 0.f;
#pragma unroll (kRU)
  for (int r = 0; r < S; ++r) {
#pragma unroll
    for (int c = 0; c < S; ++c) {
      const int k = r * S + c;
      const float wr = w[k] * __ldg(g + jy[r] + jx[c]);
      if (kOneWord ? (vmask >> k) & 1u
                   : (rows >> r) & (cols >> c) & lmask.bit(k)) {
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
  return ncc_from_sums(left_terms(s_w, s_l, s_ll, cnt), s_r, s_rr, s_lr);
}

// The K > 1 hypothesis lists of a block, [entry][thread]: ncc in entries
// 0 .. k-1, depth in k .. 2k-1 (room for K entries each).
template <int K>
__device__ __forceinline__ float* topk_lists() {
  __shared__ float lists[2 * K * kBlockX * kBlockY];
  return lists;
}

// At most 128 registers a thread, so that 4 blocks (16 warps) share an SM.
// On the H100 that runs 13-19% faster than the 168-182 registers (2-3
// blocks) the compiler picks unbounded, the ~20 spilled bytes
// notwithstanding; more blocks (fewer registers) run no faster.
// K = 1: the WTA carry; K > 1: lists of K; K = 0: lists of a run-time
// length n_list <= kMaxK (n_list is read only then).
template <int R, int K>
__global__ void __launch_bounds__(kBlockX * kBlockY, 4)
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
                 int n_labels, float thr, int n_list) {
  constexpr int T = Win<R>::T;
  constexpr int kTU = Win<R>::kTapUnroll;
  constexpr int KL = K == 0 ? kMaxK : K;   // list room
  const int kk = K == 0 ? n_list : K;      // list length
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= W || y >= H) return;
  const int HW = H * W;
  const int p = y * W + x;
  if (K == 1 && center_valid != nullptr && !center_valid[p]) {
    ncc_out[p] = -INFINITY;
    depth_out[p] = -1.f;
    return;
  }

  float w[T], wl[T];
  TapMask<Win<R>::NW> lmask;
  lmask.clear();
#pragma unroll (kTU)
  for (int k = 0; k < T; ++k) {
    w[k] = wts[k * HW + p];
    wl[k] = w[k] * gl[k * HW + p];
    if (lv[k * HW + p] && w[k] > kWeps) lmask.set(k);
  }
  // the label-independent sums of an interior window, row-major
  float h_w = 0.f, h_l = 0.f, h_ll = 0.f, h_cnt = 0.f;
#pragma unroll (kTU)
  for (int k = 0; k < T; ++k) {
    if (lmask.bit(k)) {
      h_w = h_w + w[k];
      h_l = h_l + wl[k];
      h_ll = h_ll + wl[k] * wl[k];
      h_cnt = h_cnt + 1.f;
    }
  }
  const LeftTerms inner = left_terms(h_w, h_l, h_ll, h_cnt);
  const bool full = lmask.all(T);
  uint32_t nmask = 0;
  for (int n = 0; n < N; ++n)
    if (nbr_valid[n]) nmask |= 1u << n;

  const float fws = (float)ws, fhs = (float)hs;
  // The ascending (ncc, depth) list, padded with (-inf, -1).  K = 1 (the
  // WTA carry) lives in registers; a longer list in shared memory, with its
  // smallest ncc in lo as well.
  constexpr int NT = kBlockX * kBlockY;
  float lo = -INFINITY, lo_d = -1.f;
  [[maybe_unused]] float* list = nullptr;
  if constexpr (K != 1) {
    list = topk_lists<KL>() + threadIdx.y * kBlockX + threadIdx.x;
#pragma unroll
    for (int j = 0; j < KL; ++j) {
      if (j >= kk) break;
      list[j * NT] = -INFINITY;
      list[(kk + j) * NT] = -1.f;
    }
  }
  // the coordinates are read one unit ahead: their load from device
  // memory overlaps the current unit's taps
  const float* c = coords + p;
  float x2_next = c[0], y2_next = c[HW];
  for (int i = 0; i < n_labels; ++i) {
    float m = -INFINITY;
    for (int n = 0; n < N; ++n) {
      const float x2 = x2_next;
      const float y2 = y2_next;
      if (i + 1 < n_labels || n + 1 < N) {
        c += 2 * (size_t)HW;
        x2_next = c[0];
        y2_next = c[HW];
      }
      // padded neighbours and invalid base samples give ncc = -inf, which
      // never changes m
      if (!((nmask >> n) & 1u) || !(x2 > -1e6f)) continue;
      float ncc;
      if (!(x2 + (float)R > -1.f) || !(x2 - (float)R < fws)
          || !(y2 + (float)R > -1.f) || !(y2 - (float)R < fhs)) {
        // no tap in range (float addition rounds monotonically): the
        // plain version's empty window
        m = fmaxf(m, (0.f > thr) ? 0.f : -INFINITY);
        continue;
      }
      const float ixf = floorf(fminf(fmaxf(x2, -1e6f), 1e6f));
      const float iyf = floorf(fminf(fmaxf(y2, -1e6f), 1e6f));
      const float* g = gray_nbr + (size_t)n * hs * ws;
      if (ixf - (float)R >= 0.f && ixf + (float)R <= fws - 1.f
          && x2 - (float)R > -1.f && x2 + (float)R < fws
          && iyf - (float)R >= 0.f && iyf + (float)R <= fhs - 1.f
          && y2 - (float)R > -1.f && y2 + (float)R < fhs) {
        const float* g0 = g + ((int)iyf - R) * ws + ((int)ixf - R);
        float s_r = 0.f, s_rr = 0.f, s_lr = 0.f;
        if (full)
          interior_sums<R, true>(g0, ws, lmask, w, wl, s_r, s_rr, s_lr);
        else
          interior_sums<R, false>(g0, ws, lmask, w, wl, s_r, s_rr, s_lr);
        ncc = ncc_from_sums(inner, s_r, s_rr, s_lr);
      } else {
        ncc = border_ncc<R>(g, x2, y2, ixf, iyf, ws, fws, fhs, lmask, w, wl);
      }
      // peak iff ncc > thr (multiviewstereo.cpp:589)
      m = fmaxf(m, (ncc > thr) ? ncc : -INFINITY);
    }
    // Insert the label's candidate (m, depth) as mvs_topk_slab's stable
    // sort and drop-smallest does: r[j] = t[j+1] if t[j+1] <= m, else m if
    // t[j] <= m, else t[j], with t[K] = +inf.  Among equal nccs the later
    // (larger) depth lands after the existing entries; at K = 1 this is the
    // WTA's ">=", and a label without a peak (m = -inf) still carries its
    // depth there (the caller finalises it to -1 by the ncc).  A longer
    // list is left as it is when m < t[0], and when m = -inf: a label
    // without a peak inserts the reference's (0, -1) no-peak default as
    // (-inf, -1) among entries that are all (-inf, -1) below the peaks.
    const float depth = depths[label0 + i];
    if constexpr (K == 1) {
      if (lo <= m) {
        lo = m;
        lo_d = depth;
      }
    } else if (m > -INFINITY && lo <= m) {
      float t_n[KL], t_d[KL];
#pragma unroll
      for (int j = 0; j < KL; ++j) {
        if (j >= kk) break;
        t_n[j] = list[j * NT];
        t_d[j] = list[(kk + j) * NT];
      }
#pragma unroll
      for (int j = 0; j < KL; ++j) {
        if (j >= kk) break;
        const bool next = j + 1 < kk && t_n[j + 1] <= m;
        const bool here = t_n[j] <= m;
        list[j * NT] = next ? t_n[j + 1] : here ? m : t_n[j];
        list[(kk + j) * NT] = next ? t_d[j + 1] : here ? depth : t_d[j];
      }
      lo = list[0];
    }
  }
  if constexpr (K == 1) {
    ncc_out[p] = lo;
    depth_out[p] = lo_d;
  } else {
#pragma unroll
    for (int j = 0; j < KL; ++j) {
      if (j >= kk) break;
      ncc_out[(size_t)j * HW + p] = list[j * NT];
      depth_out[(size_t)j * HW + p] = list[(kk + j) * NT];
    }
  }
}

template <int R, int K>
void launch(const float* depths, const float* coords, const float* gray_nbr,
            const float* gl, const uint8_t* lv, const float* weights,
            const uint8_t* nbr_valid, const uint8_t* center_valid,
            float* ncc_out, float* depth_out, int H, int W, int N, int hs,
            int ws, int label0, int n_labels, float thr, int n_list,
            cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  mvs_sweep_kernel<R, K><<<grid, block, 0, stream>>>(
      depths, coords, gray_nbr, gl, lv, weights, nbr_valid, center_valid,
      ncc_out, depth_out, H, W, N, hs, ws, label0, n_labels, thr, n_list);
}

// The radius's instances: the WTA carry, lists of a run-time length, and
// at r = 2 (MultiViewConfig.window_radius) lists of MultiViewConfig.top_k,
// which the main path runs: there the run-time list takes 1.20-1.25 ms a
// view against 0.96-0.97 ms (NVIDIA H100 80GB HBM3, 700 W;
// kernel_variants.py).
// list_k, the caller's choice: 1 the WTA carry (n_topk 1), 9 the compiled
// list of 9 (r = 2 only), 0 a list of n_topk (1 .. kMaxK) read at run
// time; false for any other.
template <int R>
bool dispatch(int list_k, int n_topk, const float* depths,
              const float* coords, const float* gray_nbr, const float* gl,
              const uint8_t* lv, const float* weights,
              const uint8_t* nbr_valid, const uint8_t* center_valid,
              float* ncc_out, float* depth_out, int H, int W, int N, int hs,
              int ws, int label0, int n_labels, float thr,
              cudaStream_t stream) {
  if (list_k == 1 ? n_topk != 1
      : list_k == 9 ? (R != 2 || n_topk != 9)
                    : (list_k != 0 || n_topk < 1 || n_topk > kMaxK))
    return false;
  if (list_k == 1)
    launch<R, 1>(depths, coords, gray_nbr, gl, lv, weights, nbr_valid,
                 center_valid, ncc_out, depth_out, H, W, N, hs, ws, label0,
                 n_labels, thr, 1, stream);
  else if (R == 2 && list_k == 9)
    launch<2, 9>(depths, coords, gray_nbr, gl, lv, weights, nbr_valid,
                 center_valid, ncc_out, depth_out, H, W, N, hs, ws, label0,
                 n_labels, thr, 9, stream);
  else
    launch<R, 0>(depths, coords, gray_nbr, gl, lv, weights, nbr_valid,
                 center_valid, ncc_out, depth_out, H, W, N, hs, ws, label0,
                 n_labels, thr, n_topk, stream);
  return true;
}

// ---------------------------------------------------------------------------
// The run-time instance: any radius, any list length, any neighbour count.
// It runs where no compile-time instance does: a radius above 7 (the
// templates' per-thread arrays and one-word row and column masks stop
// there), a list longer than 16, or more than 32 neighbours (the
// templates' neighbour mask is one word).  The radius is a kernel argument
// and the tap loops run at run time.  A thread keeps nothing of its window
// in registers: each tap's weight, left value and left validity are read
// from their [S*S, H, W] planes (coalesced across a warp, cached), a left
// value x weight recomputed as the templates compute it, and a padded
// neighbour is skipped by reading nbr_valid.  The list of a top-K sweep
// lives in the output planes [K, H, W] themselves, inserted into by a
// run-time loop with the unrolled insertion's comparisons.  Its paths and
// their arithmetic are the templates' (interior, wholly outside, border;
// the label-independent sums hoisted once a pixel), tap by tap in the same
// order, so its NCC values and picks are the plain version's bit for bit.
// ---------------------------------------------------------------------------

template <bool WTA>
__global__ void __launch_bounds__(kBlockX * kBlockY)
mvs_sweep_rt_kernel(const float* __restrict__ depths,
                    const float* __restrict__ coords,
                    const float* __restrict__ gray_nbr,
                    const float* __restrict__ gl,
                    const uint8_t* __restrict__ lv,
                    const float* __restrict__ wts,
                    const uint8_t* __restrict__ nbr_valid,
                    const uint8_t* __restrict__ center_valid,
                    float* __restrict__ ncc_out, float* __restrict__ depth_out,
                    int H, int W, int N, int hs, int ws, int label0,
                    int n_labels, float thr, int rad, int n_list) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t HW = (size_t)H * W;
  const size_t p = (size_t)y * W + x;
  if (WTA && center_valid != nullptr && !center_valid[p]) {
    ncc_out[p] = -INFINITY;
    depth_out[p] = -1.f;
    return;
  }
  const int S = 2 * rad + 1;
  const int T = S * S;
  const float frad = (float)rad;
  // tap k of this pixel: its weight, left value x weight and mask bit
  const float* wk_p = wts + p;
  const float* gl_p = gl + p;
  const uint8_t* lv_p = lv + p;
  auto tap_on = [&](int k, float wgt) {
    return lv_p[k * HW] && wgt > kWeps;
  };

  // the label-independent sums of an interior window, row-major
  float h_w = 0.f, h_l = 0.f, h_ll = 0.f, h_cnt = 0.f;
  int n_on = 0;
  for (int k = 0; k < T; ++k) {
    const float wgt = wk_p[k * HW];
    if (tap_on(k, wgt)) {
      const float wlk = wgt * gl_p[k * HW];
      h_w = h_w + wgt;
      h_l = h_l + wlk;
      h_ll = h_ll + wlk * wlk;
      h_cnt = h_cnt + 1.f;
      ++n_on;
    }
  }
  const LeftTerms inner = left_terms(h_w, h_l, h_ll, h_cnt);
  const bool all_on = n_on == T;

  const float fws = (float)ws, fhs = (float)hs;
  // WTA: the carry (lo, lo_d) in registers.  Lists: entry j of this pixel
  // at ncc_out / depth_out[j * HW + p], ascending, lo its smallest ncc.
  float lo = -INFINITY, lo_d = -1.f;
  if (!WTA) {
    for (int j = 0; j < n_list; ++j) {
      ncc_out[j * HW + p] = -INFINITY;
      depth_out[j * HW + p] = -1.f;
    }
  }
  const float* cxy = coords + p;
  float x2_ahead = cxy[0], y2_ahead = cxy[HW];
  for (int i = 0; i < n_labels; ++i) {
    float m = -INFINITY;
    for (int n = 0; n < N; ++n) {
      const float x2 = x2_ahead, y2 = y2_ahead;
      if (i + 1 < n_labels || n + 1 < N) {
        cxy += 2 * HW;
        x2_ahead = cxy[0];
        y2_ahead = cxy[HW];
      }
      if (!nbr_valid[n] || !(x2 > -1e6f)) continue;
      if (!(x2 + frad > -1.f) || !(x2 - frad < fws) || !(y2 + frad > -1.f)
          || !(y2 - frad < fhs)) {
        m = fmaxf(m, (0.f > thr) ? 0.f : -INFINITY);
        continue;
      }
      const float ixf = floorf(fminf(fmaxf(x2, -1e6f), 1e6f));
      const float iyf = floorf(fminf(fmaxf(y2, -1e6f), 1e6f));
      const float* img = gray_nbr + (size_t)n * hs * ws;
      float q;
      if (ixf - frad >= 0.f && ixf + frad <= fws - 1.f && x2 - frad > -1.f
          && x2 + frad < fws && iyf - frad >= 0.f
          && iyf + frad <= fhs - 1.f && y2 - frad > -1.f
          && y2 + frad < fhs) {
        // interior: every tap in range, valid iff its mask bit is set
        const float* top = img + ((int)iyf - rad) * ws + ((int)ixf - rad);
        float s_r = 0.f, s_rr = 0.f, s_lr = 0.f;
        for (int r = 0; r < S; ++r) {
          for (int c = 0; c < S; ++c) {
            const int k = r * S + c;
            const float wgt = wk_p[k * HW];
            if (all_on || tap_on(k, wgt)) {
              const float wr = wgt * __ldg(top + r * ws + c);
              s_r = s_r + wr;
              s_rr = s_rr + wr * wr;
              s_lr = s_lr + (wgt * gl_p[k * HW]) * wr;
            }
          }
        }
        q = ncc_from_sums(inner, s_r, s_rr, s_lr);
      } else {
        // border: per-tap range tests and clamped reads, sums predicated
        float s_w = 0.f, s_l = 0.f, s_r = 0.f, s_ll = 0.f, s_rr = 0.f,
              s_lr = 0.f, cnt = 0.f;
        for (int r = 0; r < S; ++r) {
          const float yr = y2 + (float)(r - rad);
          const bool row_ok = yr > -1.f && yr < fhs;
          const int jy =
              (int)fminf(fmaxf(iyf + (float)(r - rad), 0.f), fhs - 1.f) * ws;
          for (int c = 0; c < S; ++c) {
            const int k = r * S + c;
            const float xc = x2 + (float)(c - rad);
            const int jx =
                (int)fminf(fmaxf(ixf + (float)(c - rad), 0.f), fws - 1.f);
            const float wgt = wk_p[k * HW];
            const float wlk = wgt * gl_p[k * HW];
            const float wr = wgt * __ldg(img + jy + jx);
            if (row_ok && xc > -1.f && xc < fws && tap_on(k, wgt)) {
              s_w = s_w + wgt;
              s_l = s_l + wlk;
              s_r = s_r + wr;
              s_ll = s_ll + wlk * wlk;
              s_rr = s_rr + wr * wr;
              s_lr = s_lr + wlk * wr;
              cnt = cnt + 1.f;
            }
          }
        }
        q = ncc_from_sums(left_terms(s_w, s_l, s_ll, cnt), s_r, s_rr, s_lr);
      }
      m = fmaxf(m, (q > thr) ? q : -INFINITY);
    }
    // the insertion of mvs_sweep_kernel, entry by entry: entry j takes
    // t[j+1] if t[j+1] <= m, else m if t[j] <= m, else t[j] (t[K] = +inf),
    // reading entry j + 1 before entry j is written
    const float depth = depths[label0 + i];
    if (WTA) {
      if (lo <= m) {
        lo = m;
        lo_d = depth;
      }
    } else if (m > -INFINITY && lo <= m) {
      float t_n = ncc_out[p], t_d = depth_out[p];
      for (int j = 0; j < n_list; ++j) {
        const bool last = j + 1 == n_list;
        const float u_n = last ? INFINITY : ncc_out[(j + 1) * HW + p];
        const float u_d = last ? -1.f : depth_out[(j + 1) * HW + p];
        const bool next = !last && u_n <= m;
        const bool here = t_n <= m;
        ncc_out[j * HW + p] = next ? u_n : here ? m : t_n;
        depth_out[j * HW + p] = next ? u_d : here ? depth : t_d;
        t_n = u_n;
        t_d = u_d;
      }
      lo = ncc_out[p];
    }
  }
  if (WTA) {
    ncc_out[p] = lo;
    depth_out[p] = lo_d;
  }
}

template <bool WTA>
void launch_rt(const float* depths, const float* coords,
               const float* gray_nbr, const float* gl, const uint8_t* lv,
               const float* weights, const uint8_t* nbr_valid,
               const uint8_t* center_valid, float* ncc_out, float* depth_out,
               int H, int W, int N, int hs, int ws, int label0, int n_labels,
               float thr, int radius, int n_list, cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  mvs_sweep_rt_kernel<WTA><<<grid, block, 0, stream>>>(
      depths, coords, gray_nbr, gl, lv, weights, nbr_valid, center_valid,
      ncc_out, depth_out, H, W, N, hs, ws, label0, n_labels, thr, radius,
      n_list);
}

}  // namespace

// The radii of the compile-time instances.  Which instance a call takes is
// the caller's choice (ops/cuda_mvs.py list_instance): this entry point
// launches the instance it is told to, and refuses one the library does
// not have.
#define SWEEP_RADII(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7)

// depths [D] f32; coords [n_labels, N, 2, H, W] f32 for labels
// [label0, label0 + n_labels); gray_nbr [N, hs, ws] f32; gl/weights
// [S*S, H, W] f32; lv [S*S, H, W] bool; nbr_valid [N] bool;
// center_valid [H, W] bool or null (all valid; read only when wta)
// -> ncc_out, depth_out [n_topk, H, W] f32, ascending.  wta = 1: the WTA
// carry (n_topk = 1); wta = 0: the top-K lists, n_topk >= 1.  list_k < 0
// takes the run-time instance (any radius, list length and N); list_k >= 0
// the radius's compile-time instance (N <= 32) with that compiled list
// (dispatch).
// Returns cudaGetLastError() after the launch (0 on success), and
// cudaErrorInvalidValue for a radius or top-K below 1 or a compile-time
// instance the library does not have.
extern "C" int mvs_sweep_launch(const float* depths, const float* coords,
                                const float* gray_nbr, const float* gl,
                                const uint8_t* lv, const float* weights,
                                const uint8_t* nbr_valid,
                                const uint8_t* center_valid, float* ncc_out,
                                float* depth_out, int H, int W, int N, int hs,
                                int ws, int label0, int n_labels, int radius,
                                int wta, int n_topk, float thr,
                                cudaStream_t stream, int list_k) {
  if (radius < 1 || (wta ? n_topk != 1 : n_topk < 1))
    return (int)cudaErrorInvalidValue;
  if (list_k < 0) {
    if (wta)
      launch_rt<true>(depths, coords, gray_nbr, gl, lv, weights, nbr_valid,
                      center_valid, ncc_out, depth_out, H, W, N, hs, ws,
                      label0, n_labels, thr, radius, 1, stream);
    else
      launch_rt<false>(depths, coords, gray_nbr, gl, lv, weights, nbr_valid,
                       center_valid, ncc_out, depth_out, H, W, N, hs, ws,
                       label0, n_labels, thr, radius, n_topk, stream);
    return (int)cudaGetLastError();
  }
  // the templates' neighbour mask is one 32-bit word
  if (N > 32 || (list_k == 1) != (wta != 0))
    return (int)cudaErrorInvalidValue;
  bool ok = false;
  switch (radius) {
#define SWEEP_CASE(r)                                                      \
  case r:                                                                  \
    ok = dispatch<r>(list_k, n_topk, depths, coords, gray_nbr, gl, lv,     \
                     weights, nbr_valid, center_valid, ncc_out, depth_out, \
                     H, W, N, hs, ws, label0, n_labels, thr, stream);      \
    break;
    SWEEP_RADII(SWEEP_CASE)
#undef SWEEP_CASE
    default:
      break;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The blocks of the run-time instance (WTA or lists) resident on one SM,
// as the runtime computes them for its threads; 0 on an error.
extern "C" int mvs_sweep_rt_blocks_per_sm(int wta) {
  int n = 0;
  const cudaError_t err =
      wta ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, mvs_sweep_rt_kernel<true>, kBlockX * kBlockY, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, mvs_sweep_rt_kernel<false>, kBlockX * kBlockY, 0);
  return err == cudaSuccess ? n : 0;
}
