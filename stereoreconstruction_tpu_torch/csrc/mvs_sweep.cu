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
// and the tap loops run at run time.
//
// A wide window's planes do not stay near the SM: at r = 8 a pixel's 289
// weights, left values and mask bytes take 2.6 KB, a block's 333 KB, and
// the ~300 (label, neighbour) units of a pixel would each stream them
// again.  So a thread walks the window once for many units:
// - interior units (the templates' test) are gathered in order into kRtU
//   slots (the top-left offset of the unit's window in the neighbour
//   images), border units into kRtB border slots (the window's clamped
//   origin and its runs of rows and columns in range: float addition
//   rounds monotonically, so each is one run, found once a unit).  A pass
//   over the window for one kind of slot reads each tap's weight, left
//   value and mask once and forms the left value x weight once, for every
//   slot.  The weights and left values arrive through a ring in shared
//   memory, kRtAhead taps ahead (cp.async), so their loads from device
//   memory overlap the taps before them.  An interior slot adds the three
//   right-hand sums, a tap off the mask weighing +0 (exact zeros); a
//   border slot all seven over its valid taps, each read at its clamped
//   index.  Each unit's sums go in row-major tap order, so they are the
//   plain version's;
// - a slot is one (label, neighbour) on every lane of the warp: the warp
//   takes one when any lane has such a unit (a vote), a lane that has not
//   leaving it off.  So a slot's tap loads are coalesced (32 neighbouring
//   pixels project to neighbouring taps), and the lanes pass together;
// - a unit whose window is wholly outside the image (the plain version's
//   empty window) folds into its label's carry at once;
// - a label's candidate is the max of its units' NCCs (order-free), and
//   the labels enter the list in label order: the carries of up to kRtCL
//   labels wait in local memory; at kRtCL, and at the end, both passes
//   run and the waiting labels are inserted.
// A top-K list lives in the output planes [K, H, W] (a list in shared
// memory measured slower: it takes the L1 that caches the neighbour
// images).  The insertion is the templates', entry
// by entry, reading entry j + 1 before writing entry j.  The paths and
// their arithmetic are the templates' (interior, wholly outside, border;
// the label-independent sums hoisted once a pixel), so the NCC values and
// picks are the plain version's bit for bit.  kernel_variants.py times
// the other setting of each constant.
// ---------------------------------------------------------------------------

constexpr int kRtU = 16;        // slots: interior units a pass over the window
constexpr int kRtB = 4;         // border slots: border units a pass
constexpr int kRtCL = 128;      // labels whose carries wait for a pass
constexpr int kRtAhead = 8;     // taps whose weights are in flight
constexpr int kRtBlocks = 4;    // blocks an SM (at most 128 registers)
static_assert(kRtCL <= 256, "a slot's label is one byte");

// The dynamic shared memory of a block: the slots' and border slots'
// labels [kRtU + kRtB][thread] (bytes), the ring of the taps in flight
// [kRtRing][2][thread] (weight, left value; one slot more than the taps in
// flight, so that a copy never lands in the slot the same step reads).
constexpr int kRtRing = kRtAhead + 1;
constexpr size_t kRtLabBytes = (kRtU + kRtB + 3) / 4 * 4;
constexpr size_t kRtSmemBytes =
    (kRtLabBytes + 2 * kRtRing * sizeof(float)) * kBlockX * kBlockY;

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

// waits until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool WTA>
__global__ void __launch_bounds__(kBlockX * kBlockY, kRtBlocks)
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
  constexpr int NT = kBlockX * kBlockY;
  extern __shared__ __align__(16) float rt_smem[];
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const size_t HW = (size_t)H * W;
  const bool in_img = x < W && y < H;
  const size_t p = in_img ? (size_t)y * W + x : 0;
  // a lane that sweeps nothing (past the image's edge, or a masked centre
  // of the WTA) stays for its warp's votes; a warp with none that sweeps
  // leaves
  bool active = in_img;
  if (WTA && in_img && center_valid != nullptr && !center_valid[p]) {
    ncc_out[p] = -INFINITY;
    depth_out[p] = -1.f;
    active = false;
  }
  if (!__any_sync(0xffffffffu, active)) return;
  const int S = 2 * rad + 1;
  const int T = S * S;
  const float frad = (float)rad;
  // tap k of this pixel: its weight, left value and mask bit
  const float* wk_p = wts + p;
  const float* gl_p = gl + p;
  const uint8_t* lv_p = lv + p;
  auto tap_on = [&](int k, float wgt) {
    return lv_p[k * HW] && wgt > kWeps;
  };

  // the label-independent sums of an interior window, row-major
  float h_w = 0.f, h_l = 0.f, h_ll = 0.f, h_cnt = 0.f;
  int n_on = 0;
  for (int k = 0; active && k < T; ++k) {
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
  // carry j: the running max of label i_first + j's units (local memory,
  // cached; read and written a few times a label)
  float carry[kRtCL];
  uint8_t* slot_lab = reinterpret_cast<uint8_t*>(rt_smem) + tid;
  // the ring of the taps in flight: tap k's weight and left value at
  // [k % kRtRing][0 / 1][thread]
  float* ring = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(rt_smem)
                                         + kRtLabBytes * NT) + tid;
  // WTA: the carry (lo, lo_d) in registers.  Lists: entry j at l_n / l_d
  // [j * HW], ascending, lo its smallest ncc
  float* l_n = ncc_out + p;
  float* l_d = depth_out + p;
  float lo = -INFINITY, lo_d = -1.f;
  if (!WTA && active) {
    for (int j = 0; j < n_list; ++j) {
      l_n[j * HW] = -INFINITY;
      l_d[j * HW] = -1.f;
    }
  }
  // the insertion of mvs_sweep_kernel, entry by entry: entry j takes
  // t[j+1] if t[j+1] <= m, else m if t[j] <= m, else t[j] (t[K] = +inf),
  // reading entry j + 1 before entry j is written
  auto insert = [&](float m, float depth) {
    if (WTA) {
      if (lo <= m) {
        lo = m;
        lo_d = depth;
      }
    } else if (m > -INFINITY && lo <= m) {
      float t_n = l_n[0], t_d = l_d[0];
      for (int j = 0; j < n_list; ++j) {
        const bool last = j + 1 == n_list;
        const float u_n = last ? INFINITY : l_n[(j + 1) * HW];
        const float u_d = last ? -1.f : l_d[(j + 1) * HW];
        const bool next = !last && u_n <= m;
        const bool here = t_n <= m;
        l_n[j * HW] = next ? u_n : here ? m : t_n;
        l_d[j * HW] = next ? u_d : here ? depth : t_d;
        t_n = u_n;
        t_d = u_d;
      }
      lo = l_n[0];
    }
  };

  // Tap k's weight and left value for a pass over the window, k = 0, 1,
  // ... in turn: each is copied into the ring kRtAhead taps ahead
  // (cp.async), so that its load from device memory overlaps the taps
  // before it.  start() fills the ring for a pass.
  auto fetch = [&](int k) {
    if (k < T) {
      float* q = ring + (k % kRtRing) * 2 * NT;
      cp_async4(q, wk_p + k * HW, true);
      cp_async4(q + NT, gl_p + k * HW, true);
    }
    cp_async_commit();
  };
  auto start = [&]() {
    for (int k = 0; k < kRtAhead; ++k) fetch(k);
  };
  auto tap = [&](int k, float& wgt, float& glk) {
    cp_async_wait<kRtAhead - 1>();
    const float* q = ring + (k % kRtRing) * 2 * NT;
    wgt = q[0];
    glk = q[NT];
    fetch(k + kRtAhead);
  };

  // The slots: each interior unit's window offset in gray_nbr, and its
  // right-hand sums.  A slot is one (label, neighbour) on every lane of
  // the warp (a lane whose unit there is not interior has its bit clear
  // in slot_on), so that a pass's tap loads of a slot are coalesced.
  int off[kRtU];
  float s_r[kRtU], s_rr[kRtU], s_lr[kRtU];
  int n_slots = 0;                 // warp-uniform
  uint32_t slot_on = 0u;
  // One pass over the window for the warp's slots: each tap's weight, left
  // value and mask read once (through the ring), each slot's sums in tap
  // order; then each slot's NCC folded into its label's carry.  A tap off
  // the mask weighs +0 here, so that everything it adds is an exact 0 (a
  // sum is never -0): the sums of the taps on the mask, as the templates'.
  auto pass = [&]() {
    if (n_slots == 0) return;
#pragma unroll
    for (int u = 0; u < kRtU; ++u) s_r[u] = s_rr[u] = s_lr[u] = 0.f;
    start();
    int c = 0, o = 0;              // the tap's column and row * ws + column
    for (int k = 0; k < T; ++k) {
      float w_k, gl_k;
      tap(k, w_k, gl_k);
      const float wgt = all_on || tap_on(k, w_k) ? w_k : 0.f;
      const float wlk = wgt * gl_k;
      const float* g = gray_nbr + o;
#pragma unroll
      for (int u = 0; u < kRtU; ++u) {
        if (u < n_slots && ((slot_on >> u) & 1u)) {
          const float wr = wgt * __ldg(g + off[u]);
          s_r[u] = s_r[u] + wr;
          s_rr[u] = s_rr[u] + wr * wr;
          s_lr[u] = s_lr[u] + wlk * wr;
        }
      }
      if (++c == S) {
        c = 0;
        o += ws - S + 1;
      } else {
        ++o;
      }
    }
#pragma unroll
    for (int u = 0; u < kRtU; ++u) {
      if (u < n_slots && ((slot_on >> u) & 1u)) {
        const float q = ncc_from_sums(inner, s_r[u], s_rr[u], s_lr[u]);
        float* cj = carry + slot_lab[u * NT];
        *cj = fmaxf(*cj, (q > thr) ? q : -INFINITY);
      }
    }
    n_slots = 0;
    slot_on = 0u;
  };
  // The border slots: each border unit's window (the clamped row and
  // column of its top-left tap, the image's offset, the runs of rows and
  // columns in range) and its seven sums; one (label, neighbour) on every
  // lane of the warp, as the slots.  A tap is valid iff its row and column
  // are in range and its mask bit is set.  Float addition rounds
  // monotonically, so the rows in range are one run [r0, r1) and the
  // columns [c0, c1), found once a unit.
  int b_iy0[kRtB], b_ix0[kRtB], b_img[kRtB], b_rows[kRtB], b_cols[kRtB];
  int n_bslots = 0;                // warp-uniform
  uint32_t bslot_on = 0u;
  uint8_t* bslot_lab = slot_lab + kRtU * NT;
  // One pass over the window for the warp's border slots: each tap's
  // weight, left value and mask read once (through the ring); each slot's
  // sums over its valid taps in tap order, each read at its clamped
  // index; then each slot's NCC folded into its label's carry.
  auto pass_b = [&]() {
    if (n_bslots == 0) return;
    float b_w[kRtB], b_l[kRtB], b_r[kRtB], b_ll[kRtB], b_rr[kRtB],
        b_lr[kRtB], b_n[kRtB];
#pragma unroll
    for (int u = 0; u < kRtB; ++u)
      b_w[u] = b_l[u] = b_r[u] = b_ll[u] = b_rr[u] = b_lr[u] = b_n[u] = 0.f;
    start();
    int r = 0, c = 0;
    // at each row: the slots whose row is in range, and the row's start
    uint32_t row_on = 0u;
    int rowp[kRtB];
    for (int k = 0; k < T; ++k) {
      float wgt, glk;
      tap(k, wgt, glk);
      const float wlk = wgt * glk;
      const bool on = all_on || tap_on(k, wgt);
      if (c == 0) {
        row_on = 0u;
#pragma unroll
        for (int u = 0; u < kRtB; ++u) {
          if (u < n_bslots && ((bslot_on >> u) & 1u)
              && r >= (b_rows[u] & 0xffff) && r < (b_rows[u] >> 16))
            row_on |= 1u << u;
          rowp[u] = b_img[u] + min(max(b_iy0[u] + r, 0), hs - 1) * ws;
        }
      }
#pragma unroll
      for (int u = 0; u < kRtB; ++u) {
        if (on && ((row_on >> u) & 1u) && c >= (b_cols[u] & 0xffff)
            && c < (b_cols[u] >> 16)) {
          const int jx = min(max(b_ix0[u] + c, 0), ws - 1);
          const float wr = wgt * __ldg(gray_nbr + rowp[u] + jx);
          b_w[u] = b_w[u] + wgt;
          b_l[u] = b_l[u] + wlk;
          b_r[u] = b_r[u] + wr;
          b_ll[u] = b_ll[u] + wlk * wlk;
          b_rr[u] = b_rr[u] + wr * wr;
          b_lr[u] = b_lr[u] + wlk * wr;
          b_n[u] = b_n[u] + 1.f;
        }
      }
      if (++c == S) {
        c = 0;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kRtB; ++u) {
      if (u < n_bslots && ((bslot_on >> u) & 1u)) {
        const float q = ncc_from_sums(left_terms(b_w[u], b_l[u], b_ll[u],
                                                 b_n[u]),
                                      b_r[u], b_rr[u], b_lr[u]);
        float* cj = carry + bslot_lab[u * NT];
        *cj = fmaxf(*cj, (q > thr) ? q : -INFINITY);
      }
    }
    n_bslots = 0;
    bslot_on = 0u;
  };
  // labels [i_first, i) are complete after the passes: they enter the
  // list in order
  int i_first = 0;
  auto complete = [&](int i) {
    pass();
    pass_b();
    if (active) {
      for (int j = i_first; j < i; ++j)
        insert(carry[j - i_first], depths[label0 + j]);
    }
    i_first = i;
  };

  // A unit of this lane at (x2, y2) in neighbour n: 1 (interior) with its
  // window offset in o; 2 (border) with its window in iy0, ix0, img, rows,
  // cols (runs [lo, hi) as lo | hi << 16); 0 when its window is wholly
  // outside the image (the plain version's empty window), folded into
  // carry cj at once.
  auto unit = [&](int n, float x2, float y2, float* cj, int& o, int& iy0,
                  int& ix0, int& img, int& rows, int& cols) {
    if (!(x2 + frad > -1.f) || !(x2 - frad < fws) || !(y2 + frad > -1.f)
        || !(y2 - frad < fhs)) {
      *cj = fmaxf(*cj, (0.f > thr) ? 0.f : -INFINITY);
      return 0;
    }
    const float ixf = floorf(fminf(fmaxf(x2, -1e6f), 1e6f));
    const float iyf = floorf(fminf(fmaxf(y2, -1e6f), 1e6f));
    if (ixf - frad >= 0.f && ixf + frad <= fws - 1.f && x2 - frad > -1.f
        && x2 + frad < fws && iyf - frad >= 0.f && iyf + frad <= fhs - 1.f
        && y2 - frad > -1.f && y2 + frad < fhs) {
      o = (n * hs + (int)iyf - rad) * ws + ((int)ixf - rad);
      return 1;
    }
    int r0 = 0, r1 = S, c0 = 0, c1 = S;
    while (r0 < S && !(y2 + (float)(r0 - rad) > -1.f)) ++r0;
    while (r1 > r0 && !(y2 + (float)(r1 - 1 - rad) < fhs)) --r1;
    while (c0 < S && !(x2 + (float)(c0 - rad) > -1.f)) ++c0;
    while (c1 > c0 && !(x2 + (float)(c1 - 1 - rad) < fws)) --c1;
    iy0 = (int)iyf - rad;
    ix0 = (int)ixf - rad;
    img = n * hs * ws;
    rows = r0 | r1 << 16;
    cols = c0 | c1 << 16;
    return 2;
  };

  // the coordinates are read one unit ahead: their load from device
  // memory overlaps the current unit's work
  const float* cxy = coords + p;
  float x2_ahead = 0.f, y2_ahead = 0.f;
  if (active) {
    x2_ahead = cxy[0];
    y2_ahead = cxy[HW];
  }
  for (int i = 0; i < n_labels; ++i) {
    if (i - i_first == kRtCL) complete(i);
    carry[i - i_first] = -INFINITY;
    for (int n = 0; n < N; ++n) {
      if (n_slots == kRtU) pass();
      if (n_bslots == kRtB) pass_b();
      // this lane's unit: a slot, a border slot (below), or folded at once
      int kind = 0, o = 0, iy0 = 0, ix0 = 0, img = 0, rows = 0, cols = 0;
      if (active) {
        const float x2 = x2_ahead, y2 = y2_ahead;
        if (i + 1 < n_labels || n + 1 < N) {
          cxy += 2 * HW;
          x2_ahead = cxy[0];
          y2_ahead = cxy[HW];
        }
        // padded neighbours and invalid base samples give ncc = -inf,
        // which never changes the carry
        if (nbr_valid[n] && x2 > -1e6f)
          kind = unit(n, x2, y2, carry + (i - i_first), o, iy0, ix0,
                      img, rows, cols);
      }
      // a slot of the warp when any lane's unit is interior, a border
      // slot when any lane's is a border unit
      if (__any_sync(0xffffffffu, kind == 1)) {
#pragma unroll
        for (int u = 0; u < kRtU; ++u)
          if (u == n_slots) off[u] = o;
        if (kind == 1) slot_on |= 1u << n_slots;
        slot_lab[n_slots * NT] = (uint8_t)(i - i_first);
        ++n_slots;
      }
      if (__any_sync(0xffffffffu, kind == 2)) {
#pragma unroll
        for (int u = 0; u < kRtB; ++u) {
          if (u == n_bslots) {
            b_iy0[u] = iy0;
            b_ix0[u] = ix0;
            b_img[u] = img;
            b_rows[u] = rows;
            b_cols[u] = cols;
          }
        }
        if (kind == 2) bslot_on |= 1u << n_bslots;
        bslot_lab[n_bslots * NT] = (uint8_t)(i - i_first);
        ++n_bslots;
      }
    }
  }
  complete(n_labels);
  if (!active) return;
  if (WTA) {
    ncc_out[p] = lo;
    depth_out[p] = lo_d;
  }
}

// Lets the kernel take its dynamic shared memory, and asks for the least
// shared-memory share of the SM that holds kRtBlocks blocks: the rest is
// L1, which caches the neighbour images' tap rows.
template <bool WTA>
cudaError_t configure_rt(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      mvs_sweep_rt_kernel<WTA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  const int share =
      (int)((kRtBlocks * (smem + 1024) * 100 + 233471) / 233472);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mvs_sweep_rt_kernel<WTA>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               share < 100 ? share : 100);
  return err;
}

template <bool WTA>
int launch_rt(const float* depths, const float* coords,
              const float* gray_nbr, const float* gl, const uint8_t* lv,
              const float* weights, const uint8_t* nbr_valid,
              const uint8_t* center_valid, float* ncc_out, float* depth_out,
              int H, int W, int N, int hs, int ws, int label0, int n_labels,
              float thr, int radius, int n_list, cudaStream_t stream) {
  const size_t smem = kRtSmemBytes;
  const cudaError_t err = configure_rt<WTA>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  mvs_sweep_rt_kernel<WTA><<<grid, block, smem, stream>>>(
      depths, coords, gray_nbr, gl, lv, weights, nbr_valid, center_valid,
      ncc_out, depth_out, H, W, N, hs, ws, label0, n_labels, thr, radius,
      n_list);
  return (int)cudaGetLastError();
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
    return wta ? launch_rt<true>(depths, coords, gray_nbr, gl, lv, weights,
                                 nbr_valid, center_valid, ncc_out, depth_out,
                                 H, W, N, hs, ws, label0, n_labels, thr,
                                 radius, 1, stream)
               : launch_rt<false>(depths, coords, gray_nbr, gl, lv, weights,
                                  nbr_valid, center_valid, ncc_out,
                                  depth_out, H, W, N, hs, ws, label0,
                                  n_labels, thr, radius, n_topk, stream);
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

// The blocks of the run-time instance (WTA, or lists) resident on one SM,
// as the runtime computes them for its threads and dynamic shared memory;
// 0 on an error.
extern "C" int mvs_sweep_rt_blocks_per_sm(int wta) {
  const size_t smem = kRtSmemBytes;
  int n = 0;
  const cudaError_t err =
      wta ? (configure_rt<true>(smem) == cudaSuccess
                 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, mvs_sweep_rt_kernel<true>, kBlockX * kBlockY, smem)
                 : cudaErrorInvalidValue)
          : (configure_rt<false>(smem) == cudaSuccess
                 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, mvs_sweep_rt_kernel<false>, kBlockX * kBlockY,
                       smem)
                 : cudaErrorInvalidValue);
  return err == cudaSuccess ? n : 0;
}

// The dynamic shared memory a block of the run-time instance takes (WTA or
// lists), in bytes.
extern "C" int mvs_sweep_rt_smem_bytes() { return (int)kRtSmemBytes; }
