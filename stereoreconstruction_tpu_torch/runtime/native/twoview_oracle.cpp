// CPU oracle / baseline: a faithful C++ re-implementation of the reference's
// two-view depth-sweep stereo hot loop (thegedge/StereoReconstruction,
// stereo/twoviewstereo.cpp:233-332 dense variant + geodesicweight.cpp:59-135
// + camera.cpp:380-459), parallelized over rows with OpenMP exactly like the
// reference's `#pragma omp parallel for` (twoviewstereo.cpp:265).
//
// Role in this project:
//  * the measured wall-clock of this translation IS the "reference baseline"
//    for bench.py (the reference publishes no numbers; BASELINE.md asks us to
//    measure the reference math on the bunny config ourselves), and
//  * a fast golden model for large-image parity tests of the TPU engine.
//
// Exposed as a C ABI for ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <array>
#include <limits>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

const double NaN = std::numeric_limits<double>::quiet_NaN();
const double INF = std::numeric_limits<double>::infinity();

struct Camera {
  double K[9];
  double Kinv[9];
  double R[9];
  double t[3];
  double C[3];
  double dist[5];        // k1 k2 p1 p2 k3
  double plane_n[3];     // unit, local frame
  double plane_d;
  double n_index;
  bool is_refractive;
  bool is_distorted;
};

inline void matvec(const double* M, const double* v, double* out) {
  out[0] = M[0] * v[0] + M[1] * v[1] + M[2] * v[2];
  out[1] = M[3] * v[0] + M[4] * v[1] + M[5] * v[2];
  out[2] = M[6] * v[0] + M[7] * v[1] + M[8] * v[2];
}

inline void matTvec(const double* M, const double* v, double* out) {
  out[0] = M[0] * v[0] + M[3] * v[1] + M[6] * v[2];
  out[1] = M[1] * v[0] + M[4] * v[1] + M[7] * v[2];
  out[2] = M[2] * v[0] + M[5] * v[1] + M[8] * v[2];
}

inline double dot3(const double* a, const double* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

inline double norm3(const double* a) { return std::sqrt(dot3(a, a)); }

inline void normalize3(double* a) {
  double n = norm3(a);
  if (n > 0) { a[0] /= n; a[1] /= n; a[2] /= n; }
}

// Bracketed bisection for the refractive-projection quartic
// (camera.cpp:95-138; root always in [0, r] — see geometry/quartic.py).
double refraction_radius(double r, double z, double d, double n) {
  const double nn = n * n, rr = r * r, dd = d * d;
  const double c4 = nn - 1.0;
  const double c3 = -2.0 * r * (nn - 1.0);
  const double c2 = rr * (nn - 1.0) + dd * nn - (z - d) * (z - d);
  const double c1 = -2.0 * dd * nn * r;
  const double c0 = dd * nn * rr;
  double lo = 0.0, hi = r;
  for (int i = 0; i < 60; ++i) {
    double mid = 0.5 * (lo + hi);
    double f = (((c4 * mid + c3) * mid + c2) * mid + c1) * mid + c0;
    if (f >= 0.0) lo = mid; else hi = mid;
  }
  return 0.5 * (lo + hi);
}

bool project(const Camera& cam, const double* X, double* x, double* y) {
  double p[3];
  double tmp[3];
  matvec(cam.R, X, tmp);
  p[0] = tmp[0] + cam.t[0];
  p[1] = tmp[1] + cam.t[1];
  p[2] = tmp[2] + cam.t[2];

  if (cam.is_refractive) {
    double axial = dot3(p, cam.plane_n);
    double proj[3] = {axial * cam.plane_n[0], axial * cam.plane_n[1],
                      axial * cam.plane_n[2]};
    double radial[3] = {p[0] - proj[0], p[1] - proj[1], p[2] - proj[2]};
    double r = norm3(radial);
    double z = std::fabs(axial);
    double dir[3] = {0, 0, 0};
    if (r > 1e-12) { dir[0] = radial[0] / r; dir[1] = radial[1] / r;
                     dir[2] = radial[2] / r; }
    double ri = refraction_radius(r, z, cam.plane_d, cam.n_index);
    p[0] = ri * dir[0] + cam.plane_d * cam.plane_n[0];
    p[1] = ri * dir[1] + cam.plane_d * cam.plane_n[1];
    p[2] = ri * dir[2] + cam.plane_d * cam.plane_n[2];
  }

  double q[3];
  matvec(cam.K, p, q);
  if (std::fabs(q[2]) < 1e-12) return false;
  *x = q[0] / q[2];
  *y = q[1] / q[2];

  if (cam.is_distorted) {
    const double cx = cam.K[2], cy = cam.K[5];
    const double fx = cam.K[0], fy = cam.K[4];
    const double* k = cam.dist;
    double xn = (*x - cx) / fx, yn = (*y - cy) / fy;
    double r2 = xn * xn + yn * yn;
    double cdist = 1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2;
    double xd = xn * cdist + 2 * k[2] * xn * yn + k[3] * (r2 + 2 * xn * xn);
    double yd = yn * cdist + k[2] * (r2 + 2 * yn * yn) + 2 * k[3] * xn * yn;
    *x = fx * xd + cx;
    *y = fy * yd + cy;
  }
  return true;
}

void unproject(const Camera& cam, double x, double y, double* o, double* d) {
  if (cam.is_distorted) {
    const double cx = cam.K[2], cy = cam.K[5];
    const double ifx = 1.0 / cam.K[0], ify = 1.0 / cam.K[4];
    const double* k = cam.dist;
    double x0 = (x - cx) * ifx, y0 = (y - cy) * ify;
    double xc = x0, yc = y0;
    for (int j = 0; j < 5; ++j) {
      double r2 = xc * xc + yc * yc;
      double icdist = 1.0 / (1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2);
      double dx = 2 * k[2] * xc * yc + k[3] * (r2 + 2 * xc * xc);
      double dy = k[2] * (r2 + 2 * yc * yc) + 2 * k[3] * xc * yc;
      xc = (x0 - dx) * icdist;
      yc = (y0 - dy) * icdist;
    }
    x = xc / ifx + cx;
    y = yc / ify + cy;
  }

  double ph[3] = {x, y, 1.0};
  double dir[3];
  matvec(cam.Kinv, ph, dir);
  normalize3(dir);
  double src[3] = {0, 0, 0};

  if (cam.is_refractive) {
    // refract (ray.cpp:92-106); on failure keep the ray
    double nd = dot3(cam.plane_n, dir);
    if (std::fabs(nd) >= 1e-10) {
      double x0v[3] = {cam.plane_d * cam.plane_n[0],
                       cam.plane_d * cam.plane_n[1],
                       cam.plane_d * cam.plane_n[2]};
      double w[3] = {x0v[0] - src[0], x0v[1] - src[1], x0v[2] - src[2]};
      double tt = dot3(cam.plane_n, w) / nd;
      if (tt >= 1e-10) {
        double hit[3] = {src[0] + tt * dir[0], src[1] + tt * dir[1],
                         src[2] + tt * dir[2]};
        double cosI = -dot3(cam.plane_n, dir);
        double cosT2 = 1.0 - (1.0 - cosI * cosI) /
                               (cam.n_index * cam.n_index);
        if (cosT2 > 0.0) {
          double sign = cosI > 0.0 ? -1.0 : 1.0;
          double scale = cosI + cam.n_index * sign * std::sqrt(cosT2);
          dir[0] += scale * cam.plane_n[0];
          dir[1] += scale * cam.plane_n[1];
          dir[2] += scale * cam.plane_n[2];
          normalize3(dir);
          src[0] = hit[0]; src[1] = hit[1]; src[2] = hit[2];
        }
      }
    }
  }

  // local -> global
  double sm[3] = {src[0] - cam.t[0], src[1] - cam.t[1], src[2] - cam.t[2]};
  matTvec(cam.R, sm, o);
  matTvec(cam.R, dir, d);
  normalize3(d);
}

struct Image {
  const float* rgb;   // [H, W, 3]
  const uint8_t* mask;
  int h, w;

  bool in_bounds(int x, int y) const {
    return x >= 0 && y >= 0 && x < w && y < h;
  }
  bool mask_at(double x, double y) const {   // int-cast semantics
    int ix = (int)x, iy = (int)y;
    if (!in_bounds(ix, iy)) return false;
    return mask[iy * w + ix] != 0;
  }
  // VectorImage::sample gray (bilinear over gray == gray of bilinear rgb)
  bool sample_gray(double x, double y, double* out) const {
    if (!(x >= 0 && y >= 0 && x + 1 < w && y + 1 < h)) return false;
    int ix = (int)x, iy = (int)y;
    double dx = x - ix, dy = y - iy;
    double acc[3] = {0, 0, 0};
    const float* p00 = rgb + (iy * w + ix) * 3;
    const float* p01 = rgb + (iy * w + ix + 1) * 3;
    const float* p10 = rgb + ((iy + 1) * w + ix) * 3;
    const float* p11 = rgb + ((iy + 1) * w + ix + 1) * 3;
    for (int c = 0; c < 3; ++c)
      acc[c] = p00[c] * (1 - dx) * (1 - dy) + p01[c] * dx * (1 - dy) +
               p10[c] * (1 - dx) * dy + p11[c] * dx * dy;
    *out = 0.11 * acc[0] + 0.59 * acc[1] + 0.3 * acc[2];  // swapped luma
    return true;
  }
  bool pixel_rgb(int x, int y, double* out) const {
    if (!in_bounds(x, y)) return false;
    const float* p = rgb + (y * w + x) * 3;
    out[0] = p[0]; out[1] = p[1]; out[2] = p[2];
    return true;
  }
};

// Geodesic support weights (geodesicweight.cpp:59-135).
void geodesic_weights(const Image& img, int cx, int cy, int radius,
                      double sigma, int iters, double* w /* [S*S] */) {
  const int S = 2 * radius + 1;
  for (int i = 0; i < S * S; ++i) w[i] = 1000000.0;
  w[radius * S + radius] = 0.0;

  static const int K1[8] = {-1, -1, 0, -1, 1, -1, -1, 0};
  static const int K2[8] = {-1, 1, 0, 1, 1, 1, 1, 0};

  double rgb1[3], rgb2[3];
  for (int iter = 0; iter < iters; ++iter) {
    for (int y = -radius; y <= radius; ++y)
      for (int x = -radius; x <= radius; ++x) {
        if (!img.pixel_rgb(cx + x, cy + y, rgb1)) continue;
        double& ww = w[(y + radius) * S + (x + radius)];
        for (int k = 0; k < 8; k += 2) {
          int dx = K1[k], dy = K1[k + 1];
          if (x + dx > radius || y + dy > radius || x + dx < -radius ||
              y + dy < -radius) continue;
          if (!img.pixel_rgb(cx + x + dx, cy + y + dy, rgb2)) continue;
          double d0 = rgb2[0] - rgb1[0], d1 = rgb2[1] - rgb1[1],
                 d2 = rgb2[2] - rgb1[2];
          double diff = std::sqrt(d0 * d0 + d1 * d1 + d2 * d2);
          double cost = w[(y + dy + radius) * S + (x + dx + radius)];
          ww = std::min(ww, cost + diff);
        }
      }
    for (int y = radius; y >= -radius; --y)
      for (int x = radius; x >= -radius; --x) {
        if (!img.pixel_rgb(cx + x, cy + y, rgb1)) continue;
        double& ww = w[(y + radius) * S + (x + radius)];
        for (int k = 0; k < 8; k += 2) {
          int dx = K2[k], dy = K2[k + 1];
          if (x + dx > radius || y + dy > radius || x + dx < -radius ||
              y + dy < -radius) continue;
          if (!img.pixel_rgb(cx + x + dx, cy + y + dy, rgb2)) continue;
          double d0 = rgb2[0] - rgb1[0], d1 = rgb2[1] - rgb1[1],
                 d2 = rgb2[2] - rgb1[2];
          double diff = std::sqrt(d0 * d0 + d1 * d1 + d2 * d2);
          double cost = w[(y + dy + radius) * S + (x + dx + radius)];
          ww = std::min(ww, cost + diff);
        }
      }
  }
  for (int i = 0; i < S * S; ++i) w[i] = std::exp(-w[i] / sigma);
}

// Weighted NCC (twoviewstereo.cpp:909-977).
double cost_ncc(const Image& left, const Image& right, const double* w,
                int radius, int x1, int y1, double x2, double y2,
                double max_color_diff, double bad_ret) {
  const int S = 2 * radius + 1;
  double meanL = 0, meanR = 0, total = 0;
  for (int row = -radius; row <= radius; ++row)
    for (int col = -radius; col <= radius; ++col) {
      if (!left.mask_at(x1 + col, y1 + row)) continue;
      if (!right.mask_at(x2 + col, y2 + row)) continue;
      double gl, gr;
      if (!left.sample_gray(x1 + col, y1 + row, &gl)) continue;
      if (!right.sample_gray(x2 + col, y2 + row, &gr)) continue;
      double wt = w[(row + radius) * S + (col + radius)];
      if (wt > 1e-10) {
        meanL += wt * gl;
        meanR += wt * gr;
        total += wt;
      }
    }
  if (total < 1e-10) return bad_ret;
  meanL /= total;
  meanR /= total;

  double s1 = 0, s2 = 0, s3 = 0;
  for (int row = -radius; row <= radius; ++row)
    for (int col = -radius; col <= radius; ++col) {
      if (!left.mask_at(x1 + col, y1 + row)) continue;
      if (!right.mask_at(x2 + col, y2 + row)) continue;
      double gl, gr;
      if (!left.sample_gray(x1 + col, y1 + row, &gl)) continue;
      if (!right.sample_gray(x2 + col, y2 + row, &gr)) continue;
      double wt = w[(row + radius) * S + (col + radius)];
      if (wt > 1e-10) {
        double a = wt * gl - meanL, b = wt * gr - meanR;
        s1 += a * b;
        s2 += a * a;
        s3 += b * b;
      }
    }
  double v = 255.0 * (1.0 - std::fabs(s1) / std::sqrt(s2 * s3));
  if (std::isnan(v)) return max_color_diff;  // std::min(a, NaN) -> a
  return std::min(max_color_diff, v);
}

}  // namespace

extern "C" {

// Camera parameter block layout (all doubles):
// K[9], Kinv[9], R[9], t[3], C[3], dist[5], plane_n[3], plane_d, n_index = 43
void make_camera(const double* params, Camera* cam) {
  std::memcpy(cam->K, params, 9 * sizeof(double));
  std::memcpy(cam->Kinv, params + 9, 9 * sizeof(double));
  std::memcpy(cam->R, params + 18, 9 * sizeof(double));
  std::memcpy(cam->t, params + 27, 3 * sizeof(double));
  std::memcpy(cam->C, params + 30, 3 * sizeof(double));
  std::memcpy(cam->dist, params + 33, 5 * sizeof(double));
  std::memcpy(cam->plane_n, params + 38, 3 * sizeof(double));
  cam->plane_d = params[41];
  cam->n_index = params[42];
  cam->is_refractive =
      std::fabs(cam->n_index - 1.0) > 1e-10 && std::fabs(cam->plane_d) > 1e-10;
  cam->is_distorted = false;
  for (int i = 0; i < 5; ++i)
    if (std::fabs(cam->dist[i]) > 1e-10) cam->is_distorted = true;
}

// Dense depth-sweep two-view depth map for the reference view
// (twoviewstereo.cpp:262-332, dense variant), OpenMP over rows.
void twoview_depth_map(
    const float* rgb_ref, const uint8_t* mask_ref,
    const float* rgb_oth, const uint8_t* mask_oth,
    int h, int w,
    const double* cam_ref_params, const double* cam_oth_params,
    double min_depth, double max_depth, int num_depth_levels,
    double image_scale, int radius, double geo_sigma, int geo_iters,
    double max_color_diff, double bad_ret, double second_best_factor,
    double* out_depth /* [h*w] */) {
  Camera cam_ref, cam_oth;
  make_camera(cam_ref_params, &cam_ref);
  make_camera(cam_oth_params, &cam_oth);

  Image ref{rgb_ref, mask_ref, h, w};
  Image oth{rgb_oth, mask_oth, h, w};

  // principal ray (camera.cpp:292-298): direction = R^T Kinv(K.col(2)/K22)
  double tcol[3] = {cam_ref.K[2], cam_ref.K[5], cam_ref.K[8]};
  tcol[0] /= tcol[2]; tcol[1] /= tcol[2]; tcol[2] = 1.0;
  double dirv[3], normal[3];
  matvec(cam_ref.Kinv, tcol, dirv);
  normalize3(dirv);
  matTvec(cam_ref.R, dirv, normal);

  const int S = 2 * radius + 1;

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
  for (int y = 0; y < h; ++y) {
    std::vector<double> wbuf(S * S);
    for (int x = 0; x < w; ++x) {
      out_depth[y * w + x] = NaN;
      if (!mask_ref[y * w + x]) continue;

      geodesic_weights(ref, x, y, radius, geo_sigma, geo_iters, wbuf.data());

      double ro[3], rd[3];
      unproject(cam_ref, (x + 0.5) / image_scale, (y + 0.5) / image_scale,
                ro, rd);

      double min_cost = INF, second = INF;
      for (int lab = 0; lab < num_depth_levels; ++lab) {
        double tt = lab / (num_depth_levels - 1.0);
        tt = tt / (5.0 - 4.0 * tt);
        double depth = min_depth * (1 - tt) + max_depth * tt;

        // pointFromDepth: plane through C + normal*depth
        double pd = dot3(normal, cam_ref.C) + depth;
        double nd = dot3(normal, rd);
        if (std::fabs(nd) < 1e-10) continue;
        double tray = (pd - dot3(normal, ro)) / nd;
        if (tray < 1e-10) continue;
        double pt[3] = {ro[0] + tray * rd[0], ro[1] + tray * rd[1],
                        ro[2] + tray * rd[2]};

        double px, py;
        if (!project(cam_oth, pt, &px, &py)) continue;
        double x2 = px * image_scale - 0.5;
        double y2 = py * image_scale - 0.5;

        double cost = cost_ncc(ref, oth, wbuf.data(), radius, x, y, x2, y2,
                               max_color_diff, bad_ret);
        if (cost + 1e-10 < min_cost) {
          second = min_cost;
          min_cost = cost;
          out_depth[y * w + x] = depth;
        }
      }
      if (min_cost > second_best_factor * second)
        out_depth[y * w + x] = INF;
    }
  }
}

int oracle_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// ---------------------------------------------------------------------------
// Multi-view stereo oracle (Campbell et al. 2009) — the C++ golden/baseline
// for the flagship MVS workflow.  Scalar semantics identical to
// tests/oracle.py::oracle_mvs_oneview / oracle_mvs_cross_check, which are
// themselves literal ports of multiviewstereo.cpp:524-729:
//   * pixel() (int-cast) gray lookups, NO mask checks in the cost
//     (the #if 0 blocks at multiviewstereo.cpp:124-130, 159-165),
//   * uniform depth sampling (multiviewstereo.cpp:733-736),
//   * peak iff NCC > threshold; WTA = best peak, ties -> larger depth
//     (std::sort on (cost, depth) + peaks.back()), -1 when none,
//   * any-view cross-check, sequential over views, NaN on failure.
// ---------------------------------------------------------------------------

namespace {

// gray of pixel() (int-cast) lookup; false when OOB.
inline bool pixel_gray(const Image& img, double x, double y, double* out) {
  int ix = (int)x, iy = (int)y;
  if (!img.in_bounds(ix, iy)) return false;
  const float* p = img.rgb + (iy * img.w + ix) * 3;
  *out = 0.11 * p[0] + 0.59 * p[1] + 0.3 * p[2];
  return true;
}

// multiviewstereo.cpp:113-189 via tests/oracle.py::oracle_cost_ncc_mvs.
double cost_ncc_mvs(const Image& img1, const Image& img2, const double* w,
                    int radius, int x1, int y1, double x2, double y2) {
  const int S = 2 * radius + 1;
  double meanL = 0, meanR = 0, total = 0;
  for (int row = -radius; row <= radius; ++row)
    for (int col = -radius; col <= radius; ++col) {
      double gl, gr;
      if (!pixel_gray(img1, x1 + col, y1 + row, &gl)) continue;
      if (!pixel_gray(img2, x2 + col, y2 + row, &gr)) continue;
      double wt = w[(row + radius) * S + (col + radius)];
      if (wt > 1e-10) {
        meanL += wt * gl;
        meanR += wt * gr;
        total += wt;
      }
    }
  if (total < 1e-10) return 0.0;
  meanL /= total;
  meanR /= total;
  double s1 = 0, s2 = 0, s3 = 0;
  for (int row = -radius; row <= radius; ++row)
    for (int col = -radius; col <= radius; ++col) {
      double gl, gr;
      if (!pixel_gray(img1, x1 + col, y1 + row, &gl)) continue;
      if (!pixel_gray(img2, x2 + col, y2 + row, &gr)) continue;
      double wt = w[(row + radius) * S + (col + radius)];
      if (wt > 1e-10) {
        double a = wt * gl - meanL, b = wt * gr - meanR;
        s1 += a * b;
        s2 += a * a;
        s3 += b * b;
      }
    }
  if (s2 * s3 < 1e-10) return 0.0;
  return s1 / std::sqrt(s2 * s3);
}

void principal_ray_of(const Camera& cam, double* normal) {
  double tcol[3] = {cam.K[2], cam.K[5], cam.K[8]};
  tcol[0] /= tcol[2];
  tcol[1] /= tcol[2];
  tcol[2] = 1.0;
  double dirv[3];
  matvec(cam.Kinv, tcol, dirv);
  normalize3(dirv);
  matTvec(cam.R, dirv, normal);
}

}  // namespace

// Initial estimates + optional any-view cross-check for all views.
// rgbs: [V, h, w, 3]; masks: [V, h, w]; cam_params: [V, 43];
// nbr: [V, max_nbr] neighbour view indices (-1 = unused slot);
// out_depth: [V, h, w].
void mvs_depth_maps_native(
    const float* rgbs, const uint8_t* masks, int n_views, int h, int w,
    const double* cam_params, const int* nbr, int max_nbr,
    double min_depth, double max_depth, int num_depth_levels,
    double image_scale, int radius, double geo_sigma, int geo_iters,
    double ncc_threshold, double cross_check_threshold, int do_cross_check,
    double* out_depth) {
  std::vector<Camera> cams(n_views);
  std::vector<Image> imgs(n_views);
  std::vector<std::array<double, 3>> normals(n_views);
  for (int v = 0; v < n_views; ++v) {
    make_camera(cam_params + 43 * v, &cams[v]);
    imgs[v] = Image{rgbs + (size_t)v * h * w * 3,
                    masks + (size_t)v * h * w, h, w};
    principal_ray_of(cams[v], normals[v].data());
  }
  const int S = 2 * radius + 1;

  for (int v = 0; v < n_views; ++v) {
    double* out = out_depth + (size_t)v * h * w;
    const Image& ref = imgs[v];
    const Camera& cam = cams[v];
    const double* normal = normals[v].data();

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
    for (int y = 0; y < h; ++y) {
      std::vector<double> wbuf(S * S);
      for (int x = 0; x < w; ++x) {
        out[y * w + x] = INF;  // masked pixels keep the INF init
        if (!ref.mask[y * w + x]) continue;

        geodesic_weights(ref, x, y, radius, geo_sigma, geo_iters,
                         wbuf.data());
        double ro[3], rd[3];
        unproject(cam, (x + 0.5) / image_scale, (y + 0.5) / image_scale,
                  ro, rd);

        double best_c = 0.0, best_d = -1.0;  // the (0, -1) default peaks
        for (int k = 0; k < max_nbr; ++k) {
          int j = nbr[v * max_nbr + k];
          if (j < 0) continue;
          for (int lab = 0; lab < num_depth_levels; ++lab) {
            double tt = lab / (num_depth_levels - 1.0);  // uniform
            double depth = min_depth * (1 - tt) + max_depth * tt;

            double pd = dot3(normal, cam.C) + depth;
            double nd = dot3(normal, rd);
            if (std::fabs(nd) < 1e-10) continue;
            double tray = (pd - dot3(normal, ro)) / nd;
            if (tray < 1e-10) continue;
            double pt[3] = {ro[0] + tray * rd[0], ro[1] + tray * rd[1],
                            ro[2] + tray * rd[2]};
            double px, py;
            if (!project(cams[j], pt, &px, &py)) continue;
            double x2 = px * image_scale - 0.5;
            double y2 = py * image_scale - 0.5;
            double c = cost_ncc_mvs(ref, imgs[j], wbuf.data(), radius,
                                    x, y, x2, y2);
            // peaks.sort(); peaks.back(): max (c, depth) lexicographic
            if (c > ncc_threshold &&
                (c > best_c || (c == best_c && depth >= best_d))) {
              best_c = c;
              best_d = depth;
            }
          }
        }
        out[y * w + x] = best_d;
      }
    }
  }

  if (!do_cross_check) return;

  // Sequential over views (later views see earlier invalidations).
  for (int v = 0; v < n_views; ++v) {
    double* out = out_depth + (size_t)v * h * w;
    const Camera& cam = cams[v];
    const double* na = normals[v].data();

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
    for (int y = 0; y < h; ++y) {
      for (int x = 0; x < w; ++x) {
        double d = out[y * w + x];
        if (!std::isfinite(d)) continue;
        double ro[3], rd[3];
        unproject(cam, (x + 0.5) / image_scale, (y + 0.5) / image_scale,
                  ro, rd);
        double pd = dot3(na, cam.C) + d;
        double nd = dot3(na, rd);
        if (std::fabs(nd) < 1e-10) continue;
        double tray = (pd - dot3(na, ro)) / nd;
        if (tray < 1e-10) continue;
        double p1[3] = {ro[0] + tray * rd[0], ro[1] + tray * rd[1],
                        ro[2] + tray * rd[2]};
        bool found = false;
        for (int j = 0; j < n_views && !found; ++j) {
          if (j == v) continue;
          double px, py;
          if (!project(cams[j], p1, &px, &py)) continue;
          double x2 = px * image_scale;
          double y2 = py * image_scale;
          if (!(x2 >= 0 && y2 >= 0 && x2 < w && y2 < h)) continue;
          double od = out_depth[(size_t)j * h * w + (int)y2 * w + (int)x2];
          if (!std::isfinite(od)) continue;
          double r2o[3], r2d[3];
          unproject(cams[j], (x2 + 0.5) / image_scale,
                    (y2 + 0.5) / image_scale, r2o, r2d);
          const double* nb = normals[j].data();
          double pd2 = dot3(nb, cams[j].C) + od;
          double nd2 = dot3(nb, r2d);
          if (std::fabs(nd2) < 1e-10) continue;
          double tray2 = (pd2 - dot3(nb, r2o)) / nd2;
          if (tray2 < 1e-10) continue;
          double p2[3] = {r2o[0] + tray2 * r2d[0], r2o[1] + tray2 * r2d[1],
                          r2o[2] + tray2 * r2d[2]};
          double dx = p1[0] - p2[0], dy = p1[1] - p2[1], dz = p1[2] - p2[2];
          double nrm = std::sqrt(dx * dx + dy * dy + dz * dz);
          if (std::isfinite(nrm) && nrm < cross_check_threshold) found = true;
        }
        if (!found) out[y * w + x] = NaN;
      }
    }
  }
}

// Whole-image geodesic support weights in f64 — the authoritative oracle
// for the TPU weight kernels (scripts/check_radius5_parity.py compares
// both the Pallas sweep kernel and the XLA lockstep formulation against
// this; geodesicweight.cpp:59-135 semantics via the per-pixel
// geodesic_weights above).  out layout: [S*S, h, w] with
// out[(s*S + t), y, x] = weight of window pixel (row offset s-R, col
// offset t-R) for center (y, x).
void geodesic_weights_image(const float* rgb, int h, int w, int radius,
                            double sigma, int iters, double* out) {
  const int S = 2 * radius + 1;
  Image img{rgb, nullptr, h, w};
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
  for (int y = 0; y < h; ++y) {
    std::vector<double> wbuf(S * S);
    for (int x = 0; x < w; ++x) {
      geodesic_weights(img, x, y, radius, sigma, iters, wbuf.data());
      for (int i = 0; i < S * S; ++i)
        out[(size_t)i * h * w + (size_t)y * w + x] = wbuf[i];
    }
  }
}

}  // extern "C"
