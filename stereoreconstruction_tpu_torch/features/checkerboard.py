"""Copy of ``stereoreconstruction_tpu/features/checkerboard.py`` (numpy).

Checkerboard corner detection — from-scratch replacement for OpenCV's
``cv::findChessboardCorners`` used by the reference
(features/checkerboard.cpp:124-142).

Pipeline:
1. saddle-point response: negated Hessian determinant of the smoothed gray
   image (checkerboard X-corners are intensity saddles, det H < 0),
2. non-maximum suppression + adaptive thresholding of candidates,
3. subpixel refinement: cornerSubPix-style gradient normal equations,
4. lattice growth: seed at the most central candidate, estimate local
   lattice vectors from its neighbors, BFS-grow integer lattice coordinates
   with locally-updated steps (handles perspective),
5. extract the (cols x rows) inner-corner grid in row-major order with a
   deterministic orientation rule (start corner minimizes image x+y; the
   180-degree ambiguity of odd x odd boards is resolved the same way in
   every view — the reference leaves this to a GUI "rotate indices" action,
   features/checkerboard.cpp:96-120, which ``rotate_indices`` mirrors).

Detection quality target: the bundled example project's checkerboard
image sets (241 JPGs, 11x9 inner corners).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


def _gaussian_kernel1d(sigma: float) -> np.ndarray:
    r = max(1, int(3 * sigma))
    x = np.arange(-r, r + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _sepconv(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    pad = len(k) // 2
    out = np.pad(img, ((pad, pad), (0, 0)), mode="reflect")
    out = np.apply_along_axis(
        lambda m: np.convolve(m, k, mode="valid"), 0, out)
    out = np.pad(out, ((0, 0), (pad, pad)), mode="reflect")
    out = np.apply_along_axis(
        lambda m: np.convolve(m, k, mode="valid"), 1, out)
    return out


def smooth(img: np.ndarray, sigma: float) -> np.ndarray:
    return _sepconv(img.astype(np.float64), _gaussian_kernel1d(sigma))


def saddle_response(gray: np.ndarray, sigma: float = 1.8) -> np.ndarray:
    """-det(Hessian) of the smoothed image; positive at saddle points."""
    g = smooth(gray, sigma)
    gy, gx = np.gradient(g)
    gyy, gyx = np.gradient(gy)
    gxy, gxx = np.gradient(gx)
    return gxy * gyx - gxx * gyy


def _nms_candidates(resp: np.ndarray, max_corners: int,
                    nms_radius: int = 4) -> np.ndarray:
    """Local maxima of the response, strongest first: [N, 2] (x, y)."""
    h, w = resp.shape
    r = nms_radius
    padded = np.pad(resp, r, constant_values=-np.inf)
    win = np.full(resp.shape, -np.inf)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dx == 0 and dy == 0:
                continue
            win = np.maximum(win, padded[r + dy:r + dy + h,
                                         r + dx:r + dx + w])
    is_max = (resp > win) & (resp > 0)
    ys, xs = np.where(is_max)
    vals = resp[ys, xs]
    order = np.argsort(-vals)[:max_corners]
    return np.stack([xs[order], ys[order]], axis=-1).astype(np.float64), \
        vals[order]


def refine_subpixel(gray: np.ndarray, corners: np.ndarray,
                    win: int = 4, iters: int = 8) -> np.ndarray:
    """cornerSubPix-style refinement on the gradient field."""
    g = smooth(gray, 1.0)
    gy, gx = np.gradient(g)
    h, w = gray.shape
    offs = np.arange(-win, win + 1)
    oy, ox = np.meshgrid(offs, offs, indexing="ij")
    wgt = np.exp(-(ox ** 2 + oy ** 2) / (2.0 * (win / 2.0) ** 2))

    out = corners.copy()
    for i in range(len(corners)):
        cx, cy = out[i]
        for _ in range(iters):
            ix, iy = int(round(cx)), int(round(cy))
            if not (win <= ix < w - win and win <= iy < h - win):
                break
            lx = gx[iy - win:iy + win + 1, ix - win:ix + win + 1]
            ly = gy[iy - win:iy + win + 1, ix - win:ix + win + 1]
            A = np.zeros((2, 2))
            b = np.zeros(2)
            A[0, 0] = np.sum(wgt * lx * lx)
            A[0, 1] = A[1, 0] = np.sum(wgt * lx * ly)
            A[1, 1] = np.sum(wgt * ly * ly)
            qx = ix + ox
            qy = iy + oy
            b[0] = np.sum(wgt * (lx * lx * qx + lx * ly * qy))
            b[1] = np.sum(wgt * (lx * ly * qx + ly * ly * qy))
            det = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
            if abs(det) < 1e-9:
                break
            nx = (A[1, 1] * b[0] - A[0, 1] * b[1]) / det
            ny = (A[0, 0] * b[1] - A[1, 0] * b[0]) / det
            if not np.isfinite(nx) or not np.isfinite(ny):
                break
            step = np.hypot(nx - cx, ny - cy)
            cx, cy = nx, ny
            if step < 1e-3:
                break
        out[i] = (cx, cy)
    return out


def _lattice_vectors(cands: np.ndarray, seed: int):
    """Estimate the two local lattice step vectors at a candidate.

    Requires both directions to have approximate opposite counterparts
    among the neighbors (interior corners do; clutter rarely does).
    """
    d = cands - cands[seed]
    dist = np.hypot(d[:, 0], d[:, 1])
    order = np.argsort(dist)[1:14]

    def has_opposite(v):
        for k in order:
            u = d[k]
            if np.linalg.norm(u + v) < 0.35 * np.linalg.norm(v):
                return True
        return False

    v1 = None
    v2 = None
    for k in order:
        v = d[k]
        nv = np.linalg.norm(v)
        if nv < 3.0:
            continue
        if v1 is None:
            if has_opposite(v):
                v1 = v
            continue
        cross = abs(v1[0] * v[1] - v1[1] * v[0])
        if (cross > 0.5 * np.linalg.norm(v1) * nv
                and nv < 3.0 * np.linalg.norm(v1)
                and has_opposite(v)):
            v2 = v
            break
    return v1, v2


def _grow_lattice(cands: np.ndarray, seed: int):
    """BFS integer-lattice assignment from a seed corner.

    Returns dict {(i, j): candidate_index}.
    """
    v1, v2 = _lattice_vectors(cands, seed)
    if v1 is None or v2 is None:
        return {}

    grid = {(0, 0): seed}
    used = {seed}
    # local lattice step estimates per assigned node
    from collections import deque
    queue = deque([(0, 0)])

    def predict(i, j, di, dj):
        """Predict position of (i+di, j+dj) using local steps."""
        p = cands[grid[(i, j)]]
        # step vectors from neighboring assigned nodes if available
        # (second-difference extrapolation handles perspective ramps)
        if di != 0:
            if (i - di, j) in grid:
                s = p - cands[grid[(i - di, j)]]
                if (i - 2 * di, j) in grid:
                    s = s + (s - (cands[grid[(i - di, j)]]
                                  - cands[grid[(i - 2 * di, j)]]))
            else:
                s = v1 * di
        else:
            if (i, j - dj) in grid:
                s = p - cands[grid[(i, j - dj)]]
                if (i, j - 2 * dj) in grid:
                    s = s + (s - (cands[grid[(i, j - dj)]]
                                  - cands[grid[(i, j - 2 * dj)]]))
            else:
                s = v2 * dj
        return p + s, np.linalg.norm(s)

    while queue:
        i, j = queue.popleft()
        for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            key = (i + di, j + dj)
            if key in grid:
                continue
            pred, step = predict(i, j, di, dj)
            dd = cands - pred
            dn = np.hypot(dd[:, 0], dd[:, 1])
            best = int(np.argmin(dn))
            if dn[best] < 0.35 * step and best not in used:
                grid[key] = best
                used.add(best)
                queue.append(key)
    return grid


def _fit_homography(ij: np.ndarray, xy: np.ndarray) -> Optional[np.ndarray]:
    """Normalized DLT homography mapping lattice coords -> image coords."""
    if len(ij) < 4:
        return None

    def normalize(p):
        c = p.mean(axis=0)
        s = np.sqrt(2.0) / max(np.mean(np.hypot(*(p - c).T)), 1e-12)
        T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])
        return T

    Ta, Tb = normalize(ij), normalize(xy)
    a = (Ta @ np.c_[ij, np.ones(len(ij))].T).T
    b = (Tb @ np.c_[xy, np.ones(len(xy))].T).T
    A = np.zeros((2 * len(ij), 9))
    A[0::2, 0:3] = a
    A[0::2, 6:9] = -b[:, [0]] * a
    A[1::2, 3:6] = a
    A[1::2, 6:9] = -b[:, [1]] * a
    _, _, vt = np.linalg.svd(A)
    H = vt[-1].reshape(3, 3)
    H = np.linalg.inv(Tb) @ H @ Ta
    if abs(H[2, 2]) < 1e-12:
        return None
    return H / H[2, 2]


def _apply_h(H: np.ndarray, ij: np.ndarray) -> np.ndarray:
    p = (H @ np.c_[ij, np.ones(len(ij))].T).T
    return p[:, :2] / p[:, [2]]


def _complete_window(gray, resp, cands, vals, grid, bi, bj, nc, nr, swap,
                     cols, rows):
    """Try to produce all cols x rows corners for the window at (bi, bj).

    Present lattice nodes anchor a homography (i,j) -> (x,y); missing or
    homography-inconsistent nodes are predicted from it, subpixel-refined on
    the image, and validated by a positive saddle response near the
    prediction.  Returns [rows*cols, 2] row-major corners or None.
    """
    h, w = gray.shape
    ij, xy, out_key = [], [], []
    missing = []
    for c in range(nc):
        for r in range(nr):
            key = (r, c) if swap else (c, r)
            v = grid.get((bi + c, bj + r))
            if v is None:
                missing.append((c, r, key))
            else:
                ij.append((c, r))
                xy.append(cands[v])
                out_key.append(key)
    if len(ij) < max(8, int(0.7 * nc * nr)):
        return None
    ij = np.asarray(ij, np.float64)
    xy = np.asarray(xy, np.float64)

    # Robust (trimmed) fit: a few mis-assigned lattice nodes can poison a
    # plain least-squares homography badly enough that *every* residual
    # looks like an outlier; refitting on the best half first makes the
    # residual test meaningful.
    H = _fit_homography(ij, xy)
    if H is None:
        return None
    for trim in (0.75, 0.6):
        resid = np.hypot(*(_apply_h(H, ij) - xy).T)
        keep = np.argsort(resid)[:max(8, int(trim * len(ij)))]
        H2 = _fit_homography(ij[keep], xy[keep])
        if H2 is None:
            break
        H = H2

    # reject homography-inconsistent assignments (clutter absorbed into the
    # lattice) and re-predict them alongside the truly missing nodes
    pred = _apply_h(H, ij)
    cell = np.median(np.hypot(*( _apply_h(H, ij + [1, 0]) - pred).T))
    resid = np.hypot(*(pred - xy).T)
    bad = resid > 0.25 * cell
    if bad.sum() > 0.3 * len(ij):
        return None
    if bad.any():
        for k in np.where(bad)[0]:
            missing.append((int(ij[k, 0]), int(ij[k, 1]), out_key[k]))
        keep = ~bad
        ij, xy = ij[keep], xy[keep]
        out_key = [k for k, m in zip(out_key, keep) if m]
        if len(ij) < max(8, int(0.7 * nc * nr)):
            return None
        H = _fit_homography(ij, xy)
        if H is None:
            return None

    corners = {k: p for k, p in zip(out_key, xy)}
    if missing:
        mij = np.asarray([(c, r) for c, r, _ in missing], np.float64)
        guesses = _apply_h(H, mij)
        refined = refine_subpixel(gray, guesses.copy(),
                                  win=max(3, min(6, int(0.35 * cell))))
        for (c, r, key), g, p in zip(missing, guesses, refined):
            if not (1 <= p[0] < w - 1 and 1 <= p[1] < h - 1):
                return None
            if np.hypot(*(p - g)) > 0.3 * cell:
                return None
            # a true X-corner has a positive (saddle) response at the point
            iy, ix = int(round(p[1])), int(round(p[0]))
            y0, y1 = max(0, iy - 1), min(h, iy + 2)
            x0, x1 = max(0, ix - 1), min(w, ix + 2)
            if resp[y0:y1, x0:x1].max() <= 0:
                return None
            corners[key] = p

    out = np.zeros((rows * cols, 2))
    for (c, r), p in corners.items():
        out[r * cols + c] = p
    return out


def find_chessboard_corners(gray: np.ndarray, cols: int, rows: int,
                            max_candidates: Optional[int] = None
                            ) -> Optional[np.ndarray]:
    """Find the (cols x rows) inner-corner grid; [rows*cols, 2] row-major
    (x, y) or None.  ``cols``/``rows`` are inner corner counts (the
    reference builds board_size as (numCols-1, numRows-1),
    checkerboard.cpp:113)."""
    gray = np.asarray(gray, np.float64)
    n_expect = cols * rows
    if max_candidates is None:
        max_candidates = int(n_expect * 2.5)

    resp = saddle_response(gray)
    cands, vals = _nms_candidates(resp, max_candidates)
    if len(cands) < int(0.7 * n_expect):
        return None
    cands = refine_subpixel(gray, cands)

    # seeds: strongest saddle responses first (board corners dominate),
    # then candidates nearest the candidate centroid
    centroid = cands.mean(axis=0)
    by_center = np.argsort(np.hypot(*(cands - centroid).T))
    seeds = list(range(min(25, len(cands)))) + [int(s) for s in
                                               by_center[:15]]
    seen = set()
    seeds = [s for s in seeds if not (s in seen or seen.add(s))]

    # The grown lattice may exceed the board (border/backdrop saddles):
    # slide a (cols x rows) window over lattice coords — in both axis
    # orders — and keep the window with the most present nodes (ties: the
    # strongest total saddle response; true inner corners respond far
    # stronger).  Windows with a few holes are completed by homography
    # prediction + local refinement (_complete_window) — grazing views and
    # small boards routinely lose 1-10 corners to NMS/growth.
    corners = None
    best = (-1, -np.inf)  # (present count, response sum)
    for seed in seeds:
        grid = _grow_lattice(cands, int(seed))
        if len(grid) < int(0.7 * n_expect):
            continue
        ii = np.array([k[0] for k in grid])
        jj = np.array([k[1] for k in grid])
        # rank all windows by (present count, response sum) first;
        # completion (homography fit + refinement) only runs on the best few
        windows = []
        for swap in (False, True):
            nc, nr = (cols, rows) if not swap else (rows, cols)
            for bi in range(ii.min(), ii.max() - nc + 2):
                for bj in range(jj.min(), jj.max() - nr + 2):
                    cnt, score = 0, 0.0
                    for c in range(nc):
                        for r in range(nr):
                            v = grid.get((bi + c, bj + r))
                            if v is not None:
                                cnt += 1
                                score += vals[v]
                    if cnt >= int(0.7 * n_expect):
                        windows.append((cnt, score, bi, bj, nc, nr, swap))
        windows.sort(reverse=True)
        for cnt, score, bi, bj, nc, nr, swap in windows[:4]:
            if (cnt, score) <= best:
                continue
            got = _complete_window(gray, resp, cands, vals, grid,
                                   bi, bj, nc, nr, swap, cols, rows)
            if got is not None:
                best = (cnt, score)
                corners = got
                break
        if corners is not None and best[0] == n_expect:
            break
    if corners is None:
        return None

    # orientation: flip columns/rows so the column direction points
    # image-right and the row direction points image-down.  For a rig whose
    # cameras sit within +-90 degrees of the board normal with little roll
    # (the example's semicircle), this yields the SAME corner indexing in
    # every view — which is what checkerboard correspondence requires
    # (CheckerboardFeature::compare matches equal indices,
    # checkerboard.cpp:58-66).  The 180-degree board symmetry itself is
    # unresolvable from geometry (the reference offers a manual
    # rotateIndicies for the same reason).
    def reorder(flip_c, flip_r):
        out = np.zeros_like(corners)
        for r in range(rows):
            for c in range(cols):
                sc = cols - 1 - c if flip_c else c
                sr = rows - 1 - r if flip_r else r
                out[r * cols + c] = corners[sr * cols + sc]
        return out

    col_dx = corners[cols - 1, 0] - corners[0, 0]
    row_dy = corners[(rows - 1) * cols, 1] - corners[0, 1]
    return reorder(col_dx < 0, row_dy < 0)


def rotate_indices(corners: np.ndarray) -> np.ndarray:
    """180-degree index flip (CheckerboardDetector::rotateIndicies,
    checkerboard.cpp:87-108)."""
    return corners[::-1].copy()


@dataclass
class CheckerboardDetector:
    """Detector facade mirroring the reference's (numRows, numCols) ctor —
    inner corners are (numCols-1) x (numRows-1)."""
    num_rows: int = 10
    num_cols: int = 12

    def detect(self, gray: np.ndarray) -> Optional[np.ndarray]:
        return find_chessboard_corners(gray, self.num_cols - 1,
                                       self.num_rows - 1)
