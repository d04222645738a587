"""Copy of ``stereoreconstruction_tpu/data/demosaic.py`` (numpy).

Bayer (GRBG) demosaicing — util/rawimages replacement.

The reference ships four demosaicers for GRBG Bayer data (rawimagereader.
hpp:40-58): nearest-neighbour, bilinear, smooth-hue, and edge-sensing; the
GUI's RAW->PNG conversion uses edge-sensing (mainwindow.cpp:1088).

``demosaic_es`` is a bit-faithful vectorized port of es.cpp:22-105 including
its integer arithmetic, boundary counters, and the swapped-counter guard
quirks at the green-pixel red/blue fill.  The other three are standard
vectorized implementations.

Layout (MASK 'GRBG', rawimagereader.hpp:23):
  row 0:  G R G R ...
  row 1:  B G B G ...
"""

from __future__ import annotations

import numpy as np


def _masks(h, w):
    ys, xs = np.mgrid[0:h, 0:w]
    g = (ys % 2) == (xs % 2)
    r = (ys % 2 == 0) & (xs % 2 == 1)
    b = (ys % 2 == 1) & (xs % 2 == 0)
    return g, r, b


def _shift_sum(data, offsets):
    """Sum + count of in-bounds neighbors at given (dy, dx) offsets."""
    h, w = data.shape
    s = np.zeros((h, w), np.int64)
    c = np.zeros((h, w), np.int64)
    for dy, dx in offsets:
        ys = slice(max(0, -dy), min(h, h - dy))
        xs = slice(max(0, -dx), min(w, w - dx))
        ys_src = slice(max(0, dy), min(h, h + dy))
        xs_src = slice(max(0, dx), min(w, w + dx))
        s[ys, xs] += data[ys_src, xs_src]
        c[ys, xs] += 1
    return s, c


def demosaic_es(raw: np.ndarray) -> np.ndarray:
    """Edge-sensing demosaic (es.cpp), bit-faithful. raw: [H, W] uint8."""
    raw = np.asarray(raw).astype(np.int64)
    h, w = raw.shape
    g_m, r_m, b_m = _masks(h, w)
    out = np.zeros((h, w, 3), np.int64)

    # pass 1: green plane
    N, cN = _shift_sum(raw, [(-1, 0)])
    S, cS = _shift_sum(raw, [(1, 0)])
    W, cW = _shift_sum(raw, [(0, -1)])
    E, cE = _shift_sum(raw, [(0, 1)])
    hcount = cW + cE
    vcount = cN + cS
    deltah = np.abs(E - W)
    deltav = np.abs(N - S)
    thresh = (deltah + deltav) // 2

    g_h = (E + W) // np.maximum(hcount, 1)
    g_v = (N + S) // np.maximum(vcount, 1)
    g_a = (N + E + S + W) // np.maximum(hcount + vcount, 1)
    cond_h = (deltah < thresh) & (deltav > thresh)
    cond_v = (deltah > thresh) & (deltav < thresh)
    green = np.where(cond_h, g_h, np.where(cond_v, g_v, g_a))
    out[..., 1] = np.where(g_m, raw, green)

    # pass 2: red/blue planes
    sv, cv = _shift_sum(raw, [(-1, 0), (1, 0)])       # vertical (sum1)
    sh, ch = _shift_sum(raw, [(0, -1), (0, 1)])       # horizontal (sum2)
    sd, cd = _shift_sum(raw, [(-1, -1), (-1, 1), (1, -1), (1, 1)])

    even = (np.arange(h) % 2 == 0)[:, None] & np.ones((h, w), bool)

    # G pixels: replicate the swapped-counter guards (es.cpp:80-90)
    gh = np.where(cv == 0, 0, sh // np.maximum(ch, 1))
    gv = np.where(ch == 0, 0, sv // np.maximum(cv, 1))
    r_at_g = np.where(even, gh, gv)
    b_at_g = np.where(even, gv, gh)

    diag = sd // np.maximum(cd, 1)
    out[..., 0] = np.where(g_m, r_at_g, np.where(r_m, raw, diag))
    out[..., 2] = np.where(g_m, b_at_g, np.where(b_m, raw, diag))
    return np.clip(out, 0, 255).astype(np.uint8)


def demosaic_nn(raw: np.ndarray) -> np.ndarray:
    """Nearest-neighbour (nn.cpp equivalent)."""
    raw = np.asarray(raw).astype(np.int64)
    h, w = raw.shape
    g_m, r_m, b_m = _masks(h, w)

    def nearest(mask):
        s, c = _shift_sum(np.where(mask, raw, 0),
                          [(0, 0), (0, 1), (1, 0), (0, -1), (-1, 0),
                           (1, 1), (1, -1), (-1, 1), (-1, -1)])
        cnt, _ = _shift_sum(mask.astype(np.int64),
                            [(0, 0), (0, 1), (1, 0), (0, -1), (-1, 0),
                             (1, 1), (1, -1), (-1, 1), (-1, -1)])
        return s // np.maximum(cnt, 1)

    out = np.stack([nearest(r_m), nearest(g_m), nearest(b_m)], -1)
    out[r_m, 0] = raw[r_m]
    out[g_m, 1] = raw[g_m]
    out[b_m, 2] = raw[b_m]
    return np.clip(out, 0, 255).astype(np.uint8)


def demosaic_bl(raw: np.ndarray) -> np.ndarray:
    """Bilinear (bl.cpp equivalent)."""
    raw = np.asarray(raw).astype(np.float64)
    h, w = raw.shape
    g_m, r_m, b_m = _masks(h, w)

    def interp(mask):
        vals = np.where(mask, raw, 0.0)
        s, _ = _shift_sum(vals.astype(np.int64),
                          [(0, 0), (0, 1), (0, -1), (1, 0), (-1, 0),
                           (1, 1), (1, -1), (-1, 1), (-1, -1)])
        c, _ = _shift_sum(mask.astype(np.int64),
                          [(0, 0), (0, 1), (0, -1), (1, 0), (-1, 0),
                           (1, 1), (1, -1), (-1, 1), (-1, -1)])
        return s / np.maximum(c, 1)

    out = np.stack([interp(r_m), interp(g_m), interp(b_m)], -1)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def demosaic_hue(raw: np.ndarray) -> np.ndarray:
    """Smooth-hue-transition (hue.cpp equivalent): bilinear green, then
    red/blue interpolated as ratios against green."""
    raw_f = np.asarray(raw).astype(np.float64)
    bl = demosaic_bl(raw).astype(np.float64)
    g = np.maximum(bl[..., 1], 1.0)
    h, w = raw_f.shape
    g_m, r_m, b_m = _masks(h, w)

    out = bl.copy()
    for ch, mask in ((0, r_m), (2, b_m)):
        ratio = np.where(mask, raw_f / g, 0.0)
        s, _ = _shift_sum((ratio * 1024).astype(np.int64),
                          [(0, 0), (0, 1), (0, -1), (1, 0), (-1, 0),
                           (1, 1), (1, -1), (-1, 1), (-1, -1)])
        c, _ = _shift_sum(mask.astype(np.int64),
                          [(0, 0), (0, 1), (0, -1), (1, 0), (-1, 0),
                           (1, 1), (1, -1), (-1, 1), (-1, -1)])
        out[..., ch] = g * (s / 1024.0) / np.maximum(c, 1)
        out[mask, ch] = raw_f[mask]
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


DEMOSAICERS = {
    "es": demosaic_es,
    "nn": demosaic_nn,
    "bl": demosaic_bl,
    "hue": demosaic_hue,
}
