"""Multi-view depth maps (Campbell et al. 2008), in plain PyTorch.

For each view: its <= N nearest cameras whose principal rays are within
acos(view_angle_cos_min); a uniform sweep of depth labels; at each label the
geodesic-weighted NCC of the view's (2r+1)^2 window against each neighbour's
integer-pixel window at the projected match point; a label is a peak where
the best neighbour's NCC exceeds ``ncc_threshold``.  Without the MRF the
best peak wins (ties to the larger depth), -1 where there is none; with it
the K best peaks of each pixel are the labels of ``mrf.trws``.  Then the
sequential any-view cross-check: a depth stays only where some other view's
current depth map, read at its projection, gives a 3D point within
``cross_check_threshold``; NaN where none does.

This file imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from . import geometry as g
from .mrf import trws
from .weights import geodesic_weights, window_patches, window_valid

WEPS = 1e-10
CHUNK = 20          # depth labels swept at once


def gray_of(rgb):
    return 0.11 * rgb[..., 0] + 0.59 * rgb[..., 1] + 0.3 * rgb[..., 2]


def neighbours(cams, n_max, cos_min):
    """Each view's neighbour indices: the nearest centres among the cameras
    whose principal rays satisfy |cos| > cos_min (host, float64)."""
    dirs, centers = [], []
    for c in cams:
        K, R = (np.asarray(c[k], np.float64) for k in ("K", "R"))
        d = np.linalg.inv(K) @ (K[:, 2] / K[2, 2])
        dirs.append(R.T @ (d / np.linalg.norm(d)))
        centers.append(g.center(c))
    out = []
    for i in range(len(cams)):
        cands = sorted((float(np.sum((centers[i] - centers[j]) ** 2)), j)
                       for j in range(len(cams))
                       if j != i and abs(float(dirs[i] @ dirs[j])) > cos_min)
        out.append([j for _, j in cands[:n_max]])
    return out


def ncc_from_sums(S_w, S_l, S_r, S_ll, S_rr, S_lr, N):
    """The weighted NCC of a window from its seven sums; 0 for an empty or
    flat window."""
    have = S_w > WEPS
    S_w_safe = torch.where(have, S_w, 1.0)
    meanL = S_l / S_w_safe
    meanR = S_r / S_w_safe
    sum1 = S_lr - meanL * S_r - meanR * S_l + N * meanL * meanR
    sum2 = S_ll - 2 * meanL * S_l + N * meanL * meanL
    sum3 = S_rr - 2 * meanR * S_r + N * meanR * meanR
    ok = sum2 * sum3 >= WEPS
    ncc = sum1 / torch.sqrt(torch.where(ok, sum2 * sum3, 1.0))
    return torch.where(have & ok, ncc, 0.0)


def peak_ncc(x2, y2, grays_nbr, gl, lv, wts, radius, thr):
    """The best neighbour's NCC at each (label, pixel), -inf where no
    neighbour peaks.  x2/y2 [D, N, H, W] scaled match coordinates (-3e6
    where invalid); grays_nbr [N, hs, ws]; gl, lv, wts [S, S, H, W]."""
    n_nbr, hs, ws = grays_nbr.shape
    ixf = torch.floor(x2.clamp(-1e6, 1e6)).to(torch.int64)
    iyf = torch.floor(y2.clamp(-1e6, 1e6)).to(torch.int64)
    nidx = torch.arange(n_nbr, device=x2.device)[:, None, None]
    sums = None
    for r in range(-radius, radius + 1):
        jy = (iyf + r).clamp(0, hs - 1)
        row_ok = ((y2 + r) > -1.0) & ((y2 + r) < hs)
        for c in range(-radius, radius + 1):
            jx = (ixf + c).clamp(0, ws - 1)
            gr = grays_nbr[nidx, jy, jx]
            rv = row_ok & ((x2 + c) > -1.0) & ((x2 + c) < ws)
            w = wts[r + radius, c + radius]
            m = (lv[r + radius, c + radius] & rv & (w > WEPS)).to(x2.dtype)
            wl = w * gl[r + radius, c + radius]
            wr = w * gr
            terms = (m * w, m * wl, m * wr, m * wl * wl, m * wr * wr,
                     m * wl * wr, m)
            sums = list(terms) if sums is None else \
                [s + t for s, t in zip(sums, terms)]
    ncc = torch.where(x2 > -1e6, ncc_from_sums(*sums), -torch.inf)
    ncc = torch.where(ncc > thr, ncc, -torch.inf)
    return ncc.amax(dim=1)


def view_peaks(rgb, gray, grays_nbr, cam, cams_nbr, s, depths):
    """[D, H, W] best-neighbour NCC peaks of one view over every label."""
    h, w = gray.shape
    radius = s["window_radius"]
    wts = geodesic_weights(rgb, radius, s["weights"]["geodesic_sigma"],
                           s["weights"]["geodesic_iters"])
    gl = window_patches(gray, radius)
    lv = window_valid(h, w, radius, gray.device)
    o, d = g.pixel_rays(cam, h, w, s["image_scale"])
    normal = g.principal_ray(cam)
    out = []
    for l0 in range(0, depths.shape[0], CHUNK):
        pts, pv = g.point_from_depth(o, d, cam.C, normal,
                                     depths[l0:l0 + CHUNK, None, None])
        xy = torch.stack([g.match_coords(c, pts, pv, s["image_scale"])
                          for c in cams_nbr], dim=1)          # [D, N, H, W, 2]
        out.append(peak_ncc(xy[..., 0], xy[..., 1], grays_nbr, gl, lv, wts,
                            radius, s["ncc_threshold"]))
    return torch.cat(out)


def wta_depth(peaks, depths, mask):
    """The best peak's depth (ties to the larger depth), -1 without a peak,
    inf where masked."""
    best = peaks.amax(dim=0)
    idx = torch.arange(peaks.shape[0], device=peaks.device)[:, None, None]
    last = torch.where(peaks == best, idx, -1).amax(dim=0)
    depth = torch.where(torch.isfinite(best), depths[last], -1.0)
    return torch.where(mask, depth, torch.inf)


def mrf_depth(peaks, depths, mask, s, stats=None):
    """The Campbell MRF over each pixel's K best peaks (ascending, ties to
    the later label), inf where masked or where it picks "unknown";
    appends its iterations to ``stats`` where given."""
    K = s["top_k"]
    order = torch.sort(peaks, dim=0, stable=True).indices[-K:]
    top_ncc = peaks.gather(0, order)
    top_depth = torch.where(torch.isfinite(top_ncc), depths[order], -1.0)
    top_ncc = torch.where(torch.isfinite(top_ncc), top_ncc, 0.0)
    lab, n = trws(top_ncc, top_depth.to(top_ncc.dtype), s)
    lab = lab.to(torch.int64)
    if stats is not None:
        stats.append(n)
    ext = torch.cat([top_depth, torch.full_like(top_depth[:1], -1.0)])
    depth = ext.gather(0, lab[None])[0]
    depth = torch.where((lab == K) | (depth <= 0), torch.inf, depth)
    return torch.where(mask, depth, torch.inf)


def nearest(src, x2, y2):
    """src [hs, ws] read at clip(trunc(.)) of x2/y2: (values, finite)."""
    hs, ws = src.shape

    def index(x, n):
        x = torch.where(torch.isfinite(x), x, -1.0).clamp(-1.0, float(n))
        return torch.trunc(x).to(torch.int64).clamp(0, n - 1)

    v = src[index(y2, hs), index(x2, ws)]
    fin = torch.isfinite(v)
    return torch.where(fin, v, 0.0), fin


def cross_check(depths, cams, s):
    """The sequential any-view cross-check of depths [V, H, W], computed in
    the cameras' dtype; the maps keep the dtype of ``depths``."""
    state = depths.clone()
    n_views, h, w = state.shape
    dt = cams[0].K.dtype
    scale = s["image_scale"]
    normals = [g.principal_ray(c) for c in cams]
    for i, cam in enumerate(cams):
        ref = state[i]
        o, d = g.pixel_rays(cam, h, w, scale)
        finite = torch.isfinite(ref)
        p1, v1 = g.point_from_depth(o, d, cam.C, normals[i],
                                    torch.where(finite, ref, 1.0).to(dt))
        found = torch.zeros_like(finite)
        for j, oth in enumerate(cams):
            if j == i:
                continue
            xy, vproj = g.project(oth, p1)
            x2, y2 = xy[..., 0] * scale, xy[..., 1] * scale
            od, ofin = nearest(state[j], x2, y2)
            inside = (x2 >= 0) & (y2 >= 0) & (x2 < w) & (y2 < h)
            oxy = torch.stack([(x2 + 0.5) / scale, (y2 + 0.5) / scale], -1)
            o2, d2 = g.unproject(oth, oxy)
            p2, v2 = g.point_from_depth(o2, d2, oth.C, normals[j],
                                        torch.where(ofin, od, 1.0).to(dt))
            dist = g.norm(p1 - p2)
            found |= (vproj & inside & ofin & v2 & torch.isfinite(dist)
                      & (dist < s["cross_check_threshold"]))
        state[i] = torch.where(finite & v1 & ~found, torch.nan, ref)
    return state


def depth_maps(rgbs, masks, rig, s, flow, dtype=torch.float32, stats=None):
    """Depth maps [V, H, W] of one frame: rgbs [V, H, W, 3] (0..255),
    masks [V, H, W], rig the cameras' float64 dicts, s the engine's
    settings, flow "wta" or "mrf"; ``stats`` (a list) collects each view's
    TRW-S iterations.  Every sum, coordinate and message is computed in
    ``dtype``; the label table and the maps stay float32, so that a depth is
    a label's float32 value whatever ``dtype`` is."""
    dev = rgbs.device
    rgbs = rgbs.to(dtype)
    grays = gray_of(rgbs)
    cams = [g.make_cam(c, dtype, dev) for c in rig]
    labels = g.labels_uniform(s["min_depth"], s["max_depth"],
                              s["num_depth_levels"], torch.float32, dev)
    out = []
    for i, nbr in enumerate(neighbours(rig, s["num_neighbouring_views"],
                                       s["view_angle_cos_min"])):
        peaks = view_peaks(rgbs[i], grays[i], grays[nbr], cams[i],
                           [cams[j] for j in nbr], s, labels.to(dtype))
        out.append(mrf_depth(peaks, labels, masks[i], s, stats)
                   if flow == "mrf"
                   else wta_depth(peaks, labels, masks[i]))
    return cross_check(torch.stack(out), cams, s)
