"""Two-view depth maps, in plain PyTorch.

For each view of the pair against the other: depth labels spaced as
t / (5 - 4t); at each label the other view warped bilinearly onto the
view's grid (gray and mask*255 rounded to bfloat16, the x weights too, a
sample valid inside [0, w-1) x [0, h-1) and where the warped mask is above
254); the geodesic-weighted NCC over the (2r+1)^2 window of warped samples,
as the cost min(120, 255 (1 - |ncc|)), 1000 for an empty window, +inf where
the pixel's own sample is invalid.  Without the MRF the sequential WTA keeps
a label only where it improves by more than 1e-10 and rejects (+inf) a
pixel whose best cost exceeds 0.95 of the best before it; with the MRF the
labels of ``mrf.bp``.  Masked pixels are NaN.  Then the symmetric
cross-check, left first: a depth whose 3D point disagrees by more than
``inconsistency_thresh`` with the point the other map gives at its
projection becomes +inf.

This file imports nothing of the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import geometry as g
from .mrf import bp
from .mvs import gray_of, nearest
from .weights import geodesic_weights

WEPS = 1e-10


def coords(cam, oth, h, w, s, depths):
    """Match coordinates of every label in the other view: x2, y2
    [D, H, W], -3e6 where invalid."""
    o, d = g.pixel_rays(cam, h, w, s["image_scale"])
    pts, pv = g.point_from_depth(o, d, cam.C, g.principal_ray(cam),
                                 depths[:, None, None])
    xy = g.match_coords(oth, pts, pv, s["image_scale"])
    return xy[..., 0], xy[..., 1]


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def warp(x2, y2, gray, mask):
    """The other view's gray and mask at (x2, y2): (values, valid)."""
    hs, ws = gray.shape
    src = _bf16(torch.stack([gray, mask.to(torch.float32) * 255.0]))
    src = src.reshape(2, hs * ws)
    valid = (x2 >= 0) & (y2 >= 0) & (x2 + 1 < ws) & (y2 + 1 < hs)
    x2 = torch.where(valid, x2, 0.0)
    y2 = torch.where(valid, y2, 0.0)
    ixf, iyf = torch.floor(x2), torch.floor(y2)

    def tri(x):
        return torch.clamp(1.0 - x.abs(), min=0.0)

    tx0, tx1 = _bf16(tri(x2 - ixf)), _bf16(tri(x2 - (ixf + 1.0)))
    ty0, ty1 = tri(y2 - iyf), tri(y2 - (iyf + 1.0))
    base = iyf.to(torch.int64) * ws + ixf.to(torch.int64)
    a0 = src[:, base] * tx0 + src[:, base + 1] * tx1
    a1 = src[:, base + ws] * tx0 + src[:, base + ws + 1] * tx1
    vals = torch.where(valid, a0 * ty0 + a1 * ty1, 0.0).to(x2.dtype)
    return vals[0], valid & (vals[1] > 254.0)


def cost_volume(gray, left_valid, wts, warped, wvalid, s):
    """[D, H, W] two-view costs; the window taps row by row."""
    radius = s["window_radius"]
    size = 2 * radius + 1
    D, h, w = warped.shape
    pad = (radius,) * 4
    gpad = F.pad(gray[None], pad)[0]
    lpad = F.pad(left_valid[None], pad, value=False)[0]
    wpad = F.pad(warped, pad)
    vpad = F.pad(wvalid, pad, value=False)
    S = [torch.zeros((D, h, w), dtype=warped.dtype, device=warped.device)
         for _ in range(7)]
    for a in range(size):
        for b in range(size):
            wt = wts[a, b]
            gl = gpad[a:a + h, b:b + w]
            m = (lpad[a:a + h, b:b + w] & vpad[:, a:a + h, b:b + w]
                 & (wt > WEPS)).to(warped.dtype)
            wl = wt * gl
            wr = wt * wpad[:, a:a + h, b:b + w]
            terms = (m * wt, m * wl, m * wr, m * wl * wl, m * wr * wr,
                     m * wl * wr, m)
            S = [x + t for x, t in zip(S, terms)]
    S_w, S_l, S_r, S_ll, S_rr, S_lr, N = S
    have = S_w > WEPS
    S_w_safe = torch.where(have, S_w, 1.0)
    meanL = S_l / S_w_safe
    meanR = S_r / S_w_safe
    sum1 = S_lr - meanL * S_r - meanR * S_l + N * meanL * meanR
    sum2 = S_ll - 2 * meanL * S_l + N * meanL * meanL
    sum3 = S_rr - 2 * meanR * S_r + N * meanR * meanR
    v = 255.0 * (1.0 - sum1.abs() / torch.sqrt(sum2 * sum3))
    mcd = s["max_color_diff"]
    v = torch.where(torch.isnan(v), mcd, torch.clamp(v, max=mcd))
    cost = torch.where(have, v, s["bad_ret"])
    return torch.where(wvalid, cost, torch.inf)


def wta(costs, labels):
    """The sequential WTA: (best cost, the best before it, depth)."""
    h, w = costs.shape[1:]
    kw = dict(dtype=costs.dtype, device=costs.device)
    best = torch.full((h, w), torch.inf, **kw)
    second = torch.full((h, w), torch.inf, **kw)
    depth = torch.full((h, w), torch.nan, dtype=labels.dtype,
                       device=labels.device)
    for k in range(costs.shape[0]):
        better = costs[k] + 1e-10 < best
        second = torch.where(better, best, second)
        best = torch.where(better, costs[k], best)
        depth = torch.where(better, labels[k], depth)
    return best, second, depth


def view_depth(rgb, gray, mask, gray_oth, mask_oth, cam, oth, s, flow,
               labels):
    h, w = gray.shape
    wts = geodesic_weights(rgb, s["window_radius"],
                           s["weights"]["geodesic_sigma"],
                           s["weights"]["geodesic_iters"])
    left_valid = mask.clone()
    left_valid[-1, :] = False
    left_valid[:, -1] = False
    x2, y2 = coords(cam, oth, h, w, s, labels.to(gray.dtype))
    warped, wvalid = warp(x2, y2, gray_oth, mask_oth)
    costs = cost_volume(gray, left_valid, wts, warped, wvalid, s)
    if flow == "mrf":
        lab = bp(costs, s["smoothness_lambda"], s["smoothness_max"],
                 s["smoothness_exp"])
        return torch.where(mask, labels[lab], torch.nan)
    best, second, depth = wta(costs, labels)
    depth = torch.where(best > s["second_best_factor"] * second,
                        torch.inf, depth)
    return torch.where(mask, depth, torch.nan)


def check_direction(da, db, cam_a, cam_b, s):
    """Depths of ``da`` that the other map does not confirm become +inf;
    computed in the cameras' dtype, the map keeps its own."""
    h, w = da.shape
    dt = cam_a.K.dtype
    scale = s["image_scale"]
    o, d = g.pixel_rays(cam_a, h, w, scale)
    finite = torch.isfinite(da)
    p1, v1 = g.point_from_depth(o, d, cam_a.C, g.principal_ray(cam_a),
                                torch.where(finite, da, 1.0).to(dt))
    xy, vproj = g.project(cam_b, p1)
    x2, y2 = xy[..., 0] * scale, xy[..., 1] * scale
    inside = (x2 >= 0) & (y2 >= 0) & (x2 < w) & (y2 < h)
    od, ofin = nearest(db, x2, y2)
    oxy = torch.stack([(x2 + 0.5) / scale, (y2 + 0.5) / scale], -1)
    o2, d2 = g.unproject(cam_b, oxy)
    p2, v2 = g.point_from_depth(o2, d2, cam_b.C, g.principal_ray(cam_b),
                                torch.where(ofin, od, 1.0).to(dt))
    dist = g.norm(p1 - p2)
    ok = torch.isfinite(dist) & (dist <= s["inconsistency_thresh"]) & v2
    reject = v1 & ~(vproj & inside & ofin & ok)
    return torch.where(finite & reject, torch.inf, da)


def depth_maps(rgbs, masks, rig, s, flow, dtype=torch.float32):
    """Both depth maps [2, H, W] of a pair: rgbs [2, H, W, 3] (0..255),
    masks [2, H, W], rig the two cameras' float64 dicts, s the engine's
    settings, flow "wta" or "mrf".  Every coordinate, sum and message is
    computed in ``dtype``; the label table and the maps stay float32."""
    dev = rgbs.device
    rgbs = rgbs.to(dtype)
    grays = gray_of(rgbs)
    cams = [g.make_cam(c, dtype, dev) for c in rig]
    labels = g.labels_twoview(s["min_depth"], s["max_depth"],
                              s["num_depth_levels"], torch.float32, dev)
    dl = view_depth(rgbs[0], grays[0], masks[0], grays[1], masks[1],
                    cams[0], cams[1], s, flow, labels)
    dr = view_depth(rgbs[1], grays[1], masks[1], grays[0], masks[0],
                    cams[1], cams[0], s, flow, labels)
    dl = check_direction(dl, dr, cams[0], cams[1], s)
    dr = check_direction(dr, dl, cams[1], cams[0], s)
    return torch.stack([dl, dr])
