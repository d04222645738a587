"""Kernel 2 (the MVS sweep, ``cuda_mvs_wta`` / ``cuda_mvs_topk``): the least
time of its work on a frame's inputs over the device time launched inside
its calls, in % of the H100's roofline.

The work is counted from the cell's shapes and the rig's geometry, which
fixes the match coordinates whatever the scene: each input read once
(coordinates [D, N, 2, H, W], neighbour grays, left windows, validity and
weights [S^2, H, W], labels, centre mask) and each output written once (two
[H, W] planes, or two [K, H, W] lists); operations only for what these
inputs need: a tap with a valid sample, left validity and weight above
1e-10 costs 6 where its window lies wholly inside the neighbour (the
weighted right value, its square, the cross product, three adds) and 11
where it does not (also the four left-hand sums and the count); a (pixel,
label, neighbour) unit with a valid match 19 from interior sums, 27 from
border sums; a swept pixel S^2 products and 4 a left-mask tap.
"""

import torch

from portbench import peaks
from portbench.readers import MULTIVIEW, roofline_pct
from portbench.reference import geometry as g
from portbench.reference.mvs import neighbours
from portbench.reference.weights import geodesic_weights, window_valid

SHIMS = [(MULTIVIEW, "cuda_mvs_wta"), (MULTIVIEW, "cuda_mvs_topk")]


def _view_counts(x2, y2, lmask, hs, ws, radius):
    """(interior taps, border taps, interior units, border units) of one
    chunk of labels: x2/y2 [D, N, H, W]; lmask [S, S, H, W]."""
    base = x2 > -1e6
    ixf = torch.floor(x2.clamp(-1e6, 1e6))
    iyf = torch.floor(y2.clamp(-1e6, 1e6))
    inner = ((ixf - radius >= 0) & (ixf + radius <= ws - 1)
             & (x2 - radius > -1) & (x2 + radius < ws)
             & (iyf - radius >= 0) & (iyf + radius <= hs - 1)
             & (y2 - radius > -1) & (y2 + radius < hs))
    taps = torch.zeros(x2.shape, dtype=torch.int64, device=x2.device)
    for r in range(-radius, radius + 1):
        row = ((y2 + r) > -1) & ((y2 + r) < hs)
        for c in range(-radius, radius + 1):
            col = ((x2 + c) > -1) & ((x2 + c) < ws)
            taps += (row & col & lmask[r + radius, c + radius] & base)
    t_in = int(taps[inner].sum())
    t_bd = int(taps[~inner].sum())
    u_in = int((base & inner).sum())
    u_bd = int((base & ~inner).sum())
    return t_in, t_bd, u_in, u_bd


def prepare(run):
    """The least seconds of one request's sweep calls (all its views)."""
    s = run.config["settings"]
    dev = run.device
    radius = s["window_radius"]
    size = 2 * radius + 1
    n_lab = s["num_depth_levels"]
    topk = run.traffic["flow"] == "mrf"
    k_out = s["top_k"] if topk else 1
    cams = [g.make_cam(c, torch.float32, dev) for c in run.rig]
    depths = g.labels_uniform(s["min_depth"], s["max_depth"], n_lab,
                              torch.float32, dev)
    rgbs = run.pool.rgbs[0]
    _, _, h, w, _ = run.pool.rgbs.shape
    total = 0.0
    for i, nbr in enumerate(neighbours(run.rig, s["num_neighbouring_views"],
                                       s["view_angle_cos_min"])):
        wts = geodesic_weights(rgbs[i], radius,
                               s["weights"]["geodesic_sigma"],
                               s["weights"]["geodesic_iters"])
        lmask = window_valid(h, w, radius, dev) & (wts > 1e-10)
        o, d = g.pixel_rays(cams[i], h, w, s["image_scale"])
        normal = g.principal_ray(cams[i])
        counts = [0, 0, 0, 0]
        for l0 in range(0, n_lab, 10):
            pts, pv = g.point_from_depth(o, d, cams[i].C, normal,
                                         depths[l0:l0 + 10, None, None])
            xy = torch.stack([g.match_coords(cams[j], pts, pv,
                                             s["image_scale"])
                              for j in nbr], dim=1)
            for k, v in enumerate(_view_counts(xy[..., 0], xy[..., 1], lmask,
                                               h, w, radius)):
                counts[k] += v
        t_in, t_bd, u_in, u_bd = counts
        ops = (6 * t_in + 11 * t_bd + 19 * u_in + 27 * u_bd
               + size * size * h * w + 4 * int(lmask.sum()))
        n = len(nbr)
        n_bytes = (4 * n_lab * n * 2 * h * w     # coordinates
                   + 4 * n * h * w               # neighbour grays
                   + (4 + 1 + 4) * size * size * h * w   # windows, valid, w
                   + 4 * n_lab + n + h * w       # labels, neighbours, mask
                   + 2 * 4 * k_out * h * w)      # outputs
        total += peaks.least_seconds(n_bytes, ops)
    return total


def read(run):
    return roofline_pct(run, ("cuda_mvs_wta", "cuda_mvs_topk"),
                        run.prepared.get("sweep_roofline_pct"))
