"""Kernel 4 (the two-view cost, ``cuda_cost_wta`` / ``cuda_cost_volume``):
the least time of its work on a pair's inputs over the device time
launched inside its calls, in % of the H100's roofline.

The work is counted from the cell's shapes and the rig's geometry, which
fixes where the warped samples are valid whatever the scene: each input
read once (warped plane and its validity [D, H, W], gray, left validity,
weights [S, S, H, W], labels) and each output written once (three [H, W]
planes, or the [D, H, W] volume); operations for what these inputs need:
each pixel's label-independent sums 6 a left-mask tap (left valid, weight
above 1e-10); a (pixel, label) unit with a valid sample 6 a left-mask tap
where every left-mask tap has a valid warped sample, else 12 a tap valid on
both sides (the left-hand sums again); 30 a unit for the cost and the WTA.
"""

import torch
import torch.nn.functional as F

from portbench import peaks
from portbench.readers import TWOVIEW, roofline_pct
from portbench.reference import geometry as g
from portbench.reference.pair import coords, warp
from portbench.reference.mvs import gray_of
from portbench.reference.weights import geodesic_weights

SHIMS = [(TWOVIEW, "cuda_cost_wta"), (TWOVIEW, "cuda_cost_volume")]
PER_UNIT = 30


def _ops(left_valid, weights, wvalid, radius):
    size = 2 * radius + 1
    n, h, w = wvalid.shape
    pad = (radius,) * 4
    lpad = F.pad(left_valid[None], pad, value=False)[0]
    vpad = F.pad(wvalid, pad, value=False)
    offs = [(a, b) for a in range(size) for b in range(size)]
    left = [lpad[a:a + h, b:b + w] & (weights[a, b] > 1e-10)
            for a, b in offs]
    n_left = sum(m.to(torch.int64) for m in left)
    broken = torch.zeros_like(wvalid)
    for m, (a, b) in zip(left, offs):
        broken |= m & ~vpad[:, a:a + h, b:b + w]
    hoisted = wvalid & ~broken
    full = wvalid & broken
    full_taps = sum(int((m & vpad[:, a:a + h, b:b + w] & full).sum())
                    for m, (a, b) in zip(left, offs))
    return (6 * int(n_left.sum()) + 6 * int((n_left * hoisted).sum())
            + 12 * full_taps + PER_UNIT * int(wvalid.sum()))


def prepare(run):
    """The least seconds of one request's cost calls (both views)."""
    s = run.config["settings"]
    dev = run.device
    radius = s["window_radius"]
    size = 2 * radius + 1
    n_lab = s["num_depth_levels"]
    volume = run.traffic["flow"] == "mrf"
    cams = [g.make_cam(c, torch.float32, dev) for c in run.rig]
    depths = g.labels_twoview(s["min_depth"], s["max_depth"], n_lab,
                              torch.float32, dev)
    rgbs = run.pool.rgbs[0]
    grays = gray_of(rgbs)
    masks = run.pool.masks
    _, _, h, w, _ = run.pool.rgbs.shape
    total = 0.0
    for a, b in ((0, 1), (1, 0)):
        wts = geodesic_weights(rgbs[a], radius,
                               s["weights"]["geodesic_sigma"],
                               s["weights"]["geodesic_iters"])
        left_valid = masks[a].clone()
        left_valid[-1, :] = False
        left_valid[:, -1] = False
        x2, y2 = coords(cams[a], cams[b], h, w, s, depths)
        _, wvalid = warp(x2, y2, grays[b], masks[b])
        ops = _ops(left_valid, wts, wvalid, radius)
        n_bytes = ((4 + 1) * n_lab * h * w + (4 + 1) * h * w
                   + 4 * size * size * h * w + 4 * n_lab
                   + 4 * (n_lab if volume else 3) * h * w)
        total += peaks.least_seconds(n_bytes, ops)
    return total


def read(run):
    return roofline_pct(run, ("cuda_cost_wta", "cuda_cost_volume"),
                        run.prepared.get("cost_roofline_pct"))
