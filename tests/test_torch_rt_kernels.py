"""The run-time instances' order of arithmetic == the plain versions.

On the card a window radius above 7 (and, for kernel 2, a list longer than
16 or more than 32 neighbours) takes a kernel's run-time instance, and
those compute in an order of their own:

* kernel 2, ``mvs_sweep_rt_kernel`` (csrc/mvs_sweep.cu): interior units
  wait in kRtU slots and border units in kRtB border slots, each kind
  summed in passes over the window (a tap's weight, left value x weight
  and mask read once for every slot; an interior tap off the mask
  weighing +0, a border slot's sums over its valid taps), a slot being one
  (label, neighbour) on every lane of a warp (taken when any lane has such
  a unit), a pass running when its slots are full; wholly-outside units
  fold into their label's carry at once; when kRtCL labels wait, both
  passes run and the labels enter the list in label order, through the
  streaming insertion (entry j + 1 read before entry j is written);
* kernel 4, ``cost_wta_rt_kernel`` (csrc/cost_wta.cu): the labels in
  chunks of kRtL over a zero-filled halo, validity words with the left
  validity in bit 31, a pre-pass that flags units with an invalid warp
  sample on a tap of the left validity, a group of kRtFullGroup labels
  with a flagged unit on a lane of the warp summing all seven sums on the
  warp (a failing tap weighing +0), the others the right-hand sums alone
  (weights outside the left mask -0.0, adding exact zeros) beside
  label-independent sums taken once a pixel; a radius whose halo does not
  fit shared memory unstaged.

These tests emulate each kernel's order in torch (float32, a lane a pixel,
a warp 32 pixels of a row, as the kernels' tiles make them) and hold it
bit-equal to the plain versions, which the other test files hold to the
JAX package.  Square roots are taken correctly rounded, as on the card
(torch's CPU float32 sqrt is not always), in the plain versions too.  The
card holds the kernels themselves to the plain versions (chip_smoke.py).
"""

import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

from stereoreconstruction_tpu_torch.ops.cuda_cost_wta import (
    cost_volume_plain, cost_wta_plain)
from stereoreconstruction_tpu_torch.ops.cuda_mvs import (
    mvs_topk_plain, mvs_wta_plain)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    cost_stress_inputs, same_values, sweep_stress_inputs)

torch.set_num_threads(1)

WEPS = 1e-10
# csrc/mvs_sweep.cu: kRtU, kRtB, kRtCL
SWEEP_SLOTS, SWEEP_BORDER_SLOTS, SWEEP_LABELS_WAITING = 16, 4, 128
# csrc/cost_wta.cu: kRtTW, kRtTH, kRtL, kRtFullGroup, kRtMaxSmem
COST_TW, COST_TH, COST_L, COST_GROUP, COST_MAX_SMEM = 32, 8, 8, 8, 232448
_sqrt = torch.sqrt


def exact_sqrt(x, *args, **kw):
    """float32 square roots correctly rounded, as the card takes them."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return _sqrt(x.double()).float()
    return _sqrt(x, *args, **kw)


@pytest.fixture(autouse=True)
def card_sqrt(monkeypatch):
    monkeypatch.setattr(torch, "sqrt", exact_sqrt)


def warp_ids(h, w):
    """The warp of each pixel (row-major): 32 pixels of a row."""
    per_row = -(-w // 32)
    return (torch.arange(h)[:, None] * per_row
            + torch.arange(w)[None] // 32).reshape(-1)


def warp_any(flag, warps):
    """Each pixel's warp vote: any lane of its warp has ``flag``."""
    votes = torch.zeros(int(warps.max()) + 1, dtype=torch.int32)
    votes.scatter_reduce_(0, warps, flag.to(torch.int32), "amax")
    return votes[warps].bool()


# --------------------------------------------------------------------------
# Kernel 2
# --------------------------------------------------------------------------

def left_terms(s_w, s_l, s_ll, cnt):
    have = s_w > WEPS
    s_w_safe = torch.where(have, s_w, 1.0)
    mean_l = s_l / s_w_safe
    sum2 = s_ll - 2.0 * mean_l * s_l + cnt * mean_l * mean_l
    return have, s_w_safe, s_l, mean_l, sum2, cnt


def ncc_from_sums(terms, s_r, s_rr, s_lr):
    have, s_w_safe, s_l, mean_l, sum2, cnt = terms
    mean_r = s_r / s_w_safe
    sum1 = s_lr - mean_l * s_r - mean_r * s_l + cnt * mean_l * mean_r
    sum3 = s_rr - 2.0 * mean_r * s_r + cnt * mean_r * mean_r
    prod = sum2 * sum3
    ok = prod >= WEPS
    q = sum1 / torch.sqrt(torch.where(ok, prod, 1.0))
    return torch.where(have & ok, q, 0.0)


class SweepLanes:
    """The lanes' state of kernel 2's run-time instance: carries, the slots
    of each kind (interior and border), the first waiting label and the
    list (or WTA carry), a pixel a lane."""

    def __init__(self, n_pix, top_k, depths, label0):
        self.wta = top_k is None
        k = 1 if self.wta else top_k
        self.carry = torch.full((SWEEP_LABELS_WAITING + 1, n_pix), np.nan)
        self.slots = {
            kind: dict(cap=cap, q=torch.zeros((cap, n_pix)),
                       lab=torch.zeros((cap, n_pix), dtype=torch.int64),
                       on=torch.zeros((cap, n_pix), dtype=torch.bool),
                       n=torch.zeros(n_pix, dtype=torch.int64))
            for kind, cap in (("interior", SWEEP_SLOTS),
                              ("border", SWEEP_BORDER_SLOTS))}
        self.i_first = torch.zeros(n_pix, dtype=torch.int64)
        self.l_n = torch.full((k, n_pix), -torch.inf)
        self.l_d = torch.full((k, n_pix), -1.0)
        self.lo = torch.full((n_pix,), -torch.inf)
        self.depths, self.label0 = depths, label0
        self.passes = {"interior": 0, "border": 0, "labels waiting": 0}

    def fold(self, lanes, rel, q, thr):
        """Fold NCC ``q`` into the carry ``rel`` of ``lanes`` (fmaxf)."""
        cur = self.carry.gather(0, rel[None])[0]
        new = torch.fmax(cur, torch.where(q > thr, q, -torch.inf))
        self.carry.scatter_(0, rel[None], torch.where(lanes, new, cur)[None])

    def take(self, kind, warp, on, q, rel):
        """A slot of ``kind`` where ``warp`` (any lane of the warp has such a
        unit), on where ``on``, holding the unit's NCC and label."""
        sl = self.slots[kind]
        at = sl["n"].clamp(max=sl["cap"] - 1)[None]
        for key, val in (("q", q), ("lab", rel), ("on", on)):
            sl[key].scatter_(0, at, torch.where(
                warp, val, sl[key].gather(0, at)[0])[None])
        sl["n"] = sl["n"] + warp.long()

    def run_pass(self, kind, lanes, thr):
        """A pass of ``kind`` on ``lanes``: each slot's NCC into its
        label's carry."""
        sl = self.slots[kind]
        if not bool((lanes & (sl["n"] > 0)).any()):
            return
        self.passes[kind] += 1
        for u in range(sl["cap"]):
            self.fold(lanes & (u < sl["n"]) & sl["on"][u], sl["lab"][u],
                      sl["q"][u], thr)
        sl["n"] = torch.where(lanes, 0, sl["n"])

    def insert(self, lanes, m, depth):
        """The streaming insertion of (m, depth) where ``lanes``."""
        if self.wta:
            up = lanes & (self.lo <= m)
            self.l_n[0] = torch.where(up, m, self.l_n[0])
            self.l_d[0] = torch.where(up, depth, self.l_d[0])
            self.lo = torch.where(up, m, self.lo)
            return
        up = lanes & (m > -torch.inf) & (self.lo <= m)
        k = self.l_n.shape[0]
        t_n, t_d = self.l_n[0].clone(), self.l_d[0].clone()
        for j in range(k):
            last = j + 1 == k
            u_n = torch.full_like(m, torch.inf) if last \
                else self.l_n[j + 1].clone()
            u_d = torch.full_like(m, -1.0) if last else self.l_d[j + 1].clone()
            nxt = (u_n <= m) & (not last)
            here = t_n <= m
            self.l_n[j] = torch.where(
                up, torch.where(nxt, u_n, torch.where(here, m, t_n)),
                self.l_n[j])
            self.l_d[j] = torch.where(
                up, torch.where(nxt, u_d, torch.where(here, depth, t_d)),
                self.l_d[j])
            t_n, t_d = u_n, u_d
        self.lo = torch.where(up, self.l_n[0], self.lo)

    def complete(self, lanes, i, active, thr):
        """Both passes on ``lanes``, then labels [i_first, i) into their
        lists in order."""
        if not bool(lanes.any()):
            return
        self.passes["labels waiting"] += 1
        self.run_pass("interior", lanes, thr)
        self.run_pass("border", lanes, thr)
        ins = lanes & active
        for j in range(int(self.i_first[lanes].min()), i):
            sel = ins & (self.i_first <= j)
            rel = (j - self.i_first).clamp(min=0)
            self.insert(sel, self.carry.gather(0, rel[None])[0],
                        self.depths[self.label0 + j])
        self.i_first = torch.where(lanes, i, self.i_first)


def unit_nccs(x2, y2, gray, on, w, wl, terms, radius):
    """The NCCs of units [L, N, P] on the interior path (a tap off the mask
    weighs +0 in the window passes, adding exact zeros) and on the border
    path (the valid taps, each read at its clamped index, in tap order)."""
    n_img, hs, ws = gray.shape
    size = 2 * radius + 1
    ixf = torch.floor(x2.clamp(-1e6, 1e6))
    iyf = torch.floor(y2.clamp(-1e6, 1e6))
    nidx = torch.arange(n_img)[:, None]
    z = torch.zeros_like(x2)
    s_r = s_rr = s_lr = z
    b = [z] * 7                                   # w l r ll rr lr cnt
    for r in range(size):
        yr = y2 + float(r - radius)
        row_ok = (yr > -1.0) & (yr < hs)
        jy = (iyf + float(r - radius)).clamp(0, hs - 1).long()
        for c in range(size):
            k = r * size + c
            xc = x2 + float(c - radius)
            jx = (ixf + float(c - radius)).clamp(0, ws - 1).long()
            g = gray[nidx, jy, jx]
            w0 = torch.where(on[k], w[k], 0.0)
            wr0 = w0 * g
            s_r = s_r + wr0
            s_rr = s_rr + wr0 * wr0
            s_lr = s_lr + torch.where(on[k], wl[k], 0.0) * wr0
            wr = w[k] * g
            tap = row_ok & (xc > -1.0) & (xc < ws) & on[k]
            terms_k = (w[k], wl[k], wr, wl[k] * wl[k], wr * wr, wl[k] * wr,
                       1.0)
            b = [torch.where(tap, acc + t, acc) for acc, t in zip(b, terms_k)]
    q_in = ncc_from_sums(terms, s_r, s_rr, s_lr)
    q_bd = ncc_from_sums(left_terms(b[0], b[1], b[3], b[6]), b[2], b[4],
                         b[5])
    return q_in, q_bd


def emulate_sweep(inputs, nbr_valid, radius, thr, top_k=None):
    """Kernel 2's run-time instance in its order.  Returns (ncc, depth),
    each [K, H, W] ([H, W] for the WTA), and the passes by cause."""
    coords, gray = inputs["coords"], inputs["gray_nbr"]
    n_lab, n_nbr, _, h, w = coords.shape
    hs, ws = gray.shape[1:]
    n_tap = (2 * radius + 1) ** 2
    wts = inputs["weights"].reshape(n_tap, -1)
    on = inputs["lv"].reshape(n_tap, -1) & (wts > WEPS)
    # a pass forms each tap's left value x weight once for all its slots
    wl = wts * inputs["gl"].reshape(n_tap, -1)
    z = torch.zeros(h * w)
    h_w = h_l = h_ll = cnt = z
    for k in range(n_tap):
        h_w = torch.where(on[k], h_w + wts[k], h_w)
        h_l = torch.where(on[k], h_l + wl[k], h_l)
        h_ll = torch.where(on[k], h_ll + wl[k] * wl[k], h_ll)
        cnt = torch.where(on[k], cnt + 1.0, cnt)
    terms = left_terms(h_w, h_l, h_ll, cnt)
    # every unit's NCC on either path (a unit's sums do not depend on when
    # its pass runs)
    x2 = coords[:, :, 0].reshape(n_lab, n_nbr, -1)
    y2 = coords[:, :, 1].reshape(n_lab, n_nbr, -1)
    q_in, q_bd = unit_nccs(x2, y2, gray, on, wts, wl, terms, radius)
    ixf = torch.floor(x2.clamp(-1e6, 1e6))
    iyf = torch.floor(y2.clamp(-1e6, 1e6))
    rr = float(radius)
    outside = ~((x2 + rr > -1) & (x2 - rr < ws) & (y2 + rr > -1)
                & (y2 - rr < hs))
    inner = ((ixf - rr >= 0) & (ixf + rr <= ws - 1) & (x2 - rr > -1)
             & (x2 + rr < ws) & (iyf - rr >= 0) & (iyf + rr <= hs - 1)
             & (y2 - rr > -1) & (y2 + rr < hs))
    active = torch.ones(h * w, dtype=torch.bool)
    if top_k is None and inputs.get("center_valid") is not None:
        active = inputs["center_valid"].reshape(-1).clone()
    warps = warp_ids(h, w)
    lanes = SweepLanes(h * w, top_k, inputs["depths"], inputs["label0"])
    everyone = torch.ones(h * w, dtype=torch.bool)
    empty = torch.full((h * w,), 0.0 if 0.0 > thr else -torch.inf)
    for i in range(n_lab):
        lanes.complete((i - lanes.i_first) == SWEEP_LABELS_WAITING, i,
                       active, thr)
        rel = i - lanes.i_first
        lanes.carry.scatter_(0, rel[None], torch.full((1, h * w),
                                                      -torch.inf))
        for n in range(n_nbr):
            for kind in ("interior", "border"):
                sl = lanes.slots[kind]
                lanes.run_pass(kind, sl["n"] == sl["cap"], thr)
            unit = active & bool(nbr_valid[n]) & (x2[i, n] > -1e6)
            lanes.fold(unit & outside[i, n], rel, empty, thr)
            for kind, units, q in (
                    ("interior", unit & ~outside[i, n] & inner[i, n],
                     q_in[i, n]),
                    ("border", unit & ~outside[i, n] & ~inner[i, n],
                     q_bd[i, n])):
                lanes.take(kind, warp_any(units, warps), units, q, rel)
    lanes.complete(everyone, n_lab, active, thr)
    ncc = torch.where(active, lanes.l_n, -torch.inf).reshape(-1, h, w)
    depth = torch.where(active, lanes.l_d, -1.0).reshape(-1, h, w)
    if top_k is None:
        return ncc[0], depth[0], lanes.passes
    return ncc, depth, lanes.passes


SWEEP_CASES = {
    # name: (radius, top_k (None: the WTA), sweep_stress_inputs kwargs,
    #        threshold or None for the input's, rows of the input kept)
    "r8_wta": (8, None, {}, None, 8),
    "r8_k17_fill_evict": (8, 17, dict(n_lab=24), -1.0, 4),
    "r8_k32_fill_evict": (8, 32, dict(n_lab=36), -1.0, 4),
    "r8_k34_fill_evict": (8, 34, dict(n_lab=36), -1.0, 4),
    "r8_k32_40_neighbours": (8, 32, dict(n_nbr=40, n_lab=4), None, 4),
    "r17_wta": (17, None, dict(n_lab=8), None, 4),
    "r17_k32": (17, 32, dict(n_lab=8), None, 4),
    # one valid neighbour and the base samples of most labels invalid: few
    # slots, so labels wait (kRtCL) for a pass, twice and a partial window
    "r2_k17_labels_waiting": (2, 17, dict(n_nbr=2, n_lab=270), None, 4),
}


def crop_sweep(inputs, rows):
    """The stress input's first ``rows`` rows (a ragged 83-pixel width)."""
    out = dict(inputs)
    for key in ("gl", "lv", "weights", "center_valid", "coords"):
        out[key] = inputs[key][..., :rows, :].contiguous()
    return out


@pytest.mark.parametrize("case", list(SWEEP_CASES))
def test_sweep_rt_order_matches_plain(case):
    radius, top_k, kw, thr, rows = SWEEP_CASES[case]
    s_in, s_nv, s_thr = sweep_stress_inputs(torch.device("cpu"), radius,
                                            **kw)
    s_in = crop_sweep(s_in, rows)
    if case.endswith("labels_waiting"):
        sentinel = np.random.default_rng(1).uniform(size=kw["n_lab"]) < 0.85
        s_in["coords"][torch.as_tensor(sentinel), :, 0] = -3e6
    thr = s_thr if thr is None else thr
    args = dict(nbr_valid=s_nv, radius=radius, thr=thr)
    if top_k is None:
        want = mvs_wta_plain(**args, **s_in)
    else:
        no_c = {k: v for k, v in s_in.items() if k != "center_valid"}
        want = mvs_topk_plain(top_k=top_k, **args, **no_c)
    ncc, depth, passes = emulate_sweep(s_in, s_nv, radius, thr, top_k)
    assert torch.equal(ncc, want[0]) and torch.equal(depth, want[1])
    assert int(torch.isfinite(ncc).sum()) > 0
    if thr == -1.0:
        # every list fills, and evicts where there are more labels
        assert bool(torch.isfinite(ncc).all())
    if case.endswith("labels_waiting"):
        assert passes["labels waiting"] >= 3
    else:
        assert passes["interior"] >= 1 and passes["border"] >= 1
    if case.startswith("r8_k"):
        # passes whose slots filled, before the last
        assert passes["interior"] > 1 and passes["border"] > 1


# --------------------------------------------------------------------------
# Kernel 4
# --------------------------------------------------------------------------

def ncc_cost(s_w, s_l, s_r, s_ll, s_rr, s_lr, n, max_color_diff, bad_ret):
    have = s_w > WEPS
    s_w_safe = torch.where(have, s_w, 1.0)
    mean_l = s_l / s_w_safe
    mean_r = s_r / s_w_safe
    sum1 = s_lr - mean_l * s_r - mean_r * s_l + n * mean_l * mean_r
    sum2 = s_ll - 2.0 * mean_l * s_l + n * mean_l * mean_l
    sum3 = s_rr - 2.0 * mean_r * s_r + n * mean_r * mean_r
    v = 255.0 * (1.0 - sum1.abs() / torch.sqrt(sum2 * sum3))
    v = torch.where(torch.isnan(v), max_color_diff,
                    torch.where(v < max_color_diff, v, max_color_diff))
    return torch.where(have, v, bad_ret)


def cost_staged(radius):
    """Whether the radius's halo fits a block (rt_smem_bytes)."""
    cells = (COST_TH + 2 * radius) * (COST_TW + 2 * radius)
    return cells * (4 * COST_L + 8) <= COST_MAX_SMEM


def emulate_cost(depths, warped, wvalid, gray, left, weights, *, radius,
                 max_color_diff=120.0, bad_ret=1000.0):
    """Kernel 4's run-time instance in its order.  Returns the WTA's
    (min_cost, second, best), the volume and the units by pass.  A label's
    sums on either pass do not depend on its chunk: they are taken for
    every label at once, and each chunk picks its warps' pass."""
    n_lab, h, w = warped.shape
    size = 2 * radius + 1
    pad = (radius,) * 4
    # the halo: zeros outside the image; the left validity its own bit
    r_pad = torch.nn.functional.pad(warped[None], pad)[0]
    v_pad = torch.nn.functional.pad(wvalid[None], pad, value=False)[0]
    g_pad = torch.nn.functional.pad(gray[None], pad)[0]
    l_pad = torch.nn.functional.pad(left[None], pad, value=False)[0]
    wts = weights.reshape(size * size, h * w)
    z = torch.zeros(h * w)
    zl = torch.zeros((n_lab, h * w))
    h_w = h_l = h_ll = h_n = z
    sr = srr = slr = zl
    full = [zl] * 6                               # w l r ll rr lr
    sn = torch.zeros((n_lab, h * w), dtype=torch.int64)
    all_valid = torch.ones((n_lab, h * w), dtype=torch.bool)
    for s in range(size):
        for t in range(size):
            w_raw = wts[s * size + t]
            lb = l_pad[s:s + h, t:t + w].reshape(-1)
            g = g_pad[s:s + h, t:t + w].reshape(-1)
            vb = v_pad[:, s:s + h, t:t + w].reshape(n_lab, -1)
            r = r_pad[:, s:s + h, t:t + w].reshape(n_lab, -1)
            on = lb & (w_raw > WEPS)
            # the label-independent sums (a skipped tap adds +0)
            wl = w_raw * g
            h_w = h_w + torch.where(on, w_raw, 0.0)
            h_l = h_l + torch.where(on, wl, 0.0)
            h_ll = h_ll + torch.where(on, wl * wl, 0.0)
            h_n = h_n + torch.where(on, 1.0, 0.0)
            # the pre-pass over the taps of the left validity
            all_valid &= vb | ~lb
            # hoisted: the right-hand sums alone, -0.0 off the left mask
            wk = torch.where(on, w_raw, -0.0)
            wr = wk * r
            sr = sr + wr
            srr = srr + wr * wr
            slr = slr + (wk * g) * wr
            # full: every sum, +0 where the mask or the sample fails
            b = on & vb
            wj = torch.where(b, w_raw, 0.0)
            wlj = wj * g
            wrj = wj * r
            terms = (wj, wlj, wrj, wlj * wlj, wrj * wrj, wlj * wrj)
            full = [acc + term for acc, term in zip(full, terms)]
            sn = sn + b.long()
    hoist_cost = ncc_cost(h_w, h_l, sr, h_ll, srr, slr, h_n,
                          max_color_diff, bad_ret)
    full_cost = ncc_cost(*full, sn.float(), max_color_diff, bad_ret)
    centre = wvalid.reshape(n_lab, -1)
    warps = warp_ids(h, w)
    staged = cost_staged(radius)
    units = {"hoisted": 0, "full": 0}
    cost = torch.empty((n_lab, h * w))
    for g0 in range(0, n_lab, COST_GROUP):
        # a group of labels with a unit that is not on a lane of the warp
        # takes the full pass on the warp (chunks are whole groups)
        grp = slice(g0, g0 + COST_GROUP)
        broken = (centre[grp] & ~all_valid[grp]).any(dim=0)
        by_full = warp_any(broken, warps) if staged \
            else torch.ones(h * w, dtype=torch.bool)
        units["hoisted"] += int((centre[grp] & ~by_full).sum())
        units["full"] += int((centre[grp] & by_full).sum())
        cost[grp] = torch.where(centre[grp], torch.where(
            by_full, full_cost[grp], hoist_cost[grp]), torch.inf)
    min_c = torch.full((h * w,), torch.inf)
    second = torch.full((h * w,), torch.inf)
    best = torch.full((h * w,), torch.nan)
    for d in range(n_lab):
        better = cost[d] + 1e-10 < min_c
        second = torch.where(better, min_c, second)
        min_c = torch.where(better, cost[d], min_c)
        best = torch.where(better, depths[d], best)
    wta = tuple(x.reshape(h, w) for x in (min_c, second, best))
    return wta, cost.reshape(n_lab, h, w), units


def small_cost_inputs(radius, n_lab, seed=3, h=14, w=40):
    """Random cost inputs at h x w (a ragged warp) with holes in the left
    and warp validity."""
    rng = np.random.default_rng(seed)
    size = 2 * radius + 1

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype)

    wvalid = rng.uniform(size=(n_lab, h, w)) > 0.05
    wvalid[:, :, 30:] = True
    return (t(np.sort(rng.uniform(40.0, 90.0, n_lab))),
            t(rng.uniform(0.0, 255.0, (n_lab, h, w))), t(wvalid, torch.bool),
            t(rng.uniform(0.0, 255.0, (h, w))),
            t(rng.uniform(size=(h, w)) > 0.05, torch.bool),
            t(rng.uniform(0.0, 1.0, (size, size, h, w))))


COST_CASES = {
    # name: (radius, inputs)
    "r8_stress_13_labels": (8, lambda: cost_stress_inputs(
        torch.device("cpu"), 8)),
    "r17_stress_17_labels": (17, lambda: cost_stress_inputs(
        torch.device("cpu"), 17, n_lab=17)),
    "r29_unstaged": (29, lambda: small_cost_inputs(29, 3)),
}


@functools.lru_cache(maxsize=None)
def cost_case(case):
    radius, make = COST_CASES[case]
    args = make()
    return args, emulate_cost(*args, radius=radius)


@pytest.mark.parametrize("volume", [False, True], ids=["wta", "volume"])
@pytest.mark.parametrize("case", list(COST_CASES))
def test_cost_rt_order_matches_plain(case, volume):
    radius = COST_CASES[case][0]
    args, (wta, vol, units) = cost_case(case)
    kw = dict(radius=radius, max_color_diff=120.0, bad_ret=1000.0)
    assert cost_staged(radius) == (radius < 29)
    if volume:
        got, want = (vol,), (cost_volume_plain(*args[1:], **kw),)
    else:
        got, want = wta, cost_wta_plain(*args, **kw)
    assert all(same_values(g, x) for g, x in zip(got, want))
    assert units["full"] > 0
    if cost_staged(radius):
        assert units["hoisted"] > 0
