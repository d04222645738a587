"""The two MRFs of the stereo engines, in plain PyTorch.

* ``trws``: Campbell et al.'s MRF over each pixel's K depth hypotheses and
  an "unknown" label (data LAMBDA exp(-BETA ncc), LAMBDA without a peak,
  PHIU for unknown; smoothness 2|z1-z2|/(z1+z2), PSIU against unknown,
  2 PSIU against an invalid peak), minimised by damped synchronous min-sum
  message passing until the energy stops falling by more than ``eps``.
* ``bp``: the two-view dense-label MRF with truncated-linear smoothness,
  the same message passing with the closed-form distance transform.

Both follow the engines' message schedule, including its wrap-around rolls
and its left/right fields arriving unshifted, so that they minimise the
same objective by the same path.  This file imports nothing of the program
under test.
"""

from __future__ import annotations

import torch

# (roll shift, axis) of the up, down, left and right neighbours
DIRS = ((-1, 0), (1, 0), (-1, 1), (1, 1))
OPPOSITE = (1, 0, 3, 2)


def _arrive(m, d):
    return torch.roll(m, shifts=DIRS[d][0], dims=0) if d < 2 else m


def _pairwise(depths, s, shift, axis):
    """[H, W, L, L] smoothness between each pixel's labels and those of its
    neighbour ``shift`` along ``axis`` (wrapping), unknown last."""
    K, h, w = depths.shape
    zq = torch.roll(depths, shifts=-shift, dims=axis + 1)
    z1, z2 = depths[:, None], zq[None, :]
    v = 2.0 * torch.abs(z1 - z2) / torch.clamp(z1 + z2, min=1e-10)
    v = torch.where((z1 < 0) | (z2 < 0), 2.0 * s["psi_u"], v)
    V = torch.full((K + 1, K + 1, h, w), s["psi_u"], dtype=v.dtype,
                   device=v.device)
    V[:K, :K] = v
    V[K, K] = 0.0
    return V.permute(2, 3, 0, 1)


def _pair_energy(V, lab, dim):
    h, w, L, _ = V.shape
    idx = lab * L + torch.roll(lab, shifts=-1, dims=dim)
    pair = V.reshape(h, w, L * L).gather(-1, idx[..., None])[..., 0]
    return pair[:, :-1].sum() if dim == 1 else pair[:-1, :].sum()


def trws(top_ncc, top_depth, s, damping=0.5):
    """(labels [H, W] (K = unknown), iterations run) of the Campbell MRF
    over ascending hypothesis lists [K, H, W] (no-peak slots (0, -1)); ``s``
    holds beta, lam, phi_u, psi_u, mrf_max_iters, mrf_energy_eps."""
    K, h, w = top_ncc.shape
    d = torch.where(top_depth >= 0, s["lam"] * torch.exp(-s["beta"] * top_ncc),
                    s["lam"])
    D = torch.cat([d, torch.full_like(d[:1], s["phi_u"])]).permute(1, 2, 0)
    V = torch.stack([_pairwise(top_depth, s, sh, ax) for sh, ax in DIRS])

    def energy(msgs):
        lab = torch.argmin(D + msgs.sum(0), dim=-1)
        e = D.gather(-1, lab[..., None]).sum()
        return e + (_pair_energy(V[3], lab, 1)
                    + _pair_energy(V[1], lab, 0)), lab

    msgs = torch.zeros((4, h, w, K + 1), dtype=D.dtype, device=D.device)
    prev, _ = energy(msgs)
    n = 0
    for _ in range(s["mrf_max_iters"]):
        n += 1
        belief = D + msgs.sum(0)
        arrived = []
        for k in range(4):
            m = torch.amin((belief - msgs[OPPOSITE[k]])[..., :, None] + V[k],
                           dim=-2)
            arrived.append(_arrive(m - m.mean(-1, keepdim=True), k))
        msgs = damping * msgs + (1 - damping) * torch.stack(arrived)
        e, _ = energy(msgs)
        if bool(prev - e <= s["mrf_energy_eps"]):
            break
        prev = torch.minimum(e, prev)
    return energy(msgs)[1], n


def _distance_transform(h, lam, cap):
    lv = lam * torch.arange(h.shape[-1], dtype=h.dtype, device=h.device)
    fwd = lv + torch.cummin(h - lv, dim=-1).values
    bwd = -lv + torch.cummin((h + lv).flip(-1), dim=-1).values.flip(-1)
    out = torch.minimum(fwd, bwd)
    return torch.minimum(out, h.amin(dim=-1, keepdim=True) + lam * cap)


def bp(costs, lam, cap, exp=1, max_iters=50, eps=5.0, damping=0.5):
    """Labels [H, W] of the dense MRF over a cost volume [D, H, W]."""
    Dv = torch.clamp(costs, max=1e4).permute(1, 2, 0)

    def energy(msgs):
        lab = torch.argmin(Dv + msgs.sum(0), dim=-1)
        e = Dv.gather(-1, lab[..., None]).sum()
        f = lab.to(Dv.dtype)
        e = e + (lam * torch.clamp(torch.abs(f[:, 1:] - f[:, :-1]) ** exp,
                                   max=cap)).sum()
        e = e + (lam * torch.clamp(torch.abs(f[1:, :] - f[:-1, :]) ** exp,
                                   max=cap)).sum()
        return e, lab

    msgs = torch.zeros((4,) + Dv.shape, dtype=Dv.dtype, device=Dv.device)
    prev, _ = energy(msgs)
    for _ in range(max_iters):
        belief = Dv + msgs.sum(0)
        arrived = []
        for k in range(4):
            m = _distance_transform(belief - msgs[OPPOSITE[k]], lam, cap)
            arrived.append(_arrive(m - m.mean(-1, keepdim=True), k))
        msgs = damping * msgs + (1 - damping) * torch.stack(arrived)
        e, _ = energy(msgs)
        if bool(prev - e <= eps):
            break
        prev = torch.minimum(e, prev)
    return energy(msgs)[1]
