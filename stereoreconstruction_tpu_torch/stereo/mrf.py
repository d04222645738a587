"""MRF depth optimisation over hypothesis and cost volumes.

Port of ``stereoreconstruction_tpu/stereo/mrf.py``.  The reference
optionally runs Middlebury TRW-S over K=9 depth hypotheses plus an
"unknown" label with Campbell et al.'s costs (multiviewstereo.cpp:481-516,
610-651, USE_MRF builds):

  data:       label < K:  LAMBDA * exp(-BETA * ncc)   (LAMBDA if no peak)
              label = K:  PHIU
  smoothness: both unknown 0; one unknown PSIU; invalid peaks 2*PSIU;
              else 2|z1 - z2| / (z1 + z2)

As in the JAX package, the objective is minimised by synchronous min-sum
message passing with damping (a parallel TRW variant): all four directed
message fields update in lockstep as [H, W, L, L] tensor operations.  The
reference's stopping rule (energy drop <= ``mrf_energy_eps``, at most
``mrf_max_iters`` iterations) needs the energy on the host, so each
iteration ends in one device-to-host read of a scalar: a known cost of
this eager formulation (the JAX package keeps the loop on the device in a
``lax.while_loop``).

The two-view path's dense-label MRF (``twoview_bp``) runs the same message
passing with the closed-form truncated-linear distance transform.

Every function keeps the dtype of its inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MultiViewConfig
from ..runtime.trace import count, timeit

# neighbour order (up, down, left, right): (roll shift, axis) of each
# direction's neighbour, and each direction's opposite
_DIRS = ((-1, 0), (1, 0), (-1, 1), (1, 1))
_OPPOSITE = (1, 0, 3, 2)


def campbell_data_cost(top_ncc, top_depth, cfg: MultiViewConfig):
    """[K+1, H, W] data volume from the top-K (ncc, depth) peaks."""
    valid = top_depth >= 0
    d = torch.where(valid, cfg.lam * torch.exp(-cfg.beta * top_ncc), cfg.lam)
    unknown = torch.full_like(d[:1], cfg.phi_u)
    return torch.cat([d, unknown], dim=0)


def campbell_pairwise(z1, z2, cfg: MultiViewConfig):
    """Smoothness between two depth-label tensors (broadcastable): the
    depth-difference term for real labels, 2*PSIU where either is an
    invalid peak.  The "unknown" label is the caller's to handle."""
    invalid = (z1 < 0) | (z2 < 0)
    v = 2.0 * torch.abs(z1 - z2) / torch.clamp(z1 + z2, min=1e-10)
    return torch.where(invalid, 2.0 * cfg.psi_u, v)


def _pairwise_tensor(depths, cfg: MultiViewConfig, shift, axis):
    """V[p, l_p, l_q] between each pixel and its neighbour ``shift`` rows
    (axis 0) or columns (axis 1) away, wrapping around the image edge
    (``torch.roll``).  depths: [K, H, W].  Returns [H, W, L, L], L = K + 1
    (unknown last)."""
    K, h, w = depths.shape
    z_q = torch.roll(depths, shifts=-shift, dims=axis + 1)
    v = campbell_pairwise(depths[:, None], z_q[None, :], cfg)  # [K, K, H, W]
    L = K + 1
    V = torch.full((L, L, h, w), cfg.psi_u, dtype=v.dtype, device=v.device)
    V[:K, :K] = v
    V[K, K] = 0.0
    return V.permute(2, 3, 0, 1)                             # [H, W, L, L]


class MRFResult(NamedTuple):
    labels: torch.Tensor       # [H, W] int32
    energy: torch.Tensor       # [] final energy
    energies: torch.Tensor     # [max_iters] energy trace
    iterations: int            # message updates run before the stop rule


def _shift_msg(m, d):
    """Move the field of messages sent along direction ``d`` to the pixels
    they arrive at.  The up/down fields roll by one row (wrapping around);
    the left/right fields arrive unshifted, as in the JAX package, whose
    roll table holds (0, -1) and (0, 1) for them and reads each pair as
    (shift, axis), so they roll by zero (ROADMAP.md §C)."""
    if d < 2:
        return torch.roll(m, shifts=_DIRS[d][0], dims=0)
    return m


def _pair_energy(V, lab, dim):
    """Sum of V[p, lab[p], lab[q]] over each pixel p and its neighbour q
    one step along ``dim``, the wrapped edge left out."""
    h, w, L, _ = V.shape
    idx = lab * L + torch.roll(lab, shifts=-1, dims=dim)
    pair = V.reshape(h, w, L * L).gather(-1, idx[..., None])[..., 0]
    return pair[:, :-1].sum() if dim == 1 else pair[:-1, :].sum()


@timeit("trws")
def trws_optimize(top_ncc, top_depth, cfg: MultiViewConfig,
                  max_iters: int = 50, damping: float = 0.5) -> MRFResult:
    """Minimise the Campbell MRF over the hypothesis volume.

    top_ncc/top_depth: [K, H, W], ascending, no-peak slots (0, -1).
    Returns MRFResult; ``labels == K`` means "unknown".  Iterates until the
    energy improvement <= cfg.mrf_energy_eps (against the lowest energy so
    far) or ``max_iters``; the trace's unused tail holds the final energy.
    Adds the iterations to the tracer's ``trws/iterations``.
    """
    K = top_ncc.shape[0]
    h, w = top_ncc.shape[1:]
    D = campbell_data_cost(top_ncc, top_depth, cfg).permute(1, 2, 0)
    V = torch.stack([_pairwise_tensor(top_depth, cfg, s, a)
                     for s, a in _DIRS])                     # [4, H, W, L, L]

    def energy_of(msgs):
        lab = torch.argmin(D + msgs.sum(dim=0), dim=-1)      # [H, W]
        e_data = D.gather(-1, lab[..., None]).sum()
        # V[p, l, m] gathered at (lab[p], lab[q]): the one-hot contraction
        # of the JAX package, value for value
        e_sm = _pair_energy(V[3], lab, 1) + _pair_energy(V[1], lab, 0)
        return e_data + e_sm, lab

    def step(msgs):
        # min-sum updates, synchronous, all directions at once
        belief = D + msgs.sum(dim=0)                         # [H, W, L]
        arrived = []
        for d in range(4):
            excl = belief - msgs[_OPPOSITE[d]]               # exclude incoming
            m = torch.amin(excl[..., :, None] + V[d], dim=-2)
            m = m - m.mean(dim=-1, keepdim=True)             # normalise
            arrived.append(_shift_msg(m, d))
        return damping * msgs + (1 - damping) * torch.stack(arrived)

    msgs = torch.zeros((4, h, w, K + 1), dtype=D.dtype, device=D.device)
    prev_e, _ = energy_of(msgs)
    trace = []
    for _ in range(max_iters):
        msgs = step(msgs)
        e, _ = energy_of(msgs)
        trace.append(e)
        # the one host read of the iteration: the stop rule
        if bool(prev_e - e <= cfg.mrf_energy_eps):
            break
        prev_e = torch.minimum(e, prev_e)
    count("trws/iterations", len(trace))
    e, lab = energy_of(msgs)
    energies = torch.stack(trace + [e] * (max_iters - len(trace))) \
        if max_iters else e.new_zeros((0,))
    return MRFResult(labels=lab.to(torch.int32), energy=e,
                     energies=energies, iterations=len(trace))


def labels_to_depth(labels, top_depth):
    """Reference label decode (multiviewstereo.cpp:643-651): unknown -> inf,
    negative peak depth -> inf."""
    K = top_depth.shape[0]
    ext = torch.cat([top_depth, torch.full_like(top_depth[:1], -1.0)], dim=0)
    depth = ext.gather(0, labels[None].to(torch.int64))[0]
    return torch.where((labels == K) | (depth <= 0), torch.inf, depth)


def linear_label_costs(num_labels: int, smoothness_exp: int,
                       smoothness_max: float, smoothness_lambda: float):
    """Two-view MRF smoothness table (twoviewstereo.cpp:340):
    lambda * min(|l1 - l2|^exp, max), float32."""
    lab = torch.arange(num_labels)
    d = (lab[:, None] - lab[None, :]).abs().to(torch.float32) \
        ** smoothness_exp
    return smoothness_lambda * torch.clamp(d, max=smoothness_max)


def _truncated_linear_dt(h, lam, cap):
    """min-sum message for truncated-linear smoothness in O(L):
    out[l] = min_k h[k] + lam*min(|k-l|, cap), by two cumulative minima and
    the truncation (Felzenszwalb-Huttenlocher distance transform) along the
    label axis, the last here (the JAX package's first)."""
    lv = lam * torch.arange(h.shape[-1], dtype=h.dtype, device=h.device)
    fwd = lv + torch.cummin(h - lv, dim=-1).values
    bwd = -lv + torch.cummin((h + lv).flip(-1), dim=-1).values.flip(-1)
    out = torch.minimum(fwd, bwd)
    return torch.minimum(out, h.amin(dim=-1, keepdim=True) + lam * cap)


@timeit("twoview_bp")
def twoview_bp(costs, *, smoothness_lambda: float = 0.25,
               smoothness_max: float = 2.0, smoothness_exp: int = 1,
               max_iters: int = 50, energy_eps: float = 5.0,
               damping: float = 0.5):
    """Dense-label MRF over a two-view cost volume.

    The reference's USE_MRF path runs graph-cut Expansion over the dense
    [labels x pixels] cost volume with truncated-linear smoothness
    (twoviewstereo.cpp:335-403); here, as in the JAX package, synchronous
    min-sum BP with the closed-form truncated-linear distance transform.

    costs: [D, H, W] (inf = invalid sample; clamped to 1e4).  Returns
    (labels [H, W] int32, energy trace [max_iters]).  The JAX package runs
    a fixed-length scan in which the stop rule (dE <= energy_eps) freezes
    the messages; once frozen, every later iteration records the same
    energy, so this loop stops there and pads the trace with that energy:
    the same labels and the same trace.  Adds the iterations run to the
    tracer's ``bp/iterations``.
    """
    lam = smoothness_lambda
    cap = smoothness_max
    big = 10.0 * 1000.0
    Dv = torch.clamp(costs, max=big).permute(1, 2, 0)      # [H, W, L]

    def energy_of(msgs):
        lab = torch.argmin(Dv + msgs.sum(dim=0), dim=-1)
        e_data = Dv.gather(-1, lab[..., None]).sum()
        dlab = lab.to(torch.float32)
        sm_r = lam * torch.clamp(
            torch.abs(dlab[:, 1:] - dlab[:, :-1]) ** smoothness_exp, max=cap)
        sm_d = lam * torch.clamp(
            torch.abs(dlab[1:, :] - dlab[:-1, :]) ** smoothness_exp, max=cap)
        return e_data + sm_r.sum() + sm_d.sum(), lab

    msgs = torch.zeros((4,) + Dv.shape, dtype=Dv.dtype, device=Dv.device)
    prev_e, _ = energy_of(msgs)
    trace = []
    for _ in range(max_iters):
        belief = Dv + msgs.sum(dim=0)
        arrived = []
        for d in range(4):
            excl = belief - msgs[_OPPOSITE[d]]
            m = _truncated_linear_dt(excl, lam, cap)
            m = m - m.mean(dim=-1, keepdim=True)
            arrived.append(_shift_msg(m, d))
        msgs = damping * msgs + (1 - damping) * torch.stack(arrived)
        e, _ = energy_of(msgs)
        trace.append(e)
        # the one host read of the iteration: the stop rule
        if bool(prev_e - e <= energy_eps):
            break
        prev_e = torch.minimum(e, prev_e)
    count("bp/iterations", len(trace))
    e, lab = energy_of(msgs)
    trace = torch.stack(trace + [e] * (max_iters - len(trace))) \
        if max_iters else e.new_zeros((0,))
    return lab.to(torch.int32), trace
