"""Multi-view depth sweep through the CUDA kernel ``csrc/mvs_sweep.cu``.

Replaces the TPU kernel ``stereoreconstruction_tpu/ops/pallas_mvs.py``
(``pallas_mvs_wta``) in both of its modes: the WTA carry
(``cuda_mvs_wta``) and the ascending top-K hypothesis lists of the MRF path
(``cuda_mvs_topk``).  The TPU kernel staged neighbour-image patches by DMA
and selected taps with one-hot matmuls; on the GPU each thread gathers its
taps directly, so no tap can miss a patch and ``oob_frac`` is 0 by
construction (returned for the same signature).

``mvs_wta_plain`` and ``mvs_topk_plain`` are the plain PyTorch versions (the
tap gather, ``ncc_accumulate`` and the carry of ``mvs_wta_slab`` /
``mvs_topk_slab``); each wrapper runs its plain version for CPU tensors and
launches the kernel (or raises) for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .ncc import ncc_accumulate

# The compile-time instances: window radii 1-7, lists of up to 16 entries,
# up to 32 neighbours, and beside each radius's run-time list the compiled
# list of 9 at r = 2 (MultiViewConfig's defaults).  Any other radius >= 1,
# list length >= 1 or neighbour count takes the kernel's run-time instance.
# The C entry point launches the instance the wrapper names (list_instance
# is the one rule).
TEMPLATE_RADII = tuple(range(1, 8))
TEMPLATE_MAX_TOPK = 16
TEMPLATE_MAX_NBR = 32
COMPILED_LISTS = ((2, 9),)


def list_instance(radius: int, top_k: int = 1, *, wta: bool = True,
                  n_nbr: int = 1) -> int:
    """The instance a CUDA call takes, as the C entry point's ``list_k``:
    -1 the run-time instance; else the radius's compile-time instance with
    1 the WTA carry (``wta``, top_k 1), 9 the compiled list of 9, 0 a list
    of ``top_k`` read at run time.  Raises ValueError for a radius or top_k
    below 1 (or a WTA call with top_k other than 1)."""
    if radius < 1:
        raise ValueError(f"window radius must be >= 1, got {radius}")
    if top_k < 1 or (wta and top_k != 1):
        raise ValueError(f"top_k must be >= 1 (1 for the WTA), got {top_k}")
    if (radius not in TEMPLATE_RADII or n_nbr > TEMPLATE_MAX_NBR
            or top_k > TEMPLATE_MAX_TOPK):
        return -1
    if wta:
        return 1
    return top_k if (radius, top_k) in COMPILED_LISTS else 0


def instance_for(radius: int, top_k: int = 1, *, wta: bool = True,
                 n_nbr: int = 1) -> str:
    """The kernel instance a CUDA call launches, as the profiler names it:
    the WTA carry (``wta``, top_k 1) or lists of ``top_k``, at ``radius``
    over ``n_nbr`` neighbours.  Raises as ``list_instance``."""
    k = list_instance(radius, top_k, wta=wta, n_nbr=n_nbr)
    if k < 0:
        return f"mvs_sweep_rt_kernel<{'true' if wta else 'false'}>"
    return f"mvs_sweep_kernel<{radius}, {k}>"


def mvs_wta_slab(plane_cost, depths, thr: float, shape, *, label0=0,
                 n_labels=None):
    """Sequential WTA carry over depth labels [label0, label0 + n_labels)
    (multiviewstereo.cpp:574-602: peak iff NCC > thr, ties -> larger
    depth).  ``plane_cost(d_idx) -> ncc [N, H, W]``.  Returns the raw carry
    (best_ncc, best_depth)."""
    if n_labels is None:
        n_labels = depths.shape[0] - label0
    best_ncc = torch.full(shape, -torch.inf, dtype=depths.dtype,
                          device=depths.device)
    best_depth = torch.full(shape, -1.0, dtype=depths.dtype,
                            device=depths.device)
    for d_idx in range(label0, label0 + n_labels):
        ncc = plane_cost(d_idx)                      # [N, H, W]
        ncc = torch.where(ncc > thr, ncc, -torch.inf)
        ncc_max = ncc.amax(dim=0)                    # over neighbours
        # >= : equal cost at a later (larger) depth wins, matching
        # peaks.back() after a stable sort by (cost, depth).
        better = ncc_max >= best_ncc
        best_depth = torch.where(better, depths[d_idx], best_depth)
        best_ncc = torch.where(better, ncc_max, best_ncc)
    return best_ncc, best_depth


def mvs_topk_slab(plane_cost, depths, top_k: int, thr: float, shape, *,
                  label0=0, n_labels=None):
    """Top-K (ncc, depth) peaks over depth labels [label0, label0 +
    n_labels), ascending by ncc with ties in label order — the hypothesis
    volume of multiviewstereo.cpp:574-602.  A label without a peak inserts
    the reference's (0, -1) no-peak default as (-inf, -1); the lists are
    raw (-inf padded).  Returns (top_ncc, top_depth), each [K, H, W]."""
    if n_labels is None:
        n_labels = depths.shape[0] - label0
    kw = dict(dtype=depths.dtype, device=depths.device)
    top_ncc = torch.full((top_k,) + tuple(shape), -torch.inf, **kw)
    top_depth = torch.full((top_k,) + tuple(shape), -1.0, **kw)
    for d_idx in range(label0, label0 + n_labels):
        ncc = plane_cost(d_idx)                          # [N, H, W]
        ncc = torch.where(ncc > thr, ncc, -torch.inf)
        # several neighbours may peak at one depth: the best one counts
        # (the hypothesis set is a depth set)
        cand_n = ncc.amax(dim=0)
        cand_d = torch.where(torch.isfinite(cand_n), depths[d_idx], -1.0)
        stack_n = torch.cat([top_ncc, cand_n[None]], dim=0)
        stack_d = torch.cat([top_depth, cand_d[None]], dim=0)
        # stable, as jnp.argsort: an equal ncc lands after the existing
        # entries, so the later (larger) depth wins the tie
        order = torch.sort(stack_n, dim=0, stable=True).indices
        top_ncc = stack_n.gather(0, order)[1:]
        top_depth = stack_d.gather(0, order)[1:]
    return top_ncc, top_depth


def nearest_taps(gray_nbr, x2, y2, radius: int):
    """The (2r+1)^2 integer taps of each neighbour image at its match
    coordinates, with the reference's ``(int)`` semantics as the TPU kernel
    states them: tap (r, c) reads ``clip(floor(x2) + c, 0, ws-1)`` (rows
    alike) and is valid iff ``-1 < x2 + c < ws`` and ``-1 < y2 + r < hs``.

    gray_nbr [N, hs, ws]; x2/y2 [N, H, W].  Returns (taps, valid), each
    ``[S, S, N, H, W]``."""
    n_nbr, hs, ws = gray_nbr.shape
    ixf = torch.floor(x2.clamp(-1e6, 1e6))
    iyf = torch.floor(y2.clamp(-1e6, 1e6))
    nidx = torch.arange(n_nbr, device=gray_nbr.device)[:, None, None]
    taps, valid = [], []
    for r in range(-radius, radius + 1):
        jy = (iyf + r).clamp(0, hs - 1).to(torch.int64)
        row_ok = ((y2 + r) > -1.0) & ((y2 + r) < hs)
        t_row, v_row = [], []
        for c in range(-radius, radius + 1):
            jx = (ixf + c).clamp(0, ws - 1).to(torch.int64)
            t_row.append(gray_nbr[nidx, jy, jx])
            v_row.append(row_ok & ((x2 + c) > -1.0) & ((x2 + c) < ws))
        taps.append(torch.stack(t_row))
        valid.append(torch.stack(v_row))
    return torch.stack(taps), torch.stack(valid)


def _plane_cost_fn(coords, gray_nbr, gl, lv, weights, nbr_valid, radius,
                   label0):
    """``plane_cost(d_idx) -> ncc [N, H, W]`` of the kernel's inputs."""
    size = 2 * radius + 1
    h, w = gl.shape[-2:]
    gl = gl.reshape(size, size, 1, h, w)
    lv = lv.reshape(size, size, 1, h, w)
    weights = weights.reshape(size, size, 1, h, w)

    def plane_cost(d_idx):
        xy = coords[d_idx - label0]                 # [N, 2, H, W]
        x2, y2 = xy[:, 0], xy[:, 1]
        taps, tap_valid = nearest_taps(gray_nbr, x2, y2, radius)
        ncc = ncc_accumulate(gl, lv, weights, taps, tap_valid, x2 > -1e6,
                             mvs_mode=True)
        return torch.where(nbr_valid[:, None, None], ncc, -torch.inf)

    return plane_cost


def mvs_wta_plain(depths, coords, gray_nbr, gl, lv, weights, nbr_valid, *,
                  radius: int, thr: float, center_valid=None, label0=0):
    """Plain PyTorch version of the sweep kernel's WTA mode: same arguments
    as ``cuda_mvs_wta``; returns the raw WTA carry (best_ncc,
    best_depth)."""
    plane_cost = _plane_cost_fn(coords, gray_nbr, gl, lv, weights, nbr_valid,
                                radius, label0)
    best_ncc, best_depth = mvs_wta_slab(plane_cost, depths, thr,
                                        gl.shape[-2:], label0=label0,
                                        n_labels=coords.shape[0])
    if center_valid is not None:
        best_ncc = torch.where(center_valid, best_ncc, -torch.inf)
        best_depth = torch.where(center_valid, best_depth, -1.0)
    return best_ncc, best_depth


def mvs_topk_plain(depths, coords, gray_nbr, gl, lv, weights, nbr_valid, *,
                   radius: int, thr: float, top_k: int, label0=0):
    """Plain PyTorch version of the sweep kernel's top-K mode: same
    arguments as ``cuda_mvs_topk``; returns the raw ascending lists
    (top_ncc, top_depth), each [K, H, W]."""
    plane_cost = _plane_cost_fn(coords, gray_nbr, gl, lv, weights, nbr_valid,
                                radius, label0)
    return mvs_topk_slab(plane_cost, depths, top_k, thr, gl.shape[-2:],
                         label0=label0, n_labels=coords.shape[0])


def check_launch_args(wta, top_k, depths, coords, gray_nbr, gl, lv, weights,
                      nbr_valid, center_valid, *, radius, label0):
    """Raise ValueError unless the tensors and arguments are what the
    kernel takes (contiguous float32 / bool on the device of ``depths``, of
    matching shapes; a radius and top_k of at least 1); returns (h, w, hs,
    ws).  Any neighbour count is taken."""
    dev = depths.device
    list_instance(radius, top_k, wta=wta, n_nbr=coords.shape[1])
    h, w = gl.shape[-2:]
    size = 2 * radius + 1
    n_labels, n_nbr = coords.shape[:2]
    expect = {
        "depths": (depths, torch.float32, None),
        "coords": (coords, torch.float32, (n_labels, n_nbr, 2, h, w)),
        "gray_nbr": (gray_nbr, torch.float32, None),
        "gl": (gl, torch.float32, (size * size, h, w)),
        "lv": (lv, torch.bool, (size * size, h, w)),
        "weights": (weights, torch.float32, (size * size, h, w)),
        "nbr_valid": (nbr_valid, torch.bool, (n_nbr,)),
    }
    if center_valid is not None:
        expect["center_valid"] = (center_valid, torch.bool, (h, w))
    for name, (t, dtype, shape) in expect.items():
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    if (depths.dim() != 1 or label0 < 0
            or label0 + n_labels > depths.shape[0]):
        raise ValueError(f"labels [{label0}, {label0 + n_labels}) outside "
                         f"depths of shape {tuple(depths.shape)}")
    if gray_nbr.dim() != 3 or gray_nbr.shape[0] != n_nbr:
        raise ValueError(f"gray_nbr must be [{n_nbr}, hs, ws], got "
                         f"{tuple(gray_nbr.shape)}")
    return (h, w) + tuple(gray_nbr.shape[1:])


def _launch(wta, top_k, depths, coords, gray_nbr, gl, lv, weights, nbr_valid,
            center_valid, *, radius, thr, label0):
    """Check the CUDA inputs, launch the kernel (the WTA carry when
    ``wta``, else lists of ``top_k``) and return its (ncc, depth) outputs,
    each [top_k, H, W].  center_valid None: every centre is valid."""
    dev = depths.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    h, w, hs, ws = check_launch_args(
        wta, top_k, depths, coords, gray_nbr, gl, lv, weights, nbr_valid,
        center_valid, radius=radius, label0=label0)
    n_labels, n_nbr = coords.shape[:2]

    ncc = torch.empty((top_k, h, w), dtype=torch.float32, device=dev)
    depth = torch.empty((top_k, h, w), dtype=torch.float32, device=dev)
    fn = cuda_build.library("mvs_sweep").mvs_sweep_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(depths.data_ptr(), coords.data_ptr(), gray_nbr.data_ptr(),
                gl.data_ptr(), lv.data_ptr(), weights.data_ptr(),
                nbr_valid.data_ptr(),
                None if center_valid is None else center_valid.data_ptr(),
                ncc.data_ptr(), depth.data_ptr(), h, w, n_nbr, hs, ws,
                label0, n_labels, radius, int(wta), top_k, thr,
                torch.cuda.current_stream().cuda_stream,
                list_instance(radius, top_k, wta=wta, n_nbr=n_nbr))
    if rc != 0:
        raise RuntimeError(f"mvs_sweep kernel launch failed: CUDA error {rc}")
    return ncc, depth


def cuda_mvs_wta(depths, coords, gray_nbr, gl, lv, weights, nbr_valid, *,
                 radius: int, thr: float, center_valid=None, label0: int = 0):
    """Fused tap + NCC + WTA sweep over labels [label0, label0 + n_labels).

    depths [D] float32 (all labels); coords [n_labels, N, 2, H, W] float32
    (x2/y2 in the neighbour's scaled pixel frame, -3e6 where the base sample
    is invalid); gray_nbr [N, hs, ws] float32; gl/weights [S*S, H, W] float32
    and lv [S*S, H, W] bool (left window values / support weights /
    validity, window-position major); nbr_valid [N] bool; center_valid
    [H, W] bool or None.

    Returns (best_ncc [H, W], best_depth [H, W], oob_frac): the raw WTA carry
    of ``mvs_wta_slab`` (finalize with ``mvs_finalize_wta``); masked centres
    carry (-inf, -1).  oob_frac is 0: taps are gathered, never staged."""
    if depths.device.type == "cpu":
        best_ncc, best_depth = mvs_wta_plain(
            depths, coords, gray_nbr, gl, lv, weights, nbr_valid,
            radius=radius, thr=thr, center_valid=center_valid,
            label0=label0)
        return best_ncc, best_depth, torch.zeros((), dtype=torch.float32)
    ncc, depth = _launch(True, 1, depths, coords, gray_nbr, gl, lv,
                         weights, nbr_valid, center_valid, radius=radius,
                         thr=thr, label0=label0)
    cuda_mvs_wta.launches += 1
    return ncc[0], depth[0], torch.zeros((), dtype=torch.float32,
                                         device=depths.device)


def cuda_mvs_topk(depths, coords, gray_nbr, gl, lv, weights, nbr_valid, *,
                  radius: int, thr: float, top_k: int, label0: int = 0):
    """Fused tap + NCC + top-K sweep over labels [label0, label0 +
    n_labels): the same inputs as ``cuda_mvs_wta`` but no centre mask —
    every pixel is swept, since a masked pixel's hypotheses enter the MRF's
    pairwise terms of its neighbours (as in ``mvs_topk_slab``).

    Returns (top_ncc [K, H, W], top_depth [K, H, W], oob_frac): the raw
    ascending lists of ``mvs_topk_slab``, padded with (-inf, -1); oob_frac
    is 0."""
    if depths.device.type == "cpu":
        top_ncc, top_depth = mvs_topk_plain(
            depths, coords, gray_nbr, gl, lv, weights, nbr_valid,
            radius=radius, thr=thr, top_k=top_k, label0=label0)
        return top_ncc, top_depth, torch.zeros((), dtype=torch.float32)
    top_ncc, top_depth = _launch(False, top_k, depths, coords, gray_nbr,
                                 gl, lv, weights, nbr_valid, None,
                                 radius=radius, thr=thr, label0=label0)
    cuda_mvs_topk.launches += 1
    return top_ncc, top_depth, torch.zeros((), dtype=torch.float32,
                                           device=depths.device)


cuda_mvs_wta.launches = 0
cuda_mvs_topk.launches = 0
