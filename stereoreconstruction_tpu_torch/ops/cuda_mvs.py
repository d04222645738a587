"""Multi-view depth sweep through the CUDA kernel ``csrc/mvs_sweep.cu``.

Replaces the TPU kernel ``stereoreconstruction_tpu/ops/pallas_mvs.py``
(``pallas_mvs_wta``, WTA mode).  The TPU kernel staged neighbour-image
patches by DMA and selected taps with one-hot matmuls; on the GPU each
thread gathers its taps directly, so no tap can miss a patch and
``oob_frac`` is 0 by construction (returned for the same signature).

``mvs_wta_plain`` is the plain PyTorch version (the tap gather,
``ncc_accumulate`` and the WTA carry of ``mvs_wta_slab``); the wrapper runs
it for CPU tensors and launches the kernel (or raises) for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .ncc import ncc_accumulate

KERNEL_RADII = (2,)


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


def mvs_wta_plain(depths, coords, gray_nbr, gl, lv, weights, nbr_valid, *,
                  radius: int, thr: float, center_valid=None, label0=0):
    """Plain PyTorch version of the sweep kernel: same arguments as
    ``cuda_mvs_wta``; returns the raw WTA carry (best_ncc, best_depth)."""
    from ..stereo.multiview import mvs_wta_slab

    size = 2 * radius + 1
    h, w = gl.shape[-2:]
    gl = gl.reshape(size, size, 1, h, w)
    lv = lv.reshape(size, size, 1, h, w)
    weights = weights.reshape(size, size, 1, h, w)

    def plane_cost(d_idx):
        xy = coords[d_idx - label0]                 # [N, 2, H, W]
        x2, y2 = xy[:, 0], xy[:, 1]
        taps, tap_valid = nearest_taps(gray_nbr, x2, y2, radius)
        ncc = ncc_accumulate(gl, lv, weights, taps, tap_valid, x2 > -1e6)
        return torch.where(nbr_valid[:, None, None], ncc, -torch.inf)

    best_ncc, best_depth = mvs_wta_slab(plane_cost, depths, thr, (h, w),
                                        label0=label0,
                                        n_labels=coords.shape[0])
    if center_valid is not None:
        best_ncc = torch.where(center_valid, best_ncc, -torch.inf)
        best_depth = torch.where(center_valid, best_depth, -1.0)
    return best_ncc, best_depth


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
    h, w = gl.shape[-2:]
    if depths.device.type == "cpu":
        best_ncc, best_depth = mvs_wta_plain(
            depths, coords, gray_nbr, gl, lv, weights, nbr_valid,
            radius=radius, thr=thr, center_valid=center_valid,
            label0=label0)
        return best_ncc, best_depth, torch.zeros((), dtype=torch.float32)
    dev = depths.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if radius not in KERNEL_RADII:
        raise ValueError(f"kernel built for radius {KERNEL_RADII}, "
                         f"got {radius}")
    size = 2 * radius + 1
    n_labels, n_nbr = coords.shape[:2]
    if center_valid is None:
        center_valid = torch.ones((h, w), dtype=torch.bool, device=dev)
    expect = {
        "depths": (depths, torch.float32, None),
        "coords": (coords, torch.float32, (n_labels, n_nbr, 2, h, w)),
        "gray_nbr": (gray_nbr, torch.float32, None),
        "gl": (gl, torch.float32, (size * size, h, w)),
        "lv": (lv, torch.bool, (size * size, h, w)),
        "weights": (weights, torch.float32, (size * size, h, w)),
        "nbr_valid": (nbr_valid, torch.bool, (n_nbr,)),
        "center_valid": (center_valid, torch.bool, (h, w)),
    }
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
    hs, ws = gray_nbr.shape[1:]

    best_ncc = torch.empty((h, w), dtype=torch.float32, device=dev)
    best_depth = torch.empty((h, w), dtype=torch.float32, device=dev)
    lib = cuda_build.library("mvs_sweep")
    fn = lib.mvs_wta_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(depths.data_ptr(), coords.data_ptr(), gray_nbr.data_ptr(),
                gl.data_ptr(), lv.data_ptr(), weights.data_ptr(),
                nbr_valid.data_ptr(), center_valid.data_ptr(),
                best_ncc.data_ptr(), best_depth.data_ptr(), h, w, n_nbr,
                hs, ws, label0, n_labels, radius, thr,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mvs_sweep kernel launch failed: CUDA error {rc}")
    cuda_mvs_wta.launches += 1
    return best_ncc, best_depth, torch.zeros((), dtype=torch.float32,
                                             device=dev)


cuda_mvs_wta.launches = 0
