"""Bilinear warp volume through the CUDA kernel ``csrc/warp_bilinear.cu``.

Replaces the TPU kernel ``stereoreconstruction_tpu/ops/pallas_warp.py``
(``pallas_warp_bilinear``).  The plain PyTorch version is
``ops/warp.py warp_bilinear``: the wrapper runs it for tensors on the CPU
and launches the kernel (or raises) for CUDA tensors.  The TPU kernel
staged source patches by DMA and reported the share of samples its patches
missed; here every sample gathers its texels directly, so that share is 0
by construction (the kernel counts it all the same).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .warp import warp_bilinear


def cuda_warp_bilinear(coords, gray_oth, mask_oth):
    """Warp the other view's gray and mask at every depth's match coords.

    coords [D, 2, H, W] float32 (-3e6 where the match point is invalid);
    gray_oth [hs, ws] float32; mask_oth [hs, ws] bool.

    Returns (warped [D, H, W] float32, wvalid [D, H, W] bool, oob_frac): the
    fraction of sample()-valid positions whose texels fell outside the
    source (0)."""
    if coords.device.type == "cpu":
        warped, wvalid = warp_bilinear(coords, gray_oth, mask_oth)
        return warped, wvalid, torch.zeros((), dtype=torch.float32)
    dev = coords.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if coords.dim() != 4 or coords.shape[1] != 2:
        raise ValueError(f"coords must be [D, 2, H, W], got "
                         f"{tuple(coords.shape)}")
    if gray_oth.dim() != 2 or tuple(mask_oth.shape) != tuple(gray_oth.shape):
        raise ValueError(f"gray_oth and mask_oth must be one [hs, ws] shape, "
                         f"got {tuple(gray_oth.shape)} and "
                         f"{tuple(mask_oth.shape)}")
    for name, t, dtype in (("coords", coords, torch.float32),
                           ("gray_oth", gray_oth, torch.float32),
                           ("mask_oth", mask_oth, torch.bool)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    n_depths, _, h, w = coords.shape
    hs, ws = gray_oth.shape

    warped = torch.empty((n_depths, h, w), dtype=torch.float32, device=dev)
    wvalid = torch.empty((n_depths, h, w), dtype=torch.bool, device=dev)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    fn = cuda_build.library("warp_bilinear").warp_bilinear_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(coords.data_ptr(), gray_oth.data_ptr(), mask_oth.data_ptr(),
                warped.data_ptr(), wvalid.data_ptr(), counts.data_ptr(),
                n_depths, h * w, hs, ws,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"warp_bilinear kernel launch failed: CUDA error "
                           f"{rc}")
    cuda_warp_bilinear.launches += 1
    oob_frac = counts[1].to(torch.float32) / counts[0].clamp(min=1)
    return warped, wvalid, oob_frac


cuda_warp_bilinear.launches = 0
