"""Nearest sampling of source maps through the CUDA kernel
``csrc/sample_nearest.cu``.

Replaces the TPU kernel ``stereoreconstruction_tpu/ops/pallas_sample.py``
(``pallas_sample_nearest``): the cross-checks' scattered ``depth[iy, ix]``
read.  The TPU kernel staged a bounded patch per tile and missed
coordinates outside it; here each sample is a direct read, so ``oob_frac``
is 0 by construction.

``sample_nearest_plain`` is the plain PyTorch version (``trunc_index`` and
a gather); the wrapper runs it for CPU tensors and launches the kernel (or
raises) for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build


def trunc_index(x, n: int):
    """``clip(trunc(x), 0, n-1)`` as an index; non-finite or huge values
    clamp first (their float->int cast is undefined)."""
    x = torch.where(torch.isfinite(x), x, -1.0).clamp(-1.0, float(n))
    return torch.trunc(x).to(torch.int64).clamp(0, n - 1)


def sample_nearest_plain(srcs, x2, y2):
    """Plain PyTorch version of the sampling kernel: same arguments and
    results as ``cuda_sample_nearest`` (vals, finite)."""
    n_src, hs, ws = srcs.shape
    flat = trunc_index(y2, hs) * ws + trunc_index(x2, ws)
    g = srcs.reshape(n_src, -1).gather(
        1, flat.reshape(n_src, -1)).reshape(x2.shape)
    finite = torch.isfinite(g)
    return torch.where(finite, g, 0.0), finite


def cuda_sample_nearest(srcs, x2, y2):
    """Sample ``srcs[j]`` at clamped, truncated integer coordinates.

    srcs [V, hs, ws] (NaN/inf allowed); x2/y2 [V, H, W] coordinates in the
    maps' pixel frame (any value: non-finite or out-of-map coordinates clamp
    into the map, for the caller to mask).  Returns (vals [V, H, W],
    finite [V, H, W] bool, oob_frac): ``g = srcs[j][clip(trunc(y2), 0,
    hs-1), clip(trunc(x2), 0, ws-1)]``, vals = g where finite, else 0;
    oob_frac is 0 (a direct read misses nothing)."""
    if srcs.device.type == "cpu":
        vals, finite = sample_nearest_plain(srcs, x2, y2)
        return vals, finite, torch.zeros((), dtype=torch.float32)
    dev = srcs.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if srcs.dim() != 3 or x2.dim() != 3 or x2.shape[0] != srcs.shape[0]:
        raise ValueError(f"srcs must be [V, hs, ws] and x2 [V, H, W], got "
                         f"{tuple(srcs.shape)} and {tuple(x2.shape)}")
    for name, t in (("srcs", srcs), ("x2", x2), ("y2", y2)):
        if t.device != dev or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    if y2.shape != x2.shape:
        raise ValueError(f"y2 {tuple(y2.shape)} != x2 {tuple(x2.shape)}")
    n_src, hs, ws = srcs.shape
    _, h, w = x2.shape

    vals = torch.empty((n_src, h, w), dtype=torch.float32, device=dev)
    finite = torch.empty((n_src, h, w), dtype=torch.bool, device=dev)
    fn = cuda_build.library("sample_nearest").sample_nearest_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(srcs.data_ptr(), x2.data_ptr(), y2.data_ptr(),
                vals.data_ptr(), finite.data_ptr(), n_src, h, w, hs, ws,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sample_nearest kernel launch failed: CUDA error "
                           f"{rc}")
    cuda_sample_nearest.launches += 1
    return vals, finite, torch.zeros((), dtype=torch.float32, device=dev)


cuda_sample_nearest.launches = 0
