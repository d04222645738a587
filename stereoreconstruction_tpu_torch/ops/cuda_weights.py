"""Geodesic support weights through the CUDA kernel
``csrc/geodesic_weights.cu``.

Replaces the TPU kernel ``stereoreconstruction_tpu/ops/pallas_weights.py``
(``pallas_geodesic_weights``).  The plain PyTorch version is
``ops/weights.py geodesic_weights(exact=False)``: the wrapper runs it for a
tensor on the CPU, and launches the kernel (or raises) for a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .weights import geodesic_weights

# The window radii of the kernel's compile-time instances; every other
# radius >= 1 takes its run-time-radius instance.  The C entry points launch
# the instance the wrapper names (runtime_instance is the one rule).
TEMPLATE_RADII = tuple(range(1, 8))


def runtime_instance(radius: int) -> bool:
    """Whether a CUDA call at ``radius`` takes the run-time instance.
    Raises ValueError for a radius below 1."""
    if radius < 1:
        raise ValueError(f"window radius must be >= 1, got {radius}")
    return radius not in TEMPLATE_RADII


def instance_for(radius: int) -> str:
    """The kernel instance a CUDA call at ``radius`` launches, as the
    profiler names it (the run-time instance's sweep follows
    ``geodesic_edges_kernel``, which writes its edge planes).  Raises
    ValueError for a radius below 1."""
    if runtime_instance(radius):
        return "geodesic_weights_rt_kernel"
    return f"geodesic_weights_kernel<{radius}>"


def cuda_geodesic_weights(rgb, radius: int, sigma: float = 50.0,
                          iters: int = 3, valid=None):
    """Geodesic support weights: rgb [H, W, 3] -> [S, S, H, W].

    ``valid`` ([H, W] bool, optional) overrides the in-image validity plane,
    as in the JAX wrapper.  CUDA input: float32, contiguous, any radius
    >= 1 (``instance_for`` names the kernel it takes)."""
    if rgb.device.type == "cpu":
        return geodesic_weights(rgb, radius, sigma, iters, exact=False,
                                pixel_valid=valid)
    if rgb.device.type != "cuda":
        raise ValueError(f"unsupported device {rgb.device}")
    if rgb.dtype != torch.float32 or rgb.dim() != 3 or rgb.shape[-1] != 3:
        raise ValueError(f"rgb must be float32 [H, W, 3], got {rgb.dtype} "
                         f"{tuple(rgb.shape)}")
    if not rgb.is_contiguous():
        raise ValueError("rgb must be contiguous")
    rt = runtime_instance(radius)
    h, w = rgb.shape[:2]
    if valid is not None:
        if (valid.dtype != torch.bool or tuple(valid.shape) != (h, w)
                or valid.device != rgb.device or not valid.is_contiguous()):
            raise ValueError("valid must be a contiguous bool [H, W] tensor "
                             "on the device of rgb")
    size = 2 * radius + 1
    out = torch.empty((size * size, h, w), dtype=torch.float32,
                      device=rgb.device)
    # the run-time instance's edge planes of the image padded by r
    edges = torch.empty((4, h + 2 * radius, w + 2 * radius),
                        dtype=torch.float32, device=rgb.device) if rt else None
    lib = cuda_build.library("geodesic_weights")
    fn = lib.geodesic_weights_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(rgb.device):
        rc = fn(rgb.data_ptr(),
                valid.data_ptr() if valid is not None else None,
                out.data_ptr(), h, w, radius, iters, sigma,
                torch.cuda.current_stream().cuda_stream,
                edges.data_ptr() if rt else None)
    if rc != 0:
        raise RuntimeError(f"geodesic_weights kernel launch failed: CUDA "
                           f"error {rc}")
    cuda_geodesic_weights.launches += 1
    return out.view(size, size, h, w)


cuda_geodesic_weights.launches = 0
