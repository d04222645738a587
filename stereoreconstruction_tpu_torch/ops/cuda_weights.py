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
# The run-time instance's shared-memory path (csrc: kRtTwoLanes,
# kRtMaxWarps, kRtGuard, kRtMaxSmem): whether a radius may take 2 lanes a
# pixel, the warps a block at most, the guard floats around its buffers,
# and a block's shared memory on sm_90.  The C entry point picks the path,
# the lanes and the warps by the same byte count (rt_config).
RT_TWO_LANES, RT_MAX_WARPS, RT_GUARD, RT_MAX_SMEM = True, 4, 256, 232448


def runtime_instance(radius: int) -> bool:
    """Whether a CUDA call at ``radius`` takes the run-time instance.
    Raises ValueError for a radius below 1."""
    if radius < 1:
        raise ValueError(f"window radius must be >= 1, got {radius}")
    return radius not in TEMPLATE_RADII


def rt_smem_bytes(radius: int, warps: int, lanes: int = 4) -> int:
    """Dynamic shared memory (bytes) of a block of ``warps`` warps of the
    run-time instance's shared-memory path with ``lanes`` lanes a pixel: a
    guard, each warp's window states ([rows a lane][r + 1 cell pairs][32
    lanes][2] floats: S cells and a pad a row), the block's edge tile (S
    rows of 32 / lanes x warps + 2r float4s), the right edges again (S rows
    of EWr floats, EWr the least width >= the tile's with EWr - 2 x skew =
    32 / lanes mod 32, skew = ceil((r + 2) / lanes) steps), a guard.  The
    mirror of csrc/geodesic_weights.cu rt_layout."""
    size = 2 * radius + 1
    pairs = radius + 1
    rows = -(-size // lanes)                     # rows a lane
    skew = -(-(pairs + 1) // lanes)
    pixels = 32 // lanes
    ew = warps * pixels + 2 * radius
    ewr = ew + (2 * skew + pixels - ew) % 32
    state = warps * rows * pairs * 64
    floats = RT_GUARD + state + 4 * size * ew + size * ewr + RT_GUARD
    return floats * 4


def rt_config(radius: int) -> tuple:
    """(lanes a pixel, warps a block) of the run-time instance's
    shared-memory path at ``radius``: 2 lanes and RT_MAX_WARPS where such a
    block takes at most half a block's shared memory (two blocks an SM),
    else 4 lanes and the most of 4, 2, 1 warps whose bytes fit; warps 0
    where none fits and it takes its device-memory path."""
    if RT_TWO_LANES and (rt_smem_bytes(radius, RT_MAX_WARPS, 2)
                         <= RT_MAX_SMEM // 2):
        return 2, RT_MAX_WARPS
    w = RT_MAX_WARPS
    while w and rt_smem_bytes(radius, w) > RT_MAX_SMEM:
        w //= 2
    return 4, w


def launched_kernels(radius: int) -> tuple:
    """The kernels a CUDA call at ``radius`` launches, in order, as the
    profiler names them: the compile-time instance; or the run-time
    instance's ``geodesic_edges_kernel`` (it writes the padded edge planes)
    and the sweep of its shared-memory path, or of its device-memory path.
    Raises ValueError for a radius below 1."""
    if not runtime_instance(radius):
        return (f"geodesic_weights_kernel<{radius}>",)
    lanes, warps = rt_config(radius)
    if warps:
        return ("geodesic_edges_kernel",
                f"geodesic_weights_rt_smem_kernel<{lanes}>")
    return ("geodesic_edges_kernel", "geodesic_weights_rt_kernel")


def instance_for(radius: int) -> str:
    """The kernel instance (its sweep kernel) a CUDA call at ``radius``
    launches, as the profiler names it: it names the path a run-time radius
    takes.  Raises ValueError for a radius below 1."""
    return launched_kernels(radius)[-1]


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
