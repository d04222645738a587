"""Two-view cost + WTA sweep, and the two-view cost volume, through the
CUDA kernel ``csrc/cost_wta.cu``.

Replaces the TPU kernel ``stereoreconstruction_tpu/ops/pallas_ncc.py``
(``pallas_cost_wta``).  ``cost_wta_plain`` is the plain PyTorch version of
the WTA mode: ``ops/ncc_fast.py fast_cost_plane`` on each depth's warped
plane and the sequential WTA carry ``wta_scan``.  ``cost_volume_plain`` is
that of the volume mode (the MRF path's input): ``fast_cost_plane`` stacked
over the labels.  Each wrapper runs its plain version for CPU tensors and
launches the kernel (or raises) for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .ncc_fast import fast_cost_plane, make_ref_view

# The window radii of the kernel's compile-time instances; every other
# radius >= 1 takes its run-time-radius instance.  The C entry points launch
# the instance the wrapper names (runtime_instance is the one rule).
TEMPLATE_RADII = tuple(range(1, 8))


def runtime_instance(radius: int) -> bool:
    """Whether a CUDA call at ``radius`` takes the run-time instance (in
    either mode).  Raises ValueError for a radius below 1."""
    if radius < 1:
        raise ValueError(f"window radius must be >= 1, got {radius}")
    return radius not in TEMPLATE_RADII


def instance_for(radius: int, volume: bool = False) -> str:
    """The kernel instance a CUDA call at ``radius`` launches (the volume
    mode's with ``volume``), as the profiler names it.  Raises ValueError
    for a radius below 1."""
    mode = "true" if volume else "false"
    if runtime_instance(radius):
        return f"cost_wta_rt_kernel<{mode}>"
    return f"cost_wta_kernel<{radius}, {mode}>"


def wta_scan(cost_fn, depths, shape, dtype):
    """Sequential WTA over depth labels with the reference's tie and
    second-best rules (twoviewstereo.cpp:320-326): a label wins only if it
    improves by more than 1e-10, and "second best" is the previous best at
    that moment, not the global second minimum.  ``cost_fn(d_idx) -> (cost
    [H, W], depth value)``.  Returns (min_cost, second, best)."""
    dev = depths.device
    min_cost = torch.full(shape, torch.inf, dtype=dtype, device=dev)
    second = torch.full(shape, torch.inf, dtype=dtype, device=dev)
    best = torch.full(shape, torch.nan, dtype=dtype, device=dev)
    for d_idx in range(depths.shape[0]):
        cost, depth_value = cost_fn(d_idx)
        better = cost + 1e-10 < min_cost
        second = torch.where(better, min_cost, second)
        min_cost = torch.where(better, cost, min_cost)
        best = torch.where(better, depth_value, best)
    return min_cost, second, best


def cost_wta_plain(depths, warped, wvalid, gray_ref, left_valid, weights, *,
                   radius: int, max_color_diff: float = 120.0,
                   bad_ret: float = 1000.0):
    """Plain PyTorch version of the cost kernel: same arguments and results
    as ``cuda_cost_wta``."""
    h, w = gray_ref.shape
    ref = make_ref_view(gray_ref, left_valid, weights, radius)

    def cost_at(d_idx):
        cost = fast_cost_plane(ref, warped[d_idx], wvalid[d_idx],
                               max_color_diff=max_color_diff,
                               bad_ret=bad_ret)
        return cost, depths[d_idx]

    return wta_scan(cost_at, depths, (h, w), warped.dtype)


def cost_volume_plain(warped, wvalid, gray_ref, left_valid, weights, *,
                      radius: int, max_color_diff: float = 120.0,
                      bad_ret: float = 1000.0):
    """Plain PyTorch version of the cost kernel's volume mode: same
    arguments and result as ``cuda_cost_volume``."""
    ref = make_ref_view(gray_ref, left_valid, weights, radius)
    return torch.stack([
        fast_cost_plane(ref, warped[d], wvalid[d],
                        max_color_diff=max_color_diff, bad_ret=bad_ret)
        for d in range(warped.shape[0])])


def _check_inputs(warped, wvalid, gray_ref, left_valid, weights, radius,
                  depths=None):
    """Raise unless the tensors are what the kernel takes: contiguous
    float32 / bool on one CUDA device, of matching shapes."""
    dev = warped.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    runtime_instance(radius)
    size = 2 * radius + 1
    n_depths = warped.shape[0] if warped.dim() == 3 else -1
    h, w = gray_ref.shape
    expect = {
        "warped": (warped, torch.float32, (n_depths, h, w)),
        "wvalid": (wvalid, torch.bool, (n_depths, h, w)),
        "gray_ref": (gray_ref, torch.float32, (h, w)),
        "left_valid": (left_valid, torch.bool, (h, w)),
        "weights": (weights, torch.float32, (size, size, h, w)),
    }
    if depths is not None:
        expect["depths"] = (depths, torch.float32, (n_depths,))
    for name, (t, dtype, shape) in expect.items():
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")


def cuda_cost_wta(depths, warped, wvalid, gray_ref, left_valid, weights, *,
                  radius: int, max_color_diff: float = 120.0,
                  bad_ret: float = 1000.0):
    """Fused two-view cost + WTA over all D depth labels.

    depths [D] float32; warped [D, H, W] float32 and wvalid [D, H, W] bool
    (``cuda_warp_bilinear``); gray_ref [H, W] float32; left_valid [H, W]
    bool (the reference mask & sample() validity); weights [S, S, H, W]
    float32.

    Returns (min_cost, second, best_depth), each [H, W]: the WTA carry of
    ``wta_scan`` (inf, inf, NaN where no label won); the caller applies the
    second-best rejection."""
    if depths.device.type == "cpu":
        return cost_wta_plain(depths, warped, wvalid, gray_ref, left_valid,
                              weights, radius=radius,
                              max_color_diff=max_color_diff, bad_ret=bad_ret)
    _check_inputs(warped, wvalid, gray_ref, left_valid, weights, radius,
                  depths)
    dev = warped.device
    n_depths = warped.shape[0]
    h, w = gray_ref.shape
    out = torch.empty((3, h, w), dtype=torch.float32, device=dev)
    fn = cuda_build.library("cost_wta").cost_wta_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(depths.data_ptr(), warped.data_ptr(), wvalid.data_ptr(),
                gray_ref.data_ptr(), left_valid.data_ptr(), weights.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                h, w, n_depths, radius, max_color_diff, bad_ret,
                torch.cuda.current_stream().cuda_stream,
                int(runtime_instance(radius)))
    if rc != 0:
        raise RuntimeError(f"cost_wta kernel launch failed: CUDA error {rc}")
    cuda_cost_wta.launches += 1
    return out[0], out[1], out[2]


def cuda_cost_volume(warped, wvalid, gray_ref, left_valid, weights, *,
                     radius: int, max_color_diff: float = 120.0,
                     bad_ret: float = 1000.0):
    """Two-view cost volume: every depth label's cost of every pixel.

    The inputs of ``cuda_cost_wta`` without the depths.  Returns the volume
    [D, H, W]: each label's ``fast_cost_plane`` value, masked pixels
    included, +inf where the pixel's own warp sample is invalid."""
    if warped.device.type == "cpu":
        return cost_volume_plain(warped, wvalid, gray_ref, left_valid,
                                 weights, radius=radius,
                                 max_color_diff=max_color_diff,
                                 bad_ret=bad_ret)
    _check_inputs(warped, wvalid, gray_ref, left_valid, weights, radius)
    n_depths = warped.shape[0]
    h, w = gray_ref.shape
    volume = torch.empty((n_depths, h, w), dtype=torch.float32,
                         device=warped.device)
    fn = cuda_build.library("cost_wta").cost_volume_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    with torch.cuda.device(warped.device):
        rc = fn(warped.data_ptr(), wvalid.data_ptr(), gray_ref.data_ptr(),
                left_valid.data_ptr(), weights.data_ptr(), volume.data_ptr(),
                h, w, n_depths, radius, max_color_diff, bad_ret,
                torch.cuda.current_stream().cuda_stream,
                int(runtime_instance(radius)))
    if rc != 0:
        raise RuntimeError(f"cost_wta kernel launch (volume mode) failed: "
                           f"CUDA error {rc}")
    cuda_cost_volume.launches += 1
    return volume


cuda_cost_wta.launches = 0
cuda_cost_volume.launches = 0
