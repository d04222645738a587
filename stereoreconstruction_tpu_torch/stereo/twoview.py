"""Two-view dense stereo engine.

Port of ``stereoreconstruction_tpu/stereo/twoview.py`` (the reference's
``TwoViewStereo``, stereo/twoviewstereo.cpp): a depth sweep over
``t/(5-4t)``-spaced labels with a geodesic-weighted NCC cost, a sequential
WTA with second-best ambiguity rejection (or, with ``use_mrf``, a
dense-label MRF over the whole cost volume, stereo/mrf.py ``twoview_bp``),
and the symmetric cross-check.

The WTA carries (minCost, secondBest, bestDepth) with the reference's exact
sequential update rule (twoviewstereo.cpp:320-326): a label wins only if it
improves by more than 1e-10, and "second best" is the previous best at that
moment (not the global second minimum) — both gate the ambiguity rejection
``minCost > 0.95 * secondBest`` (twoviewstereo.cpp:304).

NaN = never evaluated / masked; +inf = evaluated but rejected (the
reference's DepthMap sentinels).

Methods: ``"kernel"`` (``"auto"``, and the JAX package's ``"fast"`` and
``"pallas"``, resolve to it) runs the warp-first cost through three CUDA
kernels — geodesic weights (ops/cuda_weights.py), the bilinear warp volume
(ops/cuda_warp.py) and the fused cost + WTA, or the cost volume for the
MRF (ops/cuda_cost_wta.py) — which run their plain PyTorch versions on the
CPU; ``"exact"`` samples the other view at each window tap (the
reference's ``cost_ncc``) with float64-chain geodesic weights.  The
cross-checks' scattered read goes through the sampling kernel
(ops/cuda_sample.py).

The SAD cost (``cfg.cost == "sad"``, the reference's ``cost_sad``) has no
kernel of its own, as in the JAX package, which sends it around its Pallas
cost kernel: each label's plane is ``ops/ncc.py sad_cost_plane`` in plain
PyTorch inside the WTA scan (or stacked into the MRF's volume), with the
kernel method's weights from kernel 1 and the exact method's float64-chain
weights.

The JAX package's ``method="pallas"`` returns its WTA map before it reads
``use_mrf``; here every method honours the flag.

Row blocks (``row0``/``full_h``): the row-sharded engine
(parallel/rowshard.py) runs the kernel method's WTA on a block of global
rows [row0, row0 + h) of a full_h-row image.  Rays, the geodesic weights'
validity plane (kernel 1's ``valid``) and the left taps' validity (kernel
4's ``left_valid``) are computed in global rows, so pad rows outside
[0, full_h) act as image borders and a block's rows equal the unsharded
map's; the MRF, the exact method and the SAD cost raise
NotImplementedError on blocks, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import TwoViewConfig
from ..device import resolve_device
from ..geometry.camera import Camera, principal_ray, project, unproject
from ..geometry.rays import _norm
from ..ops.cuda_cost_wta import cuda_cost_volume, cuda_cost_wta, wta_scan
from ..ops.cuda_sample import cuda_sample_nearest
from ..ops.cuda_warp import cuda_warp_bilinear
from ..ops.ncc import _left_windows, sad_cost_plane, twoview_cost_plane
from ..ops.ncc_fast import COORD_SENTINEL
from ..ops.sampling import sample_valid
from ..ops.weights import compute_weights
from ..runtime.trace import trace
from .depthsweep import (depth_labels_twoview, match_points, pixel_rays,
                         point_from_depth)
from .mrf import twoview_bp
from .multiview import (_host_distorted, _host_refractive,
                        resolve_mvs_method as resolve_method)


class TwoViewResult(NamedTuple):
    depth_left: torch.Tensor    # [H, W]
    depth_right: torch.Tensor   # [H, W]


def _sweep_geometry(cam_ref: Camera, cam_oth: Camera, cfg: TwoViewConfig,
                    h: int, w: int, dtype, *, enable_refraction,
                    enable_distortion, row0=0):
    """The depth labels [D] and ``match_at(depth) -> (xy [..., H, W, 2],
    valid)``: the reference's pixel rays (of global rows [row0, row0 + h))
    cut by the plane at ``depth`` along its principal ray (pointFromDepth),
    projected into the other view."""
    kw = dict(enable_refraction=enable_refraction,
              enable_distortion=enable_distortion)
    ray_o, ray_d = pixel_rays(cam_ref, h, w, cfg.image_scale, dtype=dtype,
                              row0=row0, **kw)
    depths = depth_labels_twoview(cfg.min_depth, cfg.max_depth,
                                  cfg.num_depth_levels, dtype=dtype,
                                  device=ray_o.device)
    _, normal = principal_ray(cam_ref)

    def match_at(depth):
        pts, pvalid = point_from_depth(ray_o, ray_d, cam_ref.C, normal, depth)
        return match_points(cam_oth, pts, pvalid, cfg.image_scale, **kw)

    return depths, match_at


def twoview_coords(cam_ref: Camera, cam_oth: Camera, cfg: TwoViewConfig,
                   h: int, w: int, dtype=torch.float32, *, enable_refraction,
                   enable_distortion, row0=0):
    """The depth labels [D] and the match-coordinate volume [D, 2, H, W] of
    one view (the warp kernel's input), of global rows [row0, row0 + H):
    x2/y2 in the other view's scaled pixel frame, -3e6 where the match point
    is invalid."""
    depths, match_at = _sweep_geometry(
        cam_ref, cam_oth, cfg, h, w, dtype,
        enable_refraction=enable_refraction,
        enable_distortion=enable_distortion, row0=row0)
    xy, mvalid = match_at(depths[:, None, None])          # [D, H, W, 2]
    coords = torch.where(mvalid[..., None], xy, COORD_SENTINEL)
    return depths, coords.permute(0, 3, 1, 2).contiguous()


def _block_planes(mask_ref, row0=0, full_h=None):
    """The validity planes of a block of global rows [row0, row0 + h) of a
    full_h-row image (``full_h`` None: the whole image): ``(pixel_valid,
    mask_ref, left_valid)``.  pixel_valid [h, W] marks the in-image rows
    (None for the whole image), mask_ref is restricted to them, and
    left_valid is the left taps' sample() validity: the mask without the
    image's last row and column."""
    h, w = mask_ref.shape
    dev = mask_ref.device
    if full_h is None:
        return None, mask_ref, mask_ref & sample_valid(h, w, dev)
    rows_g = row0 + torch.arange(h, device=dev)
    in_rows = (rows_g >= 0) & (rows_g < full_h)
    pixel_valid = in_rows[:, None].expand(h, w).contiguous()
    mask_ref = mask_ref & pixel_valid
    left_valid = (mask_ref & (rows_g < full_h - 1)[:, None]
                  & (torch.arange(w, device=dev) < w - 1)[None, :])
    return pixel_valid, mask_ref, left_valid


def _kernel_sweep(rgb_ref, gray_ref, mask_ref, gray_oth, mask_oth,
                  cam_ref: Camera, cam_oth: Camera, cfg: TwoViewConfig, *,
                  enable_refraction, enable_distortion, volume=False,
                  row0=0, full_h=None):
    """The kernel method's WTA carry (min_cost, second, best), or with
    ``volume`` the depth labels and the cost volume (depths, [D, H, W]):
    geodesic weights (kernel 1), the coordinate volume, the warp volume
    (kernel 3) and the fused cost sweep (kernel 4, WTA or volume mode).
    ``row0``/``full_h``: the reference view is a row block (module
    docstring)."""
    h, w = gray_ref.shape
    pixel_valid, _, left_valid = _block_planes(mask_ref, row0, full_h)
    weights = compute_weights(rgb_ref, cfg.window_radius, cfg.weights,
                              exact=False,
                              pixel_valid=pixel_valid).to(gray_ref.dtype)
    depths, coords = twoview_coords(cam_ref, cam_oth, cfg, h, w,
                                    gray_ref.dtype,
                                    enable_refraction=enable_refraction,
                                    enable_distortion=enable_distortion,
                                    row0=row0)
    warped, wvalid, _ = cuda_warp_bilinear(coords, gray_oth.contiguous(),
                                           mask_oth.contiguous())
    args = (warped, wvalid, gray_ref.contiguous(), left_valid,
            weights.contiguous())
    kw = dict(radius=cfg.window_radius, max_color_diff=cfg.max_color_diff,
              bad_ret=cfg.bad_ret)
    if volume:
        return depths, cuda_cost_volume(*args, **kw)
    return cuda_cost_wta(depths, *args, **kw)


def _build_cost_fn(rgb_ref, gray_ref, mask_ref, gray_oth, mask_oth,
                   cam_ref: Camera, cam_oth: Camera, cfg: TwoViewConfig, *,
                   enable_refraction, enable_distortion, method):
    """The per-view setup of the label-by-label costs (the exact method,
    and every method of the SAD cost): returns ``(cost_at, depths)`` with
    ``cost_at(d_idx) -> (cost [H, W], depth)``.  Taps sample the other view
    around each match point: bilinearly for NCC (the reference's
    cost_ncc), at truncated pixels for SAD (cost_sad).  The exact method
    takes the float64-chain geodesic weights, the kernel method kernel
    1's."""
    h, w = gray_ref.shape
    radius = cfg.window_radius
    weights = compute_weights(rgb_ref, radius, cfg.weights,
                              exact=(method == "exact")).to(gray_ref.dtype)
    left_vals, left_valid, left_mask = _left_windows(
        gray_ref, mask_ref, radius, use_sample=True)
    depths, match_at = _sweep_geometry(
        cam_ref, cam_oth, cfg, h, w, gray_ref.dtype,
        enable_refraction=enable_refraction,
        enable_distortion=enable_distortion)
    plane = sad_cost_plane if cfg.cost == "sad" else twoview_cost_plane

    def cost_at(d_idx):
        xy, mvalid = match_at(depths[d_idx])
        cost = plane(
            gray_ref, left_vals, left_valid, left_mask, gray_oth, mask_oth,
            weights, xy, mvalid, radius=radius,
            max_color_diff=cfg.max_color_diff, bad_ret=cfg.bad_ret)
        return cost, depths[d_idx]

    return cost_at, depths


def _uses_kernel_sweep(method: str, cfg: TwoViewConfig) -> bool:
    """Whether the warp and cost kernels (3 and 4) compute the costs: the
    kernel method's NCC.  SAD goes label by label, as the JAX package sends
    it around its Pallas cost kernel (twoview.py:270)."""
    return method == "kernel" and cfg.cost != "sad"


def _device_args(rgb_ref, gray_ref, mask_ref, gray_oth, mask_oth,
                 cam_ref: Camera, cam_oth: Camera, device):
    """The one-view inputs as tensors on the resolved device, in the dtype
    of ``gray_ref`` (masks bool)."""
    dev = resolve_device(device)
    gray_ref = torch.as_tensor(gray_ref, device=dev)
    dtype = gray_ref.dtype
    return (torch.as_tensor(rgb_ref, dtype=dtype, device=dev), gray_ref,
            torch.as_tensor(mask_ref, dtype=torch.bool, device=dev),
            torch.as_tensor(gray_oth, dtype=dtype, device=dev),
            torch.as_tensor(mask_oth, dtype=torch.bool, device=dev),
            cam_ref.to(dev, dtype), cam_oth.to(dev, dtype))


def twoview_cost_volume(rgb_ref, gray_ref, mask_ref, gray_oth, mask_oth,
                        cam_ref: Camera, cam_oth: Camera, cfg: TwoViewConfig,
                        *, enable_refraction: bool = True,
                        enable_distortion: bool = True,
                        method: str = "kernel", device=None):
    """The dense two-view cost volume [D, H, W] and the depth labels [D]:
    the tensor the reference's USE_MRF path feeds to graph-cut
    (twoviewstereo.cpp:335-403).  The kernel method's NCC writes it with
    the cost kernel's volume mode; the exact method and the SAD cost stack
    their cost planes.  Masked pixels carry costs too; +inf where a pixel's
    match sample is invalid."""
    method = resolve_method(method)
    args = _device_args(rgb_ref, gray_ref, mask_ref, gray_oth, mask_oth,
                        cam_ref, cam_oth, device) + (cfg,)
    kw = dict(enable_refraction=enable_refraction,
              enable_distortion=enable_distortion)
    if _uses_kernel_sweep(method, cfg):
        depths, volume = _kernel_sweep(*args, volume=True, **kw)
        return volume, depths
    cost_at, depths = _build_cost_fn(*args, method=method, **kw)
    return torch.stack([cost_at(d)[0] for d in range(depths.shape[0])]), \
        depths


def compute_depth_map_oneview(
        rgb_ref, gray_ref, mask_ref, gray_oth, mask_oth,
        cam_ref: Camera, cam_oth: Camera, cfg: TwoViewConfig,
        *, enable_refraction: bool = True, enable_distortion: bool = True,
        method: str = "kernel", use_mrf: bool = False, device=None,
        row0: int = 0, full_h=None):
    """Depth map for one reference view against one other view.

    rgb_ref [H, W, 3]; gray/masks [H, W]; the dtype of ``gray_ref`` sets the
    sweep's dtype (the kernel method runs in float32).  Returns depth
    [H, W] on ``device`` (CUDA unless the caller names another), with NaN
    where masked and +inf where rejected.

    ``use_mrf``: the depth of each pixel's ``twoview_bp`` label over the
    cost volume (``cfg.smoothness_*``), NaN where masked; no second-best
    rejection on this path.

    ``row0``/``full_h``: the reference view is the block of global rows
    [row0, row0 + H) of a full_h-row image (module docstring); the kernel
    method's NCC WTA only, else NotImplementedError."""
    method = resolve_method(method)
    if full_h is not None and (use_mrf or not _uses_kernel_sweep(method,
                                                                 cfg)):
        raise NotImplementedError(
            "row blocks support the kernel method's NCC WTA only")
    args = _device_args(rgb_ref, gray_ref, mask_ref, gray_oth, mask_oth,
                        cam_ref, cam_oth, device) + (cfg,)
    gray_ref, mask_ref = args[1], args[2]
    if full_h is not None:
        # restricted to the block's in-image rows
        mask_ref = _block_planes(mask_ref, row0, full_h)[1]
    dtype = gray_ref.dtype
    kw = dict(enable_refraction=enable_refraction,
              enable_distortion=enable_distortion)

    if use_mrf:
        # Dense-label MRF over the cost volume (the reference's USE_MRF
        # graph-cut path, twoviewstereo.cpp:335-403) via min-sum BP with
        # truncated-linear smoothness.
        volume, depths = twoview_cost_volume(*args, method=method,
                                             device=gray_ref.device, **kw)
        labels, _ = twoview_bp(volume,
                               smoothness_lambda=cfg.smoothness_lambda,
                               smoothness_max=cfg.smoothness_max,
                               smoothness_exp=cfg.smoothness_exp)
        best = depths[labels.to(torch.int64)]
        return torch.where(mask_ref, best, torch.nan)

    if _uses_kernel_sweep(method, cfg):
        min_cost, second, best = _kernel_sweep(*args, row0=row0,
                                               full_h=full_h, **kw)
    else:
        cost_at, depths = _build_cost_fn(*args, method=method, **kw)
        min_cost, second, best = wta_scan(cost_at, depths, gray_ref.shape,
                                          dtype)

    # Ambiguity rejection (twoviewstereo.cpp:304-305); masked pixels stay
    # NaN (twoviewstereo.cpp:269-271).
    best = torch.where(min_cost > cfg.second_best_factor * second,
                       torch.inf, best)
    return torch.where(mask_ref, best, torch.nan)


def _reproject(depth_a, depth_b, cam_a: Camera, cam_b: Camera, image_scale,
               *, nonneg, row0=0, **kw):
    """The cross-checks' geometry: each pixel's 3D point from ``depth_a``,
    its projection into view b, ``depth_b`` read there (the scattered
    ``depth_b[iy, ix]`` read, through the sampling kernel) and the point
    view b reconstructs from that depth.  A depth is usable where finite
    (and with ``nonneg`` not negative).  Returns (usable_a, p1, v1, ok_b,
    p2, v2): v1 / v2 the plane intersections, ok_b the projection valid,
    inside view b and onto a usable depth.  ``row0``: the global row of
    depth_a's first row when it is a row block."""
    h, w = depth_a.shape
    hb, wb = depth_b.shape
    ray_o, ray_d = pixel_rays(cam_a, h, w, image_scale, dtype=depth_a.dtype,
                              row0=row0, **kw)
    _, na = principal_ray(cam_a)
    _, nb = principal_ray(cam_b)

    usable = torch.isfinite(depth_a)
    if nonneg:
        usable &= depth_a >= 0
    p1, v1 = point_from_depth(ray_o, ray_d, cam_a.C, na,
                              torch.where(usable, depth_a, 1.0))
    xy_full, vproj = project(cam_b, p1, quartic_iters=30, **kw)
    x2 = xy_full[..., 0] * image_scale
    y2 = xy_full[..., 1] * image_scale
    contains = (x2 >= 0) & (y2 >= 0) & (x2 < wb) & (y2 < hb)
    odepth, ofinite, _ = cuda_sample_nearest(depth_b.contiguous()[None],
                                             x2[None], y2[None])
    odepth, ousable = odepth[0], ofinite[0]
    if nonneg:
        ousable &= odepth >= 0

    # the reference unprojects at the *float* scaled coords + 0.5
    oxy = torch.stack([(x2 + 0.5) / image_scale, (y2 + 0.5) / image_scale],
                      dim=-1)
    ray2_o, ray2_d = unproject(cam_b, oxy, **kw)
    p2, v2 = point_from_depth(ray2_o, ray2_d, cam_b.C, nb,
                              torch.where(ousable, odepth, 1.0))
    return usable, p1, v1, vproj & contains & ousable, p2, v2


def cross_check_direction(depth_a, depth_b, cam_a: Camera, cam_b: Camera,
                          image_scale, inconsistency_thresh, *,
                          enable_refraction=True, enable_distortion=True,
                          row0=0):
    """One direction of the symmetric cross-check
    (``TwoViewStereo::crossCheck`` twoviewstereo.cpp:596-672).

    Invalidates (-> inf) pixels of ``depth_a`` whose 3D point disagrees with
    the point reconstructed from ``depth_b`` at the reprojected pixel by
    more than ``inconsistency_thresh``.  Pixels whose own plane intersection
    fails are left untouched (the reference keeps them).

    ``row0``: global row of depth_a's first row when depth_a is a row block
    (depth_b is always the whole other map)."""
    finite, p1, v1, ok_b, p2, v2 = _reproject(
        depth_a, depth_b, cam_a, cam_b, image_scale, nonneg=False, row0=row0,
        enable_refraction=enable_refraction,
        enable_distortion=enable_distortion)
    norm = _norm(p1 - p2)
    consistent = torch.isfinite(norm) & (norm <= inconsistency_thresh) & v2
    # failure ladder (twoviewstereo.cpp:617-633): any failed stage after a
    # successful pointFromDepth -> inf; a failed pointFromDepth -> keep
    reject = v1 & ~(ok_b & consistent)
    return torch.where(finite & reject, torch.inf, depth_a)


def cross_check_classify(depth_a, depth_b, cam_a: Camera, cam_b: Camera,
                         image_scale, thresh, *, enable_refraction=True,
                         enable_distortion=True, device=None):
    """Three-way audit of ``depth_a`` pixels against an independently
    computed ``depth_b``: returns bool maps ``(corroborated, checkable)``
    on ``device`` (CUDA unless the caller names another).

    checkable — the pixel has a usable (finite, non-negative) depth, its
    3D point projects into view b onto a pixel where depth_b has a usable
    value;
    corroborated — checkable AND the two 3D points agree within
    ``thresh`` (the crossCheck metric, twoviewstereo.cpp:596-672, without
    its failure ladder: un-projectable/uncovered pixels are *unverifiable*
    here, not rejected).

    The depth_b read goes through kernel 5, which takes float32 only: on
    CUDA a ``depth_a`` of any other dtype raises ValueError (float64 runs
    on the CPU)."""
    dev = resolve_device(device)
    depth_a = torch.as_tensor(depth_a, device=dev)
    dtype = depth_a.dtype
    if dev.type == "cuda" and dtype != torch.float32:
        raise ValueError(f"cross_check_classify on {dev} takes float32 "
                         f"depths (kernel 5), got {dtype}")
    depth_b = torch.as_tensor(depth_b, dtype=dtype, device=dev)
    usable, p1, v1, ok_b, p2, v2 = _reproject(
        depth_a, depth_b, cam_a.to(dev, dtype), cam_b.to(dev, dtype),
        image_scale, nonneg=True, enable_refraction=enable_refraction,
        enable_distortion=enable_distortion)
    norm = _norm(p1 - p2)
    checkable = usable & v1 & ok_b & v2
    corroborated = checkable & torch.isfinite(norm) & (norm <= thresh)
    return corroborated, checkable


def cross_check_pair(depth_l, depth_r, cam_l: Camera, cam_r: Camera,
                     cfg: TwoViewConfig, **kw):
    """Symmetric cross-check in the reference's sequential order: the right
    pass sees the already-invalidated left map."""
    depth_l2 = cross_check_direction(depth_l, depth_r, cam_l, cam_r,
                                     cfg.image_scale,
                                     cfg.inconsistency_thresh, **kw)
    depth_r2 = cross_check_direction(depth_r, depth_l2, cam_r, cam_l,
                                     cfg.image_scale,
                                     cfg.inconsistency_thresh, **kw)
    return depth_l2, depth_r2


def host_stages(cam_a: Camera, cam_b: Camera, enable_refraction=True,
                enable_distortion=True) -> dict:
    """Host-level demotion of a pair's projection stages: when neither
    camera has an interface (Camera::isRefractive_, camera.cpp:329/339) or
    any distortion, the stage is the identity; it is skipped for the whole
    sweep.  Returns the engines' enable_refraction/enable_distortion."""
    return dict(
        enable_refraction=enable_refraction and (
            _host_refractive(cam_a) or _host_refractive(cam_b)),
        enable_distortion=enable_distortion and (
            _host_distorted(cam_a) or _host_distorted(cam_b)))


def compute_depth_maps(rgb_l, mask_l, rgb_r, mask_r, cam_l: Camera,
                       cam_r: Camera, cfg: TwoViewConfig, *,
                       cross_check: bool = True,
                       enable_refraction: bool = True,
                       enable_distortion: bool = True,
                       method: str = "auto", use_mrf: bool = False,
                       dtype=torch.float32, device=None) -> TwoViewResult:
    """Full TwoViewStereo::computeDepthMaps flow (both views + cross-check).

    rgb_*: [H, W, 3] (0..255) already scaled to working size; mask_*:
    [H, W] bool; cameras on any device and dtype (cast to ``dtype``).
    Returns both depth maps on ``device`` (CUDA unless the caller names
    another); ``use_mrf`` as in ``compute_depth_map_oneview``."""
    method = resolve_method(method)
    dev = resolve_device(device)
    rgb_l = torch.as_tensor(rgb_l, dtype=dtype, device=dev)
    rgb_r = torch.as_tensor(rgb_r, dtype=dtype, device=dev)
    mask_l = torch.as_tensor(mask_l, dtype=torch.bool, device=dev)
    mask_r = torch.as_tensor(mask_r, dtype=torch.bool, device=dev)
    gray_l = 0.11 * rgb_l[..., 0] + 0.59 * rgb_l[..., 1] + 0.3 * rgb_l[..., 2]
    gray_r = 0.11 * rgb_r[..., 0] + 0.59 * rgb_r[..., 1] + 0.3 * rgb_r[..., 2]
    cam_l = cam_l.to(dev, dtype)
    cam_r = cam_r.to(dev, dtype)
    kw = host_stages(cam_l, cam_r, enable_refraction, enable_distortion)

    # stage timers, as the JAX package's (on CUDA they time the host's
    # dispatch; runtime.trace.device_trace gives the device's time)
    with trace("twoview/left"):
        depth_l = compute_depth_map_oneview(
            rgb_l, gray_l, mask_l, gray_r, mask_r, cam_l, cam_r, cfg,
            method=method, use_mrf=use_mrf, device=dev, **kw)
    with trace("twoview/right"):
        depth_r = compute_depth_map_oneview(
            rgb_r, gray_r, mask_r, gray_l, mask_l, cam_r, cam_l, cfg,
            method=method, use_mrf=use_mrf, device=dev, **kw)
    if cross_check:
        with trace("twoview/cross_check"):
            depth_l, depth_r = cross_check_pair(depth_l, depth_r, cam_l,
                                                cam_r, cfg, **kw)
    return TwoViewResult(depth_left=depth_l, depth_right=depth_r)
