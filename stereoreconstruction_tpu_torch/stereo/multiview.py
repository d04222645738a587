"""Multi-view stereo engine — Campbell et al. 2009 "Using Multiple
Hypotheses to Improve Depth-Maps for Multi-View Stereo".

Port of ``stereoreconstruction_tpu/stereo/multiview.py`` (the reference's
``MultiViewStereo``, stereo/multiviewstereo.cpp):

* neighbour selection: for each view, the <= 3 closest cameras whose
  principal rays satisfy |dot| > 0.2 (multiviewstereo.cpp:335-360), on the
  host;
* initial estimate: uniform depth sweep, raw-NCC cost (radius 2, no mask
  checks) against every neighbour; a sample is a *peak* when NCC > 0.95
  (multiviewstereo.cpp:589); WTA takes the best peak (ties -> larger depth)
  and falls back to the reference's ``-1`` when no peak exists;
* MRF (``cfg.use_mrf``): the K best peaks of each pixel, ascending, are the
  labels of a Campbell MRF (stereo/mrf.py ``trws_optimize``) whose
  minimiser picks one hypothesis or "unknown" per pixel;
* cross-check: a depth survives if *any* other view agrees within
  ``crossCheckThreshold`` (multiviewstereo.cpp:666-729); sequential over
  views (later views see earlier invalidations), failures -> NaN.

Methods: ``"kernel"`` (``"auto"`` resolves to it) sweeps through the CUDA
kernels (ops/cuda_weights.py, ops/cuda_mvs.py in its WTA or top-K mode),
which run their plain PyTorch versions on the CPU; ``"exact"`` is the
gather formulation with float64 geodesic weights.  The JAX package's
``"fast"`` and ``"pallas"`` methods are TPU formulations of the kernel
method and map to it.  The cross-check's scattered read goes through the
sampling kernel (ops/cuda_sample.py) on both methods.

Dispatch (as the JAX package's ``mvs_depth_maps``): without a checkpoint
and a depth group, ``mvs_depth_maps`` runs the batched functions
(``mvs_initial_estimates_batched``, ``mvs_batched_with_cross_check``,
``mvs_batched_mrf_with_cross_check``), which run the views one at a time
as the JAX package's scan does; with either, the per-view loop.  Both give
the same maps bit for bit.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..config import MultiViewConfig
from ..device import resolve_device
from ..geometry.camera import (Camera, broadcast_camera, camera_at, project,
                               principal_ray, stack_cameras, unproject)
from ..geometry.rays import _norm
from ..ops.cuda_mvs import (cuda_mvs_topk, cuda_mvs_wta, mvs_topk_slab,
                            mvs_wta_slab)
from ..ops.cuda_sample import cuda_sample_nearest
from ..ops.ncc import _left_windows, mvs_cost_plane
from ..ops.weights import compute_weights
from ..runtime.trace import trace
from .depthsweep import (depth_labels_uniform, match_points, pixel_rays,
                         point_from_depth)
from .mrf import labels_to_depth, trws_optimize

_COORD_SENTINEL = -3e6   # invalid base sample in the coordinate volume


def _host_refractive(cam: Camera) -> bool:
    """Camera::isRefractive_ evaluated on host scalars."""
    return (abs(float(cam.refr_index) - 1.0) > 1e-10
            and abs(float(cam.plane_dist)) > 1e-10)


def _host_distorted(cam: Camera) -> bool:
    return bool((cam.dist.abs() > 1e-10).any())


def select_neighbours(cams: Sequence[Camera],
                      cfg: MultiViewConfig) -> List[List[int]]:
    """Per-view neighbour indices (multiviewstereo.cpp:335-360)."""
    dirs = [principal_ray(c)[1].cpu().numpy() for c in cams]
    centers = [c.C.cpu().numpy() for c in cams]
    out = []
    for i in range(len(cams)):
        cands = []
        for j in range(len(cams)):
            if i == j:
                continue
            if abs(float(dirs[i] @ dirs[j])) > cfg.view_angle_cos_min:
                d = float(np.sum((centers[i] - centers[j]) ** 2))
                cands.append((d, j))
        cands.sort()
        out.append([j for _, j in cands[:cfg.num_neighbouring_views]])
    return out


def resolve_mvs_method(method: str) -> str:
    """"exact", or "kernel" for "auto" and for the JAX package's TPU
    formulations "fast" and "pallas" (same values as the kernel method)."""
    if method in ("auto", "kernel", "fast", "pallas"):
        return "kernel"
    if method == "exact":
        return "exact"
    raise ValueError(f"unknown stereo method {method!r}")


def mvs_prepare_batched(cams: Sequence[Camera], cfg: MultiViewConfig,
                        dtype=torch.float32, device="cpu"):
    """Host-side prep: neighbour selection, camera casting, refraction /
    distortion demotion and padded-neighbour stacking.

    Returns ``(cams_all, cams_nbr, nbr_idx, nbr_valid, enable_refraction,
    enable_distortion)``: cams_all a Camera stacked over
    views [V], cams_nbr stacked over views and padded neighbours [V, N],
    nbr_idx [V, N] int and nbr_valid [V, N] bool (numpy).  Views with fewer
    neighbours pad with their first neighbour, masked by nbr_valid
    (multiviewstereo.cpp:335-360 gives edge cameras fewer)."""
    neighbours = select_neighbours(cams, cfg)
    cams = [c.to(device, dtype) for c in cams]
    enable_refraction = any(_host_refractive(c) for c in cams)
    enable_distortion = any(_host_distorted(c) for c in cams)

    n_pad = max((len(n) for n in neighbours), default=0)
    nbr_idx, nbr_valid = [], []
    for nbr in neighbours:
        nbr_valid.append([True] * len(nbr) + [False] * (n_pad - len(nbr)))
        nbr_idx.append(list(nbr) + [nbr[0] if nbr else 0]
                       * (n_pad - len(nbr)))
    cams_nbr = stack_cameras([stack_cameras([cams[j] for j in nbr])
                              for nbr in nbr_idx])
    return (stack_cameras(cams), cams_nbr, np.asarray(nbr_idx),
            np.asarray(nbr_valid, bool), enable_refraction,
            enable_distortion)


def mvs_kernel_inputs(rgb_ref, gray_ref, mask_ref, grays_nbr,
                      cam_ref: Camera, cams_nbr: Camera,
                      cfg: MultiViewConfig, *, enable_refraction,
                      enable_distortion, label0=0, n_labels=None):
    """Inputs of the sweep kernel for one view: the geodesic weights (kernel
    1), the left windows and the [n_labels, N, 2, H, W] match-coordinate
    volume (exact float32 geometry) of labels [label0, label0 + n_labels).

    Returns a dict of ``cuda_mvs_wta``'s tensor arguments (those of
    ``cuda_mvs_topk`` and ``center_valid``)."""
    dtype = gray_ref.dtype
    h, w = gray_ref.shape
    radius = cfg.window_radius
    size = 2 * radius + 1
    if n_labels is None:
        n_labels = cfg.num_depth_levels - label0

    weights = compute_weights(rgb_ref, radius, cfg.weights,
                              exact=False).to(dtype)
    left_vals, left_valid, _ = _left_windows(gray_ref, mask_ref, radius)

    ray_o, ray_d = pixel_rays(cam_ref, h, w, cfg.image_scale,
                              enable_refraction=enable_refraction,
                              enable_distortion=enable_distortion,
                              dtype=dtype)
    depths = depth_labels_uniform(cfg.min_depth, cfg.max_depth,
                                  cfg.num_depth_levels, dtype=dtype,
                                  device=gray_ref.device)
    slab = depths[label0:label0 + n_labels]
    _, normal = principal_ray(cam_ref)
    pts, pvalid = point_from_depth(ray_o, ray_d, cam_ref.C, normal,
                                   slab[:, None, None])    # [n, H, W, 3]
    xy, mvalid = match_points(
        broadcast_camera(cams_nbr, 3), pts, pvalid, cfg.image_scale,
        enable_refraction=enable_refraction,
        enable_distortion=enable_distortion)                # [N, n, H, W, 2]
    coords = torch.where(mvalid[..., None], xy, _COORD_SENTINEL)
    return dict(
        depths=depths,
        coords=coords.permute(1, 0, 4, 2, 3).contiguous(),
        gray_nbr=grays_nbr.contiguous(),
        gl=left_vals.reshape(size * size, h, w).contiguous(),
        lv=left_valid.reshape(size * size, h, w).contiguous(),
        weights=weights.reshape(size * size, h, w).contiguous(),
        center_valid=mask_ref.contiguous())


def _mvs_kernel_sweep(rgb_ref, gray_ref, mask_ref, grays_nbr,
                      cam_ref: Camera, cams_nbr: Camera,
                      cfg: MultiViewConfig, *, enable_refraction,
                      enable_distortion, nbr_valid, with_topk=False,
                      label0=0, n_labels=None):
    """Raw WTA carry (best_ncc, best_depth) [H, W], or with ``with_topk``
    the raw ascending top-K lists [K, H, W], of labels [label0, label0 +
    n_labels) through the sweep kernel."""
    inputs = mvs_kernel_inputs(
        rgb_ref, gray_ref, mask_ref, grays_nbr, cam_ref, cams_nbr, cfg,
        enable_refraction=enable_refraction,
        enable_distortion=enable_distortion, label0=label0,
        n_labels=n_labels)
    kw = dict(nbr_valid=nbr_valid, radius=cfg.window_radius,
              thr=float(cfg.ncc_threshold), label0=label0)
    if with_topk:
        del inputs["center_valid"]          # top-K sweeps every pixel
        ncc, depth, _ = cuda_mvs_topk(top_k=cfg.top_k, **kw, **inputs)
    else:
        ncc, depth, _ = cuda_mvs_wta(**kw, **inputs)
    return ncc, depth


def _build_mvs_cost_fn(rgb_ref, gray_ref, mask_ref, grays_nbr,
                       cam_ref: Camera, cams_nbr: Camera,
                       cfg: MultiViewConfig, *, enable_refraction,
                       enable_distortion, nbr_valid):
    """The exact method's per-view setup: returns ``(plane_cost, depths)``
    with ``plane_cost(d_idx) -> ncc [N, H, W]`` at depth label ``d_idx``.

    Taps are the other view's integer-pixel windows (the MVS cost's pixel()
    lookups, multiviewstereo.cpp:151-158), gathered; weights are the
    float64-chain geodesic weights."""
    dtype = gray_ref.dtype
    h, w = gray_ref.shape
    radius = cfg.window_radius

    weights = compute_weights(rgb_ref, radius, cfg.weights,
                              exact=True).to(dtype)
    left_vals, left_valid, _ = _left_windows(gray_ref, mask_ref, radius)
    ray_o, ray_d = pixel_rays(cam_ref, h, w, cfg.image_scale,
                              enable_refraction=enable_refraction,
                              enable_distortion=enable_distortion,
                              dtype=dtype)
    depths = depth_labels_uniform(cfg.min_depth, cfg.max_depth,
                                  cfg.num_depth_levels, dtype=dtype,
                                  device=gray_ref.device)
    _, normal = principal_ray(cam_ref)
    cams_b = broadcast_camera(cams_nbr, 2)

    def plane_cost(d_idx):
        pts, pvalid = point_from_depth(ray_o, ray_d, cam_ref.C, normal,
                                       depths[d_idx])
        xy, mvalid = match_points(
            cams_b, pts, pvalid, cfg.image_scale,
            enable_refraction=enable_refraction,
            enable_distortion=enable_distortion)            # [N, H, W, 2]
        ncc = torch.stack([
            mvs_cost_plane(left_vals, left_valid, grays_nbr[n], weights,
                           xy[n], mvalid[n], radius=radius)
            for n in range(grays_nbr.shape[0])])
        return torch.where(nbr_valid[:, None, None], ncc, -torch.inf)

    return plane_cost, depths


def mvs_finalize_wta(best_ncc, best_depth, mask_ref):
    """WTA carry -> depth map with the reference's sentinels
    (multiviewstereo.cpp:559-566, 654-661): -1 without a peak, inf where
    the reference pixel is masked."""
    depth_map = torch.where(torch.isfinite(best_ncc), best_depth, -1.0)
    return torch.where(mask_ref, depth_map, torch.inf)


def _mrf_depth(top_ncc, top_depth, mask_ref, cfg: MultiViewConfig):
    """The USE_MRF flow on one view's hypothesis lists: TRW-S with
    ``cfg.mrf_max_iters``, ``labels_to_depth``, inf where masked."""
    res = trws_optimize(top_ncc, top_depth, cfg, max_iters=cfg.mrf_max_iters)
    return torch.where(mask_ref, labels_to_depth(res.labels, top_depth),
                       torch.inf)


def mvs_initial_estimate_oneview(
        rgb_ref, gray_ref, mask_ref, grays_nbr, masks_nbr,
        cam_ref: Camera, cams_nbr: Camera, cfg: MultiViewConfig, *,
        enable_refraction=True, enable_distortion=True,
        method: str = "auto", nbr_valid=None, with_topk=False, device=None):
    """Initial WTA depth map [H, W] for one view against its stacked
    neighbours (grays_nbr/masks_nbr [N, H, W], cams_nbr a Camera stacked
    over N): -1 where no peak, inf where masked.  With ``with_topk``, the
    (ncc, depth) top-K hypothesis volume instead, ``[K, H, W] x 2`` sorted
    ascending, no-peak slots (0, -1), for every pixel.  ``nbr_valid`` ([N]
    bool) marks which stacked neighbours are real.  The dtype of
    ``gray_ref`` sets the sweep's dtype."""
    dev = resolve_device(device)
    gray_ref = torch.as_tensor(gray_ref, device=dev)
    dtype = gray_ref.dtype
    rgb_ref = torch.as_tensor(rgb_ref, dtype=dtype, device=dev)
    mask_ref = torch.as_tensor(mask_ref, dtype=torch.bool, device=dev)
    grays_nbr = torch.as_tensor(grays_nbr, dtype=dtype, device=dev)
    cam_ref = cam_ref.to(dev, dtype)
    cams_nbr = cams_nbr.to(dev, dtype)
    n_nbr = grays_nbr.shape[0]
    if nbr_valid is None:
        nbr_valid = torch.ones((n_nbr,), dtype=torch.bool, device=dev)
    nbr_valid = torch.as_tensor(nbr_valid, dtype=torch.bool, device=dev)
    kw = dict(enable_refraction=enable_refraction,
              enable_distortion=enable_distortion, nbr_valid=nbr_valid)

    if resolve_mvs_method(method) == "kernel":
        ncc, depth = _mvs_kernel_sweep(
            rgb_ref, gray_ref, mask_ref, grays_nbr, cam_ref, cams_nbr, cfg,
            with_topk=with_topk, **kw)
    else:
        plane_cost, depths = _build_mvs_cost_fn(
            rgb_ref, gray_ref, mask_ref, grays_nbr, cam_ref, cams_nbr, cfg,
            **kw)
        if with_topk:
            ncc, depth = mvs_topk_slab(plane_cost, depths, cfg.top_k,
                                       cfg.ncc_threshold, gray_ref.shape)
        else:
            ncc, depth = mvs_wta_slab(plane_cost, depths, cfg.ncc_threshold,
                                      gray_ref.shape)
    if with_topk:
        # the reference's (0, -1) no-peak default (mvs cpp:600-607)
        return torch.where(torch.isfinite(ncc), ncc, 0.0), depth
    return mvs_finalize_wta(ncc, depth, mask_ref)


def mvs_cross_check_oneview(depth_ref, depths_all, view_index,
                            cam_ref: Camera, cams_all: Camera,
                            cfg: MultiViewConfig, *,
                            enable_refraction=True, enable_distortion=True):
    """Any-view cross-check for one view (multiviewstereo.cpp:666-729).

    depths_all: [V, H, W] current state of every view's map (this one is
    skipped by index); cams_all: Camera stacked over V.  Returns the updated
    depth_ref: NaN where no other view agrees."""
    dtype = depth_ref.dtype
    h, w = depth_ref.shape
    n_views = depths_all.shape[0]
    kw = dict(enable_refraction=enable_refraction,
              enable_distortion=enable_distortion)

    ray_o, ray_d = pixel_rays(cam_ref, h, w, cfg.image_scale, dtype=dtype,
                              **kw)
    _, na = principal_ray(cam_ref)
    finite = torch.isfinite(depth_ref)
    depth_safe = torch.where(finite, depth_ref, 1.0)
    p1, v1 = point_from_depth(ray_o, ray_d, cam_ref.C, na, depth_safe)

    cams_b = broadcast_camera(cams_all, 2)                  # [V, 1, 1]
    xy_full, vproj = project(cams_b, p1, quartic_iters=30, **kw)
    x2 = xy_full[..., 0] * cfg.image_scale                  # [V, H, W]
    y2 = xy_full[..., 1] * cfg.image_scale

    # the scattered depth[iy, ix] read of every other view: the sampling
    # kernel (its finite mask marks NaN/inf depths)
    od, ofinite, _ = cuda_sample_nearest(depths_all.contiguous(), x2, y2)
    od_safe = torch.where(ofinite, od, 1.0)

    contains = (x2 >= 0) & (y2 >= 0) & (x2 < w) & (y2 < h)
    oxy = torch.stack([(x2 + 0.5) / cfg.image_scale,
                       (y2 + 0.5) / cfg.image_scale], dim=-1)
    r2o, r2d = unproject(cams_b, oxy, **kw)
    _, nb = principal_ray(cams_b)
    p2, v2 = point_from_depth(r2o, r2d, cams_b.C, nb, od_safe)
    norm = _norm(p1 - p2)
    agree = (vproj & contains & ofinite & v2 & torch.isfinite(norm)
             & (norm < cfg.cross_check_threshold))
    other = torch.arange(n_views, device=agree.device) != view_index
    found = (agree & other[:, None, None]).any(dim=0)

    # pointFromDepth failure for the reference pixel -> keep as is.
    return torch.where(finite & v1 & ~found, torch.nan, depth_ref)


def mvs_cross_check_all(depths_all, cams_all: Camera, cfg: MultiViewConfig,
                        *, enable_refraction=True, enable_distortion=True):
    """Sequential any-view cross-check over every view: later views see
    earlier invalidations (multiviewstereo.cpp:666-729 over all views)."""
    state = depths_all.clone()
    for i in range(state.shape[0]):
        state[i] = mvs_cross_check_oneview(
            state[i], state, i, camera_at(cams_all, i), cams_all, cfg,
            enable_refraction=enable_refraction,
            enable_distortion=enable_distortion)
    return state


def _scan_views(rgbs, grays, masks, grays_nbr, masks_nbr,
                cams_all: Camera, cams_nbr: Camera, nbr_valid,
                cfg: MultiViewConfig, n_neighbours: int, *,
                enable_refraction, enable_distortion, method, use_mrf,
                device):
    """Every view's initial estimate in view order, one view at a time as
    the JAX package's scan runs them: ``mvs_initial_estimate_oneview``'s
    WTA map, or with ``use_mrf`` its top-K lists through ``_mrf_depth``.
    Returns depths [V, H, W]."""
    dev = resolve_device(device)
    grays = torch.as_tensor(grays, device=dev)
    dtype = grays.dtype
    rgbs = torch.as_tensor(rgbs, dtype=dtype, device=dev)
    masks = torch.as_tensor(masks, dtype=torch.bool, device=dev)
    grays_nbr = torch.as_tensor(grays_nbr, dtype=dtype, device=dev)
    masks_nbr = torch.as_tensor(masks_nbr, dtype=torch.bool, device=dev)
    cams_all = cams_all.to(dev, dtype)
    cams_nbr = cams_nbr.to(dev, dtype)
    nbr_valid = torch.as_tensor(nbr_valid, dtype=torch.bool, device=dev)
    if grays_nbr.shape[1] != n_neighbours:
        raise ValueError(f"grays_nbr has {grays_nbr.shape[1]} neighbours, "
                         f"n_neighbours is {n_neighbours}")
    depths = []
    for i in range(grays.shape[0]):
        est = mvs_initial_estimate_oneview(
            rgbs[i], grays[i], masks[i], grays_nbr[i], masks_nbr[i],
            camera_at(cams_all, i), camera_at(cams_nbr, i), cfg,
            enable_refraction=enable_refraction,
            enable_distortion=enable_distortion, method=method,
            nbr_valid=nbr_valid[i], with_topk=use_mrf, device=dev)
        depths.append(_mrf_depth(*est, masks[i], cfg) if use_mrf else est)
    return torch.stack(depths)


def mvs_initial_estimates_batched(
        rgbs, grays, masks, grays_nbr, masks_nbr, cams_all: Camera,
        cams_nbr: Camera, nbr_valid, cfg: MultiViewConfig,
        n_neighbours: int, *, enable_refraction=True,
        enable_distortion=True, method: str = "fast", device=None):
    """Initial WTA estimates for every view (the JAX package's scan of
    ``mvs_initial_estimate_oneview``).

    rgbs [V, H, W, 3]; grays/masks [V, H, W]; grays_nbr/masks_nbr
    [V, N, H, W]; cams_all/cams_nbr Cameras stacked over V / (V, N);
    nbr_valid [V, N] bool; n_neighbours the padded N.  The dtype of
    ``grays`` sets the sweep's.  Returns depths [V, H, W] on ``device``
    (CUDA unless the caller names another), equal bit for bit to the
    per-view ``mvs_initial_estimate_oneview``."""
    return _scan_views(
        rgbs, grays, masks, grays_nbr, masks_nbr, cams_all, cams_nbr,
        nbr_valid, cfg, n_neighbours, enable_refraction=enable_refraction,
        enable_distortion=enable_distortion, method=method, use_mrf=False,
        device=device)


def mvs_batched_with_cross_check(
        rgbs, grays, masks, grays_nbr, masks_nbr, cams_all: Camera,
        cams_nbr: Camera, nbr_valid, cfg: MultiViewConfig,
        n_neighbours: int, *, enable_refraction=True,
        enable_distortion=True, method: str = "auto", device=None):
    """``mvs_initial_estimates_batched`` then the any-view cross-check
    (``mvs_cross_check_all``) over every view."""
    depths = mvs_initial_estimates_batched(
        rgbs, grays, masks, grays_nbr, masks_nbr, cams_all, cams_nbr,
        nbr_valid, cfg, n_neighbours, enable_refraction=enable_refraction,
        enable_distortion=enable_distortion, method=method, device=device)
    return mvs_cross_check_all(
        depths, cams_all.to(depths.device, depths.dtype), cfg,
        enable_refraction=enable_refraction,
        enable_distortion=enable_distortion)


def mvs_batched_mrf_with_cross_check(
        rgbs, grays, masks, grays_nbr, masks_nbr, cams_all: Camera,
        cams_nbr: Camera, nbr_valid, cfg: MultiViewConfig,
        n_neighbours: int, *, enable_refraction=True,
        enable_distortion=True, method: str = "auto",
        cross_check: bool = True, device=None):
    """The USE_MRF flow for every view, one view at a time: its top-K
    hypothesis lists, TRW-S and ``labels_to_depth`` (inf where masked);
    then the any-view cross-check when ``cross_check``.  Arguments as
    ``mvs_initial_estimates_batched``."""
    depths = _scan_views(
        rgbs, grays, masks, grays_nbr, masks_nbr, cams_all, cams_nbr,
        nbr_valid, cfg, n_neighbours, enable_refraction=enable_refraction,
        enable_distortion=enable_distortion, method=method, use_mrf=True,
        device=device)
    if not cross_check:
        return depths
    return mvs_cross_check_all(
        depths, cams_all.to(depths.device, depths.dtype), cfg,
        enable_refraction=enable_refraction,
        enable_distortion=enable_distortion)


def mvs_depth_maps(rgbs, masks, cams: Sequence[Camera],
                   cfg: MultiViewConfig, *, cross_check=True,
                   enable_refraction=True, enable_distortion=True,
                   method: str = "auto", dtype=torch.float32,
                   checkpoint=None, view_ids: Sequence[str] = None,
                   device=None, depth_group=None):
    """Full MultiViewStereo::runTask flow: the WTA path, or with
    ``cfg.use_mrf`` the USE_MRF flow (per view the top-K hypothesis volume,
    ``trws_optimize`` with ``cfg.mrf_max_iters`` and ``labels_to_depth``,
    inf where masked), then the any-view cross-check when ``cross_check``.

    rgbs: [V, H, W, 3] (0..255); masks: [V, H, W] bool; cams: per-view
    Cameras (any device and dtype; the sweep casts them to ``dtype``).
    Returns depths [V, H, W] on ``device`` (CUDA unless the caller names
    another).

    Without ``checkpoint`` and ``depth_group`` (and with at least one
    view) the batched functions run, as in the JAX package:
    ``mvs_batched_mrf_with_cross_check`` when ``cfg.use_mrf``, else
    ``mvs_batched_with_cross_check`` or, without the cross-check,
    ``mvs_initial_estimates_batched``.  With either, the per-view loop
    below runs; both give the same maps bit for bit.

    checkpoint: optional ``runtime.checkpoint.DepthCheckpoint``.  A view
    whose initial estimate (before the cross-check) the store holds for
    this config and shape is loaded instead of swept; every other view's
    estimate is saved as it completes, so an interrupted run resumes
    mid-task.  The cross-check then runs on the stacked maps.  view_ids
    names the views in the store (defaults to the index).

    depth_group: a ``torch.distributed`` process group (``parallel/``'s
    depth group; this process one of its ranks) over which each view's
    depth sweep is slab-sharded
    (parallel/depthshard.mvs_initial_estimate_depthsharded; requires
    ``cfg.num_depth_levels`` divisible by the group's size).  Per-view
    results equal the unsharded sweep's bit for bit.  As in the JAX
    package, the exact method has no slab backend (the kernel method runs
    per slab) and ``cfg.use_mrf`` runs unsharded; a checkpoint works with
    a depth group.  Every rank of the group must make the same call.
    """
    dev = resolve_device(device)
    cams_all, cams_nbr, nbr_idx, nbr_valid, refr, dist = \
        mvs_prepare_batched(cams, cfg, dtype, dev)
    enable_refraction = enable_refraction and refr
    enable_distortion = enable_distortion and dist

    rgbs = torch.as_tensor(rgbs, dtype=dtype, device=dev)
    masks = torch.as_tensor(masks, dtype=torch.bool, device=dev)
    grays = (0.11 * rgbs[..., 0] + 0.59 * rgbs[..., 1]
             + 0.3 * rgbs[..., 2])
    if view_ids is None:
        view_ids = [str(i) for i in range(len(cams))]

    if checkpoint is None and depth_group is None and len(cams) > 0:
        nbr = torch.as_tensor(nbr_idx, device=dev)
        args = (rgbs, grays, masks, grays[nbr], masks[nbr], cams_all,
                cams_nbr, nbr_valid, cfg, nbr_idx.shape[1])
        kw = dict(enable_refraction=enable_refraction,
                  enable_distortion=enable_distortion, method=method,
                  device=dev)
        if cfg.use_mrf:
            with trace("mvs/mrf_batched"):
                return mvs_batched_mrf_with_cross_check(
                    *args, cross_check=cross_check, **kw)
        if cross_check:
            with trace("mvs/estimates_and_cross_check"):
                return mvs_batched_with_cross_check(*args, **kw)
        with trace("mvs/initial_estimates_batched"):
            return mvs_initial_estimates_batched(*args, **kw)

    depths = []
    for i in range(len(cams)):
        if checkpoint is not None:
            saved = checkpoint.load(view_ids[i],
                                    expect_shape=tuple(grays.shape[1:]))
            if saved is not None:
                depths.append(torch.as_tensor(saved, dtype=dtype,
                                              device=dev))
                continue
        with trace(f"mvs/view{i}/initial_estimate"):
            nbr = torch.as_tensor(nbr_idx[i], device=dev)
            view_args = (rgbs[i], grays[i], masks[i], grays[nbr], masks[nbr],
                         camera_at(cams_all, i), camera_at(cams_nbr, i), cfg)
            kw = dict(enable_refraction=enable_refraction,
                      enable_distortion=enable_distortion,
                      nbr_valid=nbr_valid[i], device=dev)
            if depth_group is not None and not cfg.use_mrf:
                from ..parallel.depthshard import (
                    mvs_initial_estimate_depthsharded)
                est = mvs_initial_estimate_depthsharded(
                    depth_group, *view_args, method="kernel", **kw)
            else:
                est = mvs_initial_estimate_oneview(
                    *view_args, method=method, with_topk=cfg.use_mrf, **kw)
            if cfg.use_mrf:
                est = _mrf_depth(*est, masks[i], cfg)
            if checkpoint is not None:
                checkpoint.save(view_ids[i], est.cpu().numpy())
        depths.append(est)
    depths = torch.stack(depths)
    if cross_check:
        with trace("mvs/cross_check"):
            depths = mvs_cross_check_all(
                depths, cams_all, cfg, enable_refraction=enable_refraction,
                enable_distortion=enable_distortion)
    return depths


def depth_maps_to_ply(depths, rgbs, cams: Sequence[Camera],
                      cfg: MultiViewConfig, *, enable_refraction=True,
                      enable_distortion=True, device=None):
    """Back-project valid depth pixels into a coloured world point cloud, in
    float64 (library-level equivalent of ``outputPLYFile`` consumers).
    Returns numpy (points [P, 3], colours [P, 3])."""
    dev = resolve_device(device)
    pts_all, rgb_all = [], []
    for i, cam in enumerate(cams):
        d = depths[i]
        d = d.cpu().numpy() if torch.is_tensor(d) else np.asarray(d)
        h, w = d.shape
        cam = cam.to(dev, torch.float64)
        ray_o, ray_d = pixel_rays(cam, h, w, cfg.image_scale,
                                  enable_refraction=enable_refraction,
                                  enable_distortion=enable_distortion,
                                  dtype=torch.float64)
        _, nrm = principal_ray(cam)
        pts, v = point_from_depth(
            ray_o, ray_d, cam.C, nrm,
            torch.tensor(d, dtype=torch.float64, device=dev))
        good = (np.isfinite(d) & (d + 1e-5 >= cfg.min_depth)
                & v.cpu().numpy())
        pts_all.append(pts.cpu().numpy()[good])
        rgb = rgbs[i]
        rgb_all.append((rgb.cpu().numpy() if torch.is_tensor(rgb)
                        else np.asarray(rgb))[good])
    return np.concatenate(pts_all), np.concatenate(rgb_all)
