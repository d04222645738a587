"""Depth-slab sharded MVS initial estimate (the ring-attention analog).

Port of ``stereoreconstruction_tpu/parallel/depthshard.py`` onto
``torch.distributed``.  The depth-label axis is split over the ranks of a
depth group: rank i sweeps only labels [i * slab, (i + 1) * slab) of the
loop the reference runs per pixel (multiviewstereo.cpp:574-602) through
the sweep kernel (kernel 2, its ``label0``/``n_labels`` slab interface),
producing a *local* WTA carry or top-K peak list; one merge collective
combines the slabs.  Inputs are whole on every rank (images are small next
to the [D, H, W] sweep), so the sweep runs with no communication and the
only collective is the merge at the end.

Correctness: slab boundaries are exact — the reference's tie rule (equal
NCC -> larger depth wins, peaks.back() after a stable sort on (cost,
depth)) is associative across ascending-depth slabs, so the merged result
equals the unsharded sweep bit for bit.
"""

from __future__ import annotations

import torch

from ..config import MultiViewConfig
from ..device import resolve_device
from ..geometry.camera import Camera
from ..stereo.multiview import (_mvs_kernel_sweep, mvs_finalize_wta,
                                resolve_mvs_method)
from .collectives import all_gather, group_rank, group_size, merge_topk
from .launcher import rank_group


def make_depth_group(n_depth: int):
    """The depth axis: the process group of ranks [0, n_depth)
    (``launcher.rank_group``; every rank of the world calls it)."""
    return rank_group(n_depth)


def mvs_initial_estimate_depthsharded(
        group, rgb_ref, gray_ref, mask_ref, grays_nbr, masks_nbr,
        cam_ref: Camera, cams_nbr: Camera, cfg: MultiViewConfig, *,
        enable_refraction=True, enable_distortion=True, with_topk=False,
        method="kernel", nbr_valid=None, device=None):
    """Depth-sharded equivalent of ``mvs_initial_estimate_oneview`` over the
    ranks of ``group`` (a process group from :func:`make_depth_group`; this
    process one of its ranks).  ``cfg.num_depth_levels`` must be divisible
    by the group's size.  Every rank makes the same call and gets the same
    values as the unsharded function: the WTA depth map [H, W], or with
    ``with_topk`` the (ncc, depth) lists [K, H, W] x 2.

    method: the kernel method (``"auto"``, ``"fast"`` and ``"pallas"`` map
    to it); as in the JAX package there is no exact slab backend, and
    ``"exact"`` raises ValueError."""
    if resolve_mvs_method(method) != "kernel":
        raise ValueError("the depth-sharded sweep has no exact slab backend")
    n_dep = group_size(group)
    rank = group_rank(group)
    if rank < 0:
        raise ValueError("this rank is not in the depth group")
    n_labels = cfg.num_depth_levels
    if n_labels % n_dep:
        raise ValueError(f"num_depth_levels {n_labels} not divisible by "
                         f"the depth group's {n_dep} ranks")
    slab = n_labels // n_dep

    dev = resolve_device(device)
    gray_ref = torch.as_tensor(gray_ref, device=dev)
    dtype = gray_ref.dtype
    rgb_ref = torch.as_tensor(rgb_ref, dtype=dtype, device=dev)
    mask_ref = torch.as_tensor(mask_ref, dtype=torch.bool, device=dev)
    grays_nbr = torch.as_tensor(grays_nbr, dtype=dtype, device=dev)
    if nbr_valid is None:
        nbr_valid = torch.ones((grays_nbr.shape[0],), dtype=torch.bool)
    nbr_valid = torch.as_tensor(nbr_valid, dtype=torch.bool, device=dev)

    ncc, depth = _mvs_kernel_sweep(
        rgb_ref, gray_ref, mask_ref, grays_nbr, cam_ref.to(dev, dtype),
        cams_nbr.to(dev, dtype), cfg, enable_refraction=enable_refraction,
        enable_distortion=enable_distortion, nbr_valid=nbr_valid,
        with_topk=with_topk, label0=rank * slab, n_labels=slab)

    if with_topk:
        # all-gather the slabs (ascending depth order) and re-select
        # stably: among equal NCCs the larger depth survives, as in the
        # unsharded sequential insertion
        top_ncc, top_depth = merge_topk(ncc, depth, cfg.top_k, group)
        # the reference's (0, -1) no-peak default (mvs cpp:600-607)
        return torch.where(torch.isfinite(top_ncc), top_ncc, 0.0), top_depth

    # cross-slab merge with the sequential tie rule: slabs are in
    # ascending-depth rank order, so a later slab wins ties (>=)
    all_ncc = all_gather(ncc, group)                        # [S, H, W]
    all_dep = all_gather(depth, group)
    best_ncc, best_depth = all_ncc[0], all_dep[0]
    for j in range(1, n_dep):
        better = all_ncc[j] >= best_ncc
        best_depth = torch.where(better, all_dep[j], best_depth)
        best_ncc = torch.where(better, all_ncc[j], best_ncc)
    return mvs_finalize_wta(best_ncc, best_depth, mask_ref)
