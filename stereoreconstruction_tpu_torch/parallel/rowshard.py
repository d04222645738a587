"""Row-sharded two-view engine: halo-overlapped row blocks, one per rank.

Port of ``stereoreconstruction_tpu/parallel/rowshard.py`` onto
``torch.distributed``.  The reference parallelizes the per-pixel loops with
OpenMP/TBB over image rows (twoviewstereo.cpp:265, 436); here each rank of
a (view, row) grid owns a block of rows:

* the reference view is split into **halo-overlapped row blocks** (halo =
  window_radius + 1 covers the support window and the geodesic weights'
  neighbour taps), cut on the host, so the depth sweep — kernels 1, 3 and 4
  on the block's ``tile + 2 * halo`` rows — runs with **no collective**;
* the other view is whole on every rank (the epipolar band a block reads
  depends on the data, and one [H, W] image is small next to the
  [D, h, W] sweep);
* every block computes its rays, weights and validity in global rows (the
  ``row0``/``full_h`` blocks of stereo/twoview.py), so a block's rows equal
  the unsharded map's bit for bit;
* the only communication is the cross-check's two [H, W] all-gathers over
  the row group, in the reference's sequential order (the right pass sees
  the already-invalidated left map, twoviewstereo.cpp:596-672): gather the
  right map, check the left block, gather the left map, check the right
  block; kernel 5 reads the gathered maps.  A last gather assembles the
  right map for the result.

Grid axes: ("view", "row") — "view" is data-parallel over pairs, "row"
partitions each image's rows (launcher.make_grid).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import TwoViewConfig
from ..device import resolve_device
from ..geometry.camera import Camera, camera_at
from ..stereo.twoview import (compute_depth_map_oneview,
                              cross_check_direction, host_stages)
from .collectives import all_gather
from .launcher import RankGrid


def overlap_blocks(x: np.ndarray, n_blocks: int, halo: int,
                   fill=0.0) -> np.ndarray:
    """Split rows of ``x [H, W(, C)]`` into ``n_blocks`` halo-overlapped
    blocks along a new axis.

    Returns [n_blocks, tile + 2*halo, W(, C)] with tile = ceil(H /
    n_blocks); H is padded up to a multiple of n_blocks with ``fill``
    first."""
    x = np.asarray(x)
    h = x.shape[0]
    tile = -(-h // n_blocks)
    pad_rows = n_blocks * tile - h
    pad = [(halo, pad_rows + halo)] + [(0, 0)] * (x.ndim - 1)
    xp = np.pad(x, pad, constant_values=fill)
    blocks = [xp[i * tile: i * tile + tile + 2 * halo] for i in
              range(n_blocks)]
    return np.stack(blocks)


def _unblock(blocks, h: int):
    """Inverse of overlap_blocks for outputs whose halo rows were already
    trimmed: blocks [n_blocks, tile, W] -> [h, W] (an array or a
    tensor)."""
    n_blocks, tile = blocks.shape[:2]
    return blocks.reshape((n_blocks * tile,) + tuple(blocks.shape[2:]))[:h]


def _gather_rows(blk: torch.Tensor, h: int, group) -> torch.Tensor:
    """[tile, W] row blocks of the group's ranks -> the [h, W] map."""
    return _unblock(all_gather(blk, group), h)


def twoview_pairs_rowsharded(
        grid: RankGrid, rgbs_l, masks_l, rgbs_r, masks_r,
        cams_l: Camera, cams_r: Camera, cfg: TwoViewConfig, *,
        cross_check: bool = True, enable_refraction: bool = True,
        enable_distortion: bool = True, method: str = "kernel",
        dtype=torch.float32, device=None):
    """Cross-checked depth maps for a batch of view pairs, sharded over a
    (view, row) grid of ranks.

    rgbs_*: [P, H, W, 3] (0..255, already scaled); masks_*: [P, H, W] bool;
    cams_*: Cameras stacked over P.  Every rank of the grid makes the same
    call with the same inputs.  P must be divisible by the grid's view
    axis.  Returns (left, right) depth maps [P, H, W] on ``device`` (this
    rank's; CUDA unless named), the same on every rank of the grid and
    bit-equal to ``compute_depth_maps`` of each pair.

    method: the kernel method (``"auto"``, ``"fast"`` and ``"pallas"`` map
    to it); blocks have no exact or SAD path (stereo/twoview.py)."""
    n_view, n_row = grid.ranks.shape
    halo = cfg.window_radius + 1
    dev = resolve_device(device)

    rgbs_l = np.asarray(rgbs_l, np.float32)
    rgbs_r = np.asarray(rgbs_r, np.float32)
    masks_l = np.asarray(masks_l, bool)
    masks_r = np.asarray(masks_r, bool)
    n_pairs, h, w = rgbs_l.shape[:3]
    if n_pairs % n_view:
        raise ValueError(
            f"n_pairs={n_pairs} not divisible by the 'view' axis ({n_view})")
    if not grid.member:
        raise ValueError("this rank is not in the grid")
    tile = -(-h // n_row)
    per_view = n_pairs // n_view
    v, r = grid.view_index, grid.row_index
    row0 = r * tile

    def block(x, fill):
        """This rank's halo-overlapped block of ``x``."""
        return overlap_blocks(x, n_row, halo, fill=fill)[r]

    def gray(rgb):
        return 0.11 * rgb[..., 0] + 0.59 * rgb[..., 1] + 0.3 * rgb[..., 2]

    def t(x, dt=dtype):
        return torch.as_tensor(x, dtype=dt, device=dev)

    def block_depth(rgb, mask, rgb_oth, mask_oth, cam_ref, cam_oth, kw):
        """WTA depth of this rank's block, its halo rows trimmed."""
        rgb_b = t(block(rgb, 0.0))
        d = compute_depth_map_oneview(
            rgb_b, gray(rgb_b), t(block(mask, False), torch.bool),
            gray(t(rgb_oth)), t(mask_oth, torch.bool), cam_ref, cam_oth,
            cfg, method=method, device=dev, row0=row0 - halo, full_h=h,
            **kw)
        return d[halo:halo + tile]

    outs_l, outs_r = [], []
    for p in range(v * per_view, (v + 1) * per_view):
        cam_l = camera_at(cams_l, p).to(dev, dtype)
        cam_r = camera_at(cams_r, p).to(dev, dtype)
        kw = host_stages(cam_l, cam_r, enable_refraction, enable_distortion)
        dl = block_depth(rgbs_l[p], masks_l[p], rgbs_r[p], masks_r[p],
                         cam_l, cam_r, kw)
        dr = block_depth(rgbs_r[p], masks_r[p], rgbs_l[p], masks_l[p],
                         cam_r, cam_l, kw)
        if cross_check:
            # sequential symmetric order: the right pass sees the
            # invalidated left map
            check = dict(kw, row0=row0)
            dr_full = _gather_rows(dr, h, grid.row_group)
            dl = cross_check_direction(dl, dr_full, cam_l, cam_r,
                                       cfg.image_scale,
                                       cfg.inconsistency_thresh, **check)
            dl_full = _gather_rows(dl, h, grid.row_group)
            dr = cross_check_direction(dr, dl_full, cam_r, cam_l,
                                       cfg.image_scale,
                                       cfg.inconsistency_thresh, **check)
        else:
            dl_full = _gather_rows(dl, h, grid.row_group)
        outs_l.append(dl_full)
        outs_r.append(_gather_rows(dr, h, grid.row_group))
    # the view slots' pairs, in pair order
    dl = all_gather(torch.stack(outs_l), grid.view_group)
    dr = all_gather(torch.stack(outs_r), grid.view_group)
    return dl.reshape(n_pairs, h, w), dr.reshape(n_pairs, h, w)
