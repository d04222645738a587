"""Pair-parallel two-view engine over the grid's view axis.

Port of ``stereoreconstruction_tpu/parallel/sharding.py`` onto
``torch.distributed``.  The reference parallelizes with OpenMP/TBB row
loops inside one process (twoviewstereo.cpp:265, multiviewstereo.cpp:
543-555); the JAX package shards a batch of view pairs over a (view, row)
device mesh and lets its compiler partition the rows.  Here pairs are split
over the grid's "view" axis, each rank runs its pairs through
``compute_depth_maps``, and one all-gather of [P, 2, H, W] over the view
group assembles the batch.  Row splitting is explicit and lives in
parallel/rowshard.py (its docstring says why): ranks of one view slot run
the same pairs here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import TwoViewConfig
from ..device import resolve_device
from ..geometry.camera import Camera, camera_at, stack_cameras  # noqa: F401
from ..stereo.twoview import compute_depth_maps
from .collectives import all_gather
from .launcher import RankGrid


def twoview_batch_sharded(grid: RankGrid, rgbs_l, masks_l, rgbs_r, masks_r,
                          cams_l: Camera, cams_r: Camera,
                          cfg: TwoViewConfig, *,
                          enable_refraction: bool = True,
                          enable_distortion: bool = True,
                          method: str = "auto", dtype=torch.float32,
                          device=None):
    """Cross-checked depth maps for a batch of view pairs, the pairs split
    over the grid's view axis.

    rgbs_*: [P, H, W, 3]; masks_*: [P, H, W]; cams_*: Cameras stacked over
    P (``stack_cameras``).  P must be divisible by the view axis.  Every
    rank of the grid makes the same call; each gets [P, 2, H, W] (left,
    right) on ``device`` (this rank's; CUDA unless named), each pair
    bit-equal to its ``compute_depth_maps``."""
    n_view = grid.ranks.shape[0]
    rgbs_l = np.asarray(rgbs_l)
    n_pairs = rgbs_l.shape[0]
    if n_pairs % n_view:
        raise ValueError(
            f"n_pairs={n_pairs} not divisible by the 'view' axis ({n_view})")
    if not grid.member:
        raise ValueError("this rank is not in the grid")
    dev = resolve_device(device)
    per_view = n_pairs // n_view
    v = grid.view_index
    local = []
    for p in range(v * per_view, (v + 1) * per_view):
        res = compute_depth_maps(
            rgbs_l[p], masks_l[p], rgbs_r[p], masks_r[p],
            camera_at(cams_l, p), camera_at(cams_r, p), cfg,
            enable_refraction=enable_refraction,
            enable_distortion=enable_distortion, method=method, dtype=dtype,
            device=dev)
        local.append(torch.stack([res.depth_left, res.depth_right]))
    out = all_gather(torch.stack(local), grid.view_group)
    return out.reshape((n_pairs,) + tuple(out.shape[2:]))
