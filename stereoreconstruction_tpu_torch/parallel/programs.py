"""Rank programs: each sharded engine driven on one rank of a world, with
its kernel launches and seconds, for ``launcher.run_local``.

``run_tasks`` runs a list of ``(name, kwargs)`` tasks in order on every
rank of a spawned world and returns each task's result, so one world of
ranks serves several checks.  The tests hold the results against the
unsharded engines and the JAX package, and chip_smoke.py against the
unsharded engines on the card.  A task's inputs are numpy arrays, configs
and the port's Cameras (CPU tensors); its result holds numpy arrays only.

Each engine task runs its engine once to warm the rank's process up (the
CUDA context, the kernel libraries, the allocator), then sets every kernel
wrapper's launch count to 0 just before the measured run and reads the
counts just after; ``"mvs_sweep_label0"`` lists the ``label0`` of each
launch of the sweep kernel (kernel 2) in that run, and ``"blocks"`` the
(first global row, rows) of each row block the row-sharded engine swept.
"""

from __future__ import annotations

import contextlib
import io
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from . import launcher


def kernel_counters() -> dict:
    """Each kernel wrapper by its counter's name."""
    from ..ops.cuda_cost_wta import cuda_cost_volume, cuda_cost_wta
    from ..ops.cuda_mvs import cuda_mvs_topk, cuda_mvs_wta
    from ..ops.cuda_sample import cuda_sample_nearest
    from ..ops.cuda_warp import cuda_warp_bilinear
    from ..ops.cuda_weights import cuda_geodesic_weights
    return {"geodesic_weights": cuda_geodesic_weights,
            "mvs_sweep": cuda_mvs_wta, "mvs_sweep_topk": cuda_mvs_topk,
            "warp_bilinear": cuda_warp_bilinear, "cost_wta": cuda_cost_wta,
            "cost_volume": cuda_cost_volume,
            "sample_nearest": cuda_sample_nearest}


@contextlib.contextmanager
def _recording(module, name: str, record: list, what):
    """Wrap ``module.name`` so that each call appends ``what(args,
    kwargs)`` to ``record``; the recording launches nothing."""
    orig = getattr(module, name)

    def wrapped(*a, **kw):
        record.append(what(a, kw))
        return orig(*a, **kw)
    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, orig)


def _engine(dev, call):
    """Run ``call()`` once to warm up, then again with the launch counts set
    to 0 just before and read just after.  Returns the second run's
    (result, seconds, launches, record): ``record["label0"]`` the label0 of
    each call of the sweep kernel's wrappers from stereo/multiview.py,
    ``record["blocks"]`` the (row0, rows) of each row block the row-sharded
    engine swept."""
    from ..stereo import multiview
    from . import rowshard
    call()
    counters = kernel_counters()
    record = dict(label0=[], blocks=[])
    for fn in counters.values():
        fn.launches = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for name in ("cuda_mvs_wta", "cuda_mvs_topk"):
            stack.enter_context(_recording(
                multiview, name, record["label0"],
                lambda a, kw: int(kw.get("label0", 0))))
        stack.enter_context(_recording(
            rowshard, "compute_depth_map_oneview", record["blocks"],
            lambda a, kw: (kw["row0"], a[1].shape[0])))
        out = call()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    return out, seconds, launches, record


def _report(dev, seconds, launches, record, **arrays) -> dict:
    import torch.distributed as dist
    out = dict(rank=launcher.process_index(), device=str(dev),
               backend=(dist.get_backend() if dist.is_initialized()
                        else None),
               seconds=seconds, launches=launches,
               mvs_sweep_label0=record["label0"], blocks=record["blocks"],
               jax_loaded=any(m == "jax" or m.startswith("jax.")
                              for m in sys.modules))
    out.update({k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                for k, v in arrays.items()})
    return out


def twoview_rows(n_view, n_row, rgbs_l, masks_l, rgbs_r, masks_r, cams_l,
                 cams_r, cfg, *, cross_check=True, dtype=torch.float32,
                 device=None):
    """``rowshard.twoview_pairs_rowsharded`` on a (n_view, n_row) grid;
    None on a rank outside it."""
    from .rowshard import twoview_pairs_rowsharded
    dev = resolve_device(launcher.rank_device(device))
    grid = launcher.make_grid(n_view, n_row)
    if not grid.member:
        return None
    (dl, dr), seconds, launches, record = _engine(
        dev, lambda: twoview_pairs_rowsharded(
            grid, rgbs_l, masks_l, rgbs_r, masks_r, cams_l, cams_r, cfg,
            cross_check=cross_check, dtype=dtype, device=dev))
    return _report(dev, seconds, launches, record, left=dl, right=dr,
                   grid=grid.ranks)


def twoview_pairs(n_view, n_row, rgbs_l, masks_l, rgbs_r, masks_r, cams_l,
                  cams_r, cfg, *, dtype=torch.float32, device=None):
    """``sharding.twoview_batch_sharded`` on a (n_view, n_row) grid; None on
    a rank outside it."""
    from .sharding import twoview_batch_sharded
    dev = resolve_device(launcher.rank_device(device))
    grid = launcher.make_grid(n_view, n_row)
    if not grid.member:
        return None
    depths, seconds, launches, record = _engine(
        dev, lambda: twoview_batch_sharded(
            grid, rgbs_l, masks_l, rgbs_r, masks_r, cams_l, cams_r, cfg,
            dtype=dtype, device=dev))
    return _report(dev, seconds, launches, record, depths=depths,
                   grid=grid.ranks)


def mvs_slabs(n_depth, rgbs, masks, cams, cfg, *, topk_view=None,
              dtype=torch.float32, device=None):
    """``mvs_depth_maps(depth_group=...)`` over ranks [0, n_depth) (its
    depths [V, H, W]) and, with ``topk_view``, that view's depth-sharded
    top-K lists; None on a rank outside the group."""
    from ..geometry.camera import camera_at
    from ..stereo.multiview import mvs_depth_maps, mvs_prepare_batched
    from .collectives import group_rank
    from .depthshard import (make_depth_group,
                             mvs_initial_estimate_depthsharded)
    dev = resolve_device(launcher.rank_device(device))
    group = make_depth_group(n_depth)
    if group_rank(group) < 0:
        return None
    depths, seconds, launches, record = _engine(
        dev, lambda: mvs_depth_maps(rgbs, masks, cams, cfg, dtype=dtype,
                                    device=dev, depth_group=group))
    out = _report(dev, seconds, launches, record, depths=depths)
    if topk_view is None:
        return out
    i = topk_view
    cams_all, cams_nbr, nbr_idx, nbr_valid, refr, dist_ = \
        mvs_prepare_batched(cams, cfg, dtype, dev)
    rgb = torch.as_tensor(np.asarray(rgbs), dtype=dtype, device=dev)
    gray = 0.11 * rgb[..., 0] + 0.59 * rgb[..., 1] + 0.3 * rgb[..., 2]
    mask = torch.as_tensor(np.asarray(masks), dtype=torch.bool, device=dev)
    nbr = torch.as_tensor(nbr_idx[i], device=dev)
    (ncc, dep), seconds, launches, record = _engine(
        dev, lambda: mvs_initial_estimate_depthsharded(
            group, rgb[i], gray[i], mask[i], gray[nbr], mask[nbr],
            camera_at(cams_all, i), camera_at(cams_nbr, i), cfg,
            enable_refraction=refr, enable_distortion=dist_,
            with_topk=True, nbr_valid=nbr_valid[i], device=dev))
    out["topk"] = _report(dev, seconds, launches, record, ncc=ncc,
                          depth=dep)
    return out


def schur(poses, points, Ks, cam_idx, pt_idx, meas, n_cams, n_pts, *,
          n_ranks=None, device=None):
    """``schur_blocks_allreduce`` over ranks [0, n_ranks) (default: the
    world) of each rank's share of the observations (``np.array_split`` of
    their indices, in rank order); None on a rank outside them."""
    from .collectives import (ba_normal_equations_allreduce, group_rank,
                              group_size)
    dev = resolve_device(launcher.rank_device(device))
    group = launcher.rank_group(n_ranks or launcher.world_size())
    if group_rank(group) < 0:
        return None
    part = np.array_split(np.arange(len(cam_idx)),
                          group_size(group))[group_rank(group)]

    def t(x, dtype=torch.float64, rows=slice(None)):
        return torch.as_tensor(np.asarray(x)[rows], dtype=dtype, device=dev)
    blocks, seconds, launches, record = _engine(
        dev, lambda: ba_normal_equations_allreduce(
            t(poses), t(points), t(Ks), t(cam_idx, torch.int64, part),
            t(pt_idx, torch.int64, part), t(meas, rows=part), n_cams,
            n_pts, group))
    return _report(dev, seconds, launches, record,
                   blocks=[b.cpu().numpy() for b in blocks],
                   n_obs=len(part))


def topk_merge(local_ncc, local_depth, k, *, device="cpu"):
    """``collectives.merge_topk`` of rank r's lists ``local_*[r]`` over the
    world."""
    from .collectives import group_rank, merge_topk
    dev = resolve_device(launcher.rank_device(device))
    r = group_rank()
    ncc, dep = merge_topk(torch.as_tensor(local_ncc[r], device=dev),
                          torch.as_tensor(local_depth[r], device=dev), k)
    return dict(ncc=ncc.cpu().numpy(), depth=dep.cpu().numpy())


def grid_axes(n_views_list):
    """``launcher.global_mesh(n)`` for each n: (axis names, rank grid)."""
    return [(g.axis_names, g.ranks)
            for g in map(launcher.global_mesh, n_views_list)]


def cli(argv):
    """``cli.main(argv)`` on this rank: (exit code, stdout, stderr)."""
    from ..cli import main
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(argv))
    return rc, out.getvalue(), err.getvalue()


TASKS = dict(twoview_rows=twoview_rows, twoview_pairs=twoview_pairs,
             mvs_slabs=mvs_slabs, schur=schur, topk_merge=topk_merge,
             grid_axes=grid_axes, cli=cli)


def run_tasks(tasks):
    """Run ``[(name, kwargs), ...]`` of ``TASKS`` in order on this rank;
    returns their results."""
    return [TASKS[name](**kw) for name, kw in tasks]
