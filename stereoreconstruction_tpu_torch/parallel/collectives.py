"""Collectives of the sharded stereo and calibration engines.

Port of ``stereoreconstruction_tpu/parallel/collectives.py`` onto
``torch.distributed``:

* ``merge_topk``: the depth-axis sharding primitive — each rank computes
  its local top-K (ncc, depth) peaks over its depth slab; an all-gather and
  a local re-select merge them (the blockwise-softmax-merge analog for peak
  lists, SURVEY §5);
* ``ba_normal_equations_allreduce``: observation-sharded Schur blocks
  reduced with an all-reduce (calib/bundle.py ``schur_blocks_allreduce``).

``group`` is a ``torch.distributed`` process group, or None for the default
(world) group.  Without an initialized process group every collective is
the identity of a world of one process, so the sharded engines run
unchanged in a single process.

Backends: under NCCL the tensors stay on the device.  Under gloo the
transfers are staged through the host explicitly: gloo's all_gather is not
documented for CUDA tensors, so each operand is copied to the CPU, the
collective runs there, and the result is copied back to the operand's
device.  Bool tensors are not gathered (gloo has no bool type); the engines
gather float maps only.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group=None) -> int:
    """Ranks in ``group``: 1 without a process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def group_rank(group=None) -> int:
    """This process's rank in ``group`` (-1 if it is not a member): 0
    without a process group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def _on_host(group) -> bool:
    """Whether the group's collectives take host tensors (gloo)."""
    return dist.get_backend(group) == dist.Backend.GLOO


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` [...] of every rank of ``group``, stacked in group rank order:
    [S, ...] on ``t``'s device.  Every rank passes the same shape and
    dtype."""
    if not dist.is_initialized():
        return t[None]
    src = t.detach().contiguous()
    if _on_host(group):
        src = src.cpu()
    out = torch.empty((group_size(group),) + tuple(src.shape),
                      dtype=src.dtype, device=src.device)
    dist.all_gather(list(out.unbind(0)), src, group=group)
    return out.to(t.device)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, on ``t``'s device (a
    new tensor; ``t`` is not changed)."""
    if not dist.is_initialized():
        return t.clone()
    out = t.detach().clone().contiguous()
    if _on_host(group):
        out = out.cpu()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(t.device)


def local_topk(ncc, depth, k: int):
    """Top-k by ncc (ties -> larger depth) along the leading axis.

    ncc/depth: [D, ...], the candidates in ascending depth order.  Returns
    ([k, ...], [k, ...]) ascending by ncc: a stable sort, as jnp.argsort,
    so that among equal NCCs the later (larger) depth sorts last and
    survives."""
    order = torch.sort(ncc, dim=0, stable=True).indices
    return ncc.gather(0, order)[-k:], depth.gather(0, order)[-k:]


def merge_topk(local_ncc, local_depth, k: int, group=None):
    """Merge per-rank top-k lists across ``group``.

    local_ncc/local_depth: [k, ...] on each rank, its depth slab's raw
    lists; the ranks hold ascending slabs in group rank order.  Returns the
    global top-k (the same on every rank)."""
    all_ncc = all_gather(local_ncc, group)                  # [S, k, ...]
    all_dep = all_gather(local_depth, group)
    flat_n = all_ncc.reshape((-1,) + tuple(all_ncc.shape[2:]))
    flat_d = all_dep.reshape((-1,) + tuple(all_dep.shape[2:]))
    return local_topk(flat_n, flat_d, k)


def ba_normal_equations_allreduce(poses, points, Ks, cam_idx, pt_idx, meas,
                                  n_cams: int, n_pts: int, group=None):
    """Schur blocks of this rank's observation shard, all-reduced."""
    from ..calib.bundle import schur_blocks_allreduce
    return schur_blocks_allreduce(poses, points, Ks, cam_idx, pt_idx, meas,
                                  n_cams, n_pts, group)
