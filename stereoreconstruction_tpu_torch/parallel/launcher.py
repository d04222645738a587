"""Process-group launch and the (view, row) rank grid.

Port of ``stereoreconstruction_tpu/parallel/launcher.py`` onto
``torch.distributed``.  The reference is a single Qt process whose only
parallelism is OpenMP/TBB row loops (SURVEY §5); the JAX package joins one
process per host into a JAX cluster and shards over a device mesh.  Here
every rank is a process of its own with one explicit device, joined into a
``torch.distributed`` process group:

* :func:`initialize_distributed` — join the process group that torchrun's
  environment describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); a no-op that
  returns False for a single process, so every code path works unchanged
  in one process;
* :func:`global_mesh` / :func:`make_grid` — a (view x row) grid of ranks
  with its sub-groups, the axes the stereo engines shard over
  (parallel/sharding.py, parallel/rowshard.py);
* :func:`run_local` — spawn a world of ranks on this machine (the tests and
  chip_smoke.py drive the sharded engines through it).

Backend rule: NCCL iff every local rank has a card of its own
(``LOCAL_WORLD_SIZE <= torch.cuda.device_count()``), each rank on
``cuda:LOCAL_RANK``; otherwise gloo, with every rank on ``cuda:0`` (NCCL
refuses two ranks on one card).  A device of ``cpu`` uses gloo.  The rule
reads the counts; it never tries one backend and falls back to another.

Typical launch (``cli stereo`` calls :func:`initialize_distributed` on
entry and shards whenever the world has more than one rank):

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m stereoreconstruction_tpu_torch.cli stereo ... --shard row
"""

from __future__ import annotations

import dataclasses
import os
import queue as queue_mod
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def choose_backend(device, local_world_size: int) -> str:
    """``"nccl"`` iff ``device`` (CUDA when None) is CUDA and each of the
    ``local_world_size`` ranks on this machine has a card of its own, else
    ``"gloo"`` (module docstring)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return "gloo"
    return "nccl" if local_world_size <= torch.cuda.device_count() \
        else "gloo"


def initialize_distributed(device=None) -> bool:
    """Join the process group of torchrun's environment; returns True when
    a process group is (or already was) initialized.

    A single process (``WORLD_SIZE`` unset or 1) returns False without
    touching ``torch.distributed`` — callers never need to branch.  The
    backend follows :func:`choose_backend` for ``device`` (CUDA unless
    named); rank 0 prints the choice on stderr."""
    if dist.is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    rank = int(os.environ["RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    backend = choose_backend(device, local_world)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    if rank == 0:
        print(f"torch.distributed: {world} ranks, {backend} backend "
              f"({local_world} local ranks, "
              f"{torch.cuda.device_count()} CUDA devices)", file=sys.stderr)
    return True


def shutdown() -> None:
    """Leave the process group this process joined, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_device(device=None) -> torch.device:
    """This rank's device for ``device`` (CUDA unless named): under NCCL
    ``cuda:LOCAL_RANK``, under gloo or without a process group ``cuda:0``;
    any other device as named."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if dist.is_initialized() and dist.get_backend() == dist.Backend.NCCL:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device("cuda", 0)


def process_index() -> int:
    """This process's global rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    return process_index() == 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True)
class RankGrid:
    """A (view x row) grid of global ranks, the port's device mesh.

    ``ranks`` [n_view, n_row]; this process sits at (``view_index``,
    ``row_index``), both -1 when it is not in the grid.  ``row_group`` holds
    the ranks of this rank's view slot (the "row" axis: the gathers of a
    pair's row blocks), ``view_group`` the ranks of its row slot (the
    "view" axis: the gathers of pairs).  Both are None without a process
    group, where every collective is the identity."""

    ranks: np.ndarray
    view_index: int
    row_index: int
    row_group: Any = None
    view_group: Any = None
    axis_names = ("view", "row")

    @property
    def member(self) -> bool:
        return self.view_index >= 0


def make_grid(n_view: int, n_row: int) -> RankGrid:
    """The grid of global ranks [0, n_view * n_row), row-major.  With a
    process group every rank of the world must call it (sub-groups are
    created collectively); ranks beyond the grid get a non-member grid."""
    n = world_size()
    if n_view * n_row > n:
        raise ValueError(f"a {n_view}x{n_row} grid needs {n_view * n_row} "
                         f"ranks, the world has {n}")
    ranks = np.arange(n_view * n_row).reshape(n_view, n_row)
    me = process_index()
    hit = np.argwhere(ranks == me)
    v, r = (int(hit[0, 0]), int(hit[0, 1])) if len(hit) else (-1, -1)
    if not dist.is_initialized():
        return RankGrid(ranks, v, r)
    # new_group is collective over the world: every rank creates every
    # sub-group, in the same order, and keeps its own
    row_group = view_group = None
    for i in range(n_view):
        g = dist.new_group([int(x) for x in ranks[i]])
        if i == v:
            row_group = g
    for j in range(n_row):
        g = dist.new_group([int(x) for x in ranks[:, j]])
        if j == r:
            view_group = g
    return RankGrid(ranks, v, r, row_group, view_group)


def rank_group(n: int):
    """The process group of global ranks [0, n); None without a process
    group (a single process, n = 1).  Every rank of the world must call it;
    the ranks beyond it are not members (``collectives.group_rank`` gives
    -1)."""
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"{n} ranks need a process group")
        return None
    return dist.new_group(list(range(n)))


def global_mesh(n_views: Optional[int] = None) -> RankGrid:
    """(views x rows) grid over every rank of the world.

    ``n_views`` bounds the view axis by the number of concurrent view pairs
    (the largest divisor of the world size not above it; the rest fold
    into the row axis).  With one rank the grid is 1x1 and the collectives
    are the identity."""
    n = world_size()
    if n_views is None:
        n_views = n
    dv = max(c for c in range(1, min(n_views, n) + 1) if n % c == 0)
    return make_grid(dv, n // dv)


def _rank_entry(rank: int, world: int, backend: str, init_file: str,
                threads: Optional[int], fn: Callable, args: Sequence,
                results) -> None:
    """A spawned rank: join the file-initialized process group, run
    ``fn(*args)`` and put (rank, ok, result or traceback) on ``results``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    if threads:
        torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        out = (rank, True, fn(*args))
    except Exception:
        # the traceback goes to the parent, which raises it
        out = (rank, False, traceback.format_exc())
    results.put(out)
    dist.destroy_process_group()


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join()


def run_local(fn: Callable, args: Sequence = (), *, world_size: int,
              backend: str, init_file: Optional[str] = None,
              timeout: float = 600.0, threads: Optional[int] = None
              ) -> list:
    """Run ``fn(*args)`` on ``world_size`` spawned ranks of one process
    group on this machine; returns each rank's result, by rank.

    ``fn`` is a module-level function of this package (the children import
    it by name, and nothing else of the caller).  The group rendezvous
    through ``init_file`` (``file://``; a fresh temporary file by default),
    so concurrent groups never contend for a TCP port.  Under ``"nccl"``
    rank r runs on ``cuda:r``.  ``threads`` sets each rank's
    ``torch.set_num_threads``.

    If a rank fails, the others are killed and RuntimeError carries its
    traceback; if the ranks have not all finished ``timeout`` seconds after
    the spawn, every rank still running is killed (by its own PID) and
    TimeoutError raised."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = None
    if init_file is None:
        tmp = tempfile.TemporaryDirectory()
        init_file = os.path.join(tmp.name, "init")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, world_size, backend, init_file, threads,
                               fn, tuple(args), results), daemon=True)
             for r in range(world_size)]
    deadline = time.monotonic() + timeout
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            try:
                rank, ok, res = results.get(timeout=0.2)
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    pids = [p.pid for p in procs if p.is_alive()]
                    raise TimeoutError(
                        f"{world_size} {backend} ranks not done after "
                        f"{timeout:.0f} s; killing PIDs {pids}")
                dead = [(i, p.exitcode) for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in out]
                if dead:
                    raise RuntimeError(f"ranks exited without a result "
                                       f"(rank, exit code): {dead}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} "
                                   f"failed:\n{res}")
            out[rank] = res
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        _stop(procs)
        if tmp is not None:
            tmp.cleanup()
    return [out[r] for r in range(world_size)]
