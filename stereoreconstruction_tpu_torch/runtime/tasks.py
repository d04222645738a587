"""Task runtime: async jobs with progress reporting + cooperative
cancellation, backed by the native C++ thread pool.

Port of ``stereoreconstruction_tpu/runtime/tasks.py`` on the port's own
build of the pool (``runtime/native/build.py``).  Python-level mirror of
the reference's Task abstraction (gui/task.hpp:57-103: ``title``/
``numSteps``/``runTask``, ``cancel()``, ``started``/``finished``/
``progressUpdate``/``stageUpdate`` signals); the Qt event-loop +
one-QThread-per-task runtime (mainwindow.cpp:1174-1198) becomes a fixed
native pool.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from .native.build import load_library

_TASK_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_int64)


class Task:
    """Subclass and implement ``run_task(ctx)``; poll ``ctx.is_cancelled()``
    in loops and call ``ctx.progress(step)`` / ``ctx.stage(text)``."""

    title: str = "Task"
    num_steps: int = 1

    def run_task(self, ctx: "TaskContext") -> Any:
        raise NotImplementedError


class FnTask(Task):
    def __init__(self, fn: Callable[["TaskContext"], Any],
                 title: str = "Task", num_steps: int = 1):
        self.fn = fn
        self.title = title
        self.num_steps = num_steps

    def run_task(self, ctx):
        return self.fn(ctx)


@dataclass
class TaskContext:
    runner: "TaskRunner"
    task_id: int
    on_progress: Optional[Callable[[int], None]] = None
    on_stage: Optional[Callable[[str], None]] = None

    def is_cancelled(self) -> bool:
        return bool(self.runner._lib.task_is_cancelled(
            self.runner._pool, self.task_id))

    def progress(self, step: int) -> None:
        self.runner._lib.task_set_progress(self.runner._pool,
                                           self.task_id, step)
        if self.on_progress:
            self.on_progress(step)

    def stage(self, text: str) -> None:
        if self.on_stage:
            self.on_stage(text)


@dataclass
class TaskHandle:
    runner: "TaskRunner"
    task_id: int
    task: Task
    result: Any = None
    error: Optional[BaseException] = None

    def cancel(self) -> None:
        self.runner._lib.task_cancel(self.runner._pool, self.task_id)

    def wait(self) -> Any:
        self.runner._lib.taskpool_wait_task(self.runner._pool, self.task_id)
        if self.error is not None:
            raise self.error
        return self.result

    @property
    def progress(self) -> int:
        return int(self.runner._lib.task_get_progress(
            self.runner._pool, self.task_id))

    @property
    def done(self) -> bool:
        return bool(self.runner._lib.task_is_done(self.runner._pool,
                                                  self.task_id))


class TaskRunner:
    def __init__(self, n_threads: int = 0):
        self._lib = load_library()
        self._lib.taskpool_create.restype = ctypes.c_void_p
        self._lib.taskpool_submit.restype = ctypes.c_int64
        self._lib.taskpool_submit.argtypes = [ctypes.c_void_p, _TASK_FN,
                                              ctypes.c_void_p]
        for name in ("taskpool_wait_all", "taskpool_destroy"):
            getattr(self._lib, name).argtypes = [ctypes.c_void_p]
        for name in ("task_cancel", "task_set_progress", "task_get_progress",
                     "task_is_cancelled", "task_is_done",
                     "taskpool_wait_task"):
            getattr(self._lib, name).argtypes = [ctypes.c_void_p,
                                                 ctypes.c_int64]
        self._pool = self._lib.taskpool_create(n_threads)
        self._handles: Dict[int, TaskHandle] = {}
        self._pending: List[Task] = []
        self._lock = threading.Lock()
        self._keepalive: List[Any] = []

    def submit(self, task: Task, on_progress=None, on_stage=None
               ) -> TaskHandle:
        """NewTaskEvent equivalent: schedule and return a handle."""
        holder: Dict[str, Any] = {}

        @_TASK_FN
        def trampoline(_ctx, task_id):
            handle = holder["handle"]
            ctx = TaskContext(self, task_id, on_progress, on_stage)
            try:
                handle.result = task.run_task(ctx)
            except BaseException as e:   # noqa: BLE001 — surfaced in wait()
                handle.error = e

        # Keep the callback alive for the task's lifetime.
        self._keepalive.append(trampoline)

        with self._lock:
            # Reserve the handle before submission so the trampoline can
            # find it even if it starts immediately.
            handle = TaskHandle(self, -1, task)
            holder["handle"] = handle
            task_id = self._lib.taskpool_submit(self._pool, trampoline, None)
            handle.task_id = task_id
            self._handles[task_id] = handle
        return handle

    def wait_all(self) -> None:
        self._lib.taskpool_wait_all(self._pool)

    def close(self) -> None:
        if self._pool:
            self._lib.taskpool_destroy(self._pool)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
