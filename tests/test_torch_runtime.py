"""The port's task runtime on its own build of the native pool: the five
cases of tests/test_runtime.py (progress, cancellation, error
propagation, parallel execution, the progress callback), and the build
written under build/native/."""

import time

import pytest

from stereoreconstruction_tpu_torch.runtime.native import build
from stereoreconstruction_tpu_torch.runtime.tasks import FnTask, TaskRunner


@pytest.fixture(scope="module")
def runner():
    with TaskRunner(4) as tr:
        yield tr


def test_result_and_progress(runner):
    def work(ctx):
        for i in range(20):
            ctx.progress(i)
        return 42

    h = runner.submit(FnTask(work, num_steps=20))
    assert h.wait() == 42
    assert h.progress == 19
    assert h.done
    # the library is the port's own build, outside the JAX package
    path = build.build_native()
    assert "/build/native/" in path and "stereoreconstruction_tpu/" not in path


def test_cancellation(runner):
    def work(ctx):
        for i in range(200):
            if ctx.is_cancelled():
                return "cancelled"
            time.sleep(0.005)
        return "finished"

    h = runner.submit(FnTask(work))
    time.sleep(0.03)
    h.cancel()
    assert h.wait() == "cancelled"


def test_error_propagates(runner):
    def boom(ctx):
        raise RuntimeError("task failed")

    h = runner.submit(FnTask(boom))
    with pytest.raises(RuntimeError, match="task failed"):
        h.wait()


def test_parallel_wall_clock(runner):
    def work(ctx):
        time.sleep(0.15)
        return 1

    t0 = time.time()
    hs = [runner.submit(FnTask(work)) for _ in range(4)]
    assert sum(h.wait() for h in hs) == 4
    # 4 x 0.15s of sleeping on 4 threads should take ~0.15s, not 0.6s
    assert time.time() - t0 < 0.45


def test_progress_callback(runner):
    seen = []

    def work(ctx):
        for i in range(5):
            ctx.progress(i)
            ctx.stage(f"step {i}")
        return True

    h = runner.submit(FnTask(work), on_progress=seen.append)
    assert h.wait()
    assert seen == [0, 1, 2, 3, 4]
