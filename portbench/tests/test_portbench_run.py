"""A whole run, driven on the CPU at a tiny size past the look for a card:
its result, its import guard, and the faults it must catch."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, registry
from portbench.tests.conftest import tiny

CPU = torch.device("cpu")
LIMITS = {"mismatch_pct": {"limit": 1.0}}


def run(cell_name, trace=False, seconds=0.5):
    config, traffic = tiny(cell_name)
    return harness.run_cell(cell_name, 2 ** 31 + 5, seconds, trace, CPU,
                            time.perf_counter(), config=config,
                            traffic=traffic, limits=LIMITS)


def test_result_line():
    res = run("refr_pair_r5.wta")
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"pair_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["metrics"]["pair_per_s"]["unit"] == "pairs/s"
    assert res["checks"]["mismatch_pct"]["limit"] == 1.0
    json.loads(json.dumps(res))


def test_traced_run_reads_the_layers():
    res = run("refr_mvs8_r2.mrf", trace=True)
    assert res["correct"] is True
    m = res["metrics"]
    for name in ("mvs_inputs_ms", "trws_ms", "trws_iters_per_view",
                 "mvs_cross_check_ms"):
        assert m[name]["value"] > 0
    assert "breakdown" in res and "window_s" in res["device"]
    assert list(res)[-1] == "checks"


def test_a_mix_the_harness_cannot_run_is_refused():
    config, traffic = tiny("refr_pair_r5.wta")
    traffic["clients"] = 2
    with pytest.raises(ValueError, match="closed loop of one client"):
        harness.run_cell("refr_pair_r5.wta", 3, 0.2, False, CPU,
                         time.perf_counter(), config=config, traffic=traffic,
                         limits=LIMITS)


def test_no_jax_after_a_run():
    code = ("import time, torch; from portbench import harness; "
            "from portbench.tests.conftest import tiny; "
            "c, t = tiny('refr_pair_r5.wta'); "
            "harness.run_cell('refr_pair_r5.wta', 3, 0.2, False, "
            "torch.device('cpu'), time.perf_counter(), config=c, traffic=t, "
            "limits={'mismatch_pct': {'limit': 1.0}}); "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=registry.ROOT, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    monkeypatch.setitem(sys.modules, "stereoreconstruction_tpu_torch_x", sys)
    bad = harness.forbidden_modules()
    assert "jaxlike" not in bad
    assert "stereoreconstruction_tpu_torch_x" not in bad
    monkeypatch.setitem(sys.modules, "stereoreconstruction_tpu.fake", sys)
    assert "stereoreconstruction_tpu" in harness.forbidden_modules()


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "refr_pair_r5.wta", "--seed", str(2 ** 31 + 1), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=registry.ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode == 3 and out.stdout == ""


# The faults a run must catch (the others of a training step, a state left
# unchanged and a lost exchange between chips, these cells cannot have).

def _alter_answer(monkeypatch):
    """A depth altered where it is produced: every depth one label step
    farther in the first view."""
    from stereoreconstruction_tpu_torch.stereo import multiview
    orig = multiview.mvs_batched_with_cross_check

    def altered(*a, **kw):
        out = orig(*a, **kw).clone()
        out[0] = out[0] + 0.5
        return out
    monkeypatch.setattr(multiview, "mvs_batched_with_cross_check", altered)


def _half_batch(monkeypatch):
    """Half of the batch left out: the second half of the views gets no
    depth."""
    from stereoreconstruction_tpu_torch.stereo import multiview
    orig = multiview.mvs_batched_with_cross_check

    def halved(*a, **kw):
        out = orig(*a, **kw).clone()
        out[out.shape[0] // 2:] = float("nan")
        return out
    monkeypatch.setattr(multiview, "mvs_batched_with_cross_check", halved)


def _pair_altered(monkeypatch):
    from stereoreconstruction_tpu_torch.stereo import twoview
    orig = twoview.cross_check_pair

    def altered(*a, **kw):
        left, right = orig(*a, **kw)
        return left * 1.01, right
    monkeypatch.setattr(twoview, "cross_check_pair", altered)


@pytest.mark.parametrize("cell_name,fault", [
    ("refr_mvs8_r2.wta", _alter_answer),
    ("refr_mvs8_r2.wta", _half_batch),
    ("refr_pair_r5.wta", _pair_altered)])
def test_a_broken_path_is_not_correct(monkeypatch, cell_name, fault):
    fault(monkeypatch)
    res = run(cell_name)
    assert res["correct"] is False
    assert res["checks"]["mismatch_pct"]["value"] > 1.0
