"""The control of each cell's check: the reference computed in bfloat16,
the precision below the configuration's float32, put in the program's
place, must come out as not correct under the cell's limit.  Every sum,
coordinate and message of the control is bfloat16, while its label table
and its maps stay float32, so that it fails by its arithmetic and not by
rounded depths.  On the card the same reading is taken at the cell's own
size by ``portbench.readings`` (PERF.md gives those readings); here a whole
run at a size a CPU test run holds goes through ``harness.check``."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, registry
from portbench.tests.conftest import tiny

CPU = torch.device("cpu")


def control_engine(reference):
    """An engine whose request is the reference in bfloat16."""
    def build(config, flow, rig, device):
        def request(rgbs, masks):
            return reference.depth_maps(rgbs, masks, rig, config["settings"],
                                        flow, dtype=torch.bfloat16)
        return request, len(rig)
    return SimpleNamespace(build=build, answer_maps=lambda answer: answer)


@pytest.mark.parametrize("cell_name", [
    w["name"] for w in registry.benchmark()["workloads"]])
def test_bfloat16_reference_fails_the_check(monkeypatch, cell_name):
    config, traffic = tiny(cell_name)
    reference = registry.reference(config["reference"])
    monkeypatch.setattr(registry, "engine",
                        lambda name: control_engine(reference))
    res = harness.run_cell(cell_name, 2 ** 31 + 3, 0.2, False, CPU,
                           time.perf_counter(), config=config,
                           traffic=traffic)
    limit = registry.limits(cell_name)["mismatch_pct"]["limit"]
    assert res["checks"]["mismatch_pct"]["limit"] == limit
    assert res["checks"]["mismatch_pct"]["value"] > limit
    assert res["correct"] is False and res["failed"] > 0


def test_control_maps_hold_float32_labels():
    config, traffic = tiny("refr_pair_r5.wta")
    reference = registry.reference(config["reference"])
    rig, pool, _ = harness.make_frames(config, traffic, 2 ** 31 + 3, CPU)
    low = harness.reference_maps(reference, config, traffic, rig, pool, 0,
                                 control=True)
    s = config["settings"]
    labels = reference.g.labels_twoview(s["min_depth"], s["max_depth"],
                                        s["num_depth_levels"], torch.float32,
                                        CPU)
    depth = low[torch.isfinite(low)]
    assert low.dtype == torch.float32 and depth.numel() > 0
    assert bool(torch.isin(depth, labels).all())
