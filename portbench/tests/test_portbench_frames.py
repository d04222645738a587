"""The pool of frames and the order of a run come from the seed."""

from __future__ import annotations

import torch

from portbench import harness
from portbench.tests.conftest import tiny

CPU = torch.device("cpu")
BIG_SEED = 2 ** 31 + 12345


def test_same_seed_same_pool():
    config, traffic = tiny("refr_mvs8_r2.wta")
    _, a, order_a = harness.make_frames(config, traffic, BIG_SEED, CPU)
    _, b, order_b = harness.make_frames(config, traffic, BIG_SEED, CPU)
    assert torch.equal(a.rgbs, b.rgbs) and order_a == order_b


def test_other_seed_other_pool():
    config, traffic = tiny("refr_mvs8_r2.wta")
    _, a, _ = harness.make_frames(config, traffic, BIG_SEED, CPU)
    _, b, _ = harness.make_frames(config, traffic, BIG_SEED + 1, CPU)
    assert not torch.equal(a.rgbs, b.rgbs)


def test_frames_differ_within_a_pool():
    config, traffic = tiny("refr_pair_r5.wta")
    rig, pool, order = harness.make_frames(config, traffic, BIG_SEED, CPU)
    assert len(rig) == 2 and sorted(order) == [0, 1, 2]
    assert pool.rgbs.shape == (3, 2, 48, 64, 3)
    assert pool.rgbs.dtype == torch.float32 and bool(pool.masks.all())
    assert 0.0 <= float(pool.rgbs.min()) and float(pool.rgbs.max()) <= 255.0
    for f in range(1, 3):
        assert not torch.equal(pool.rgbs[0], pool.rgbs[f])


def test_scene_depths_inside_the_labels():
    from portbench import frames
    config, traffic = tiny("refr_mvs8_r2.wta")
    rig = frames.converging_rig(config["rig"])
    _, pool, _ = harness.make_frames(config, traffic, BIG_SEED, CPU)
    s = config["settings"]
    for plane in pool.planes:
        d = frames.true_depths(rig, config["use_views"], 48, 64,
                               s["image_scale"], plane, CPU)
        inside = (d >= s["min_depth"]) & (d <= s["max_depth"])
        assert float(inside.double().mean()) > 0.9
