"""The plain reference against the port's CPU path on a tiny frame, and the
comparison that judges them."""

from __future__ import annotations

import pytest
import torch

from portbench import harness, registry
from portbench.reference.compare import mismatch_pct
from portbench.tests.conftest import tiny

CPU = torch.device("cpu")
NAN, INF = float("nan"), float("inf")


def answers(cell_name, seed=2 ** 31 + 99):
    """(the program's depth maps, the reference's) of frame 0."""
    config, traffic = tiny(cell_name)
    engine = registry.engine(config["engine"])
    rig, pool, _ = harness.make_frames(config, traffic, seed, CPU)
    request, _ = engine.build(config, traffic["flow"], rig, CPU)
    got = engine.answer_maps(request(pool.rgbs[0], pool.masks))
    want = harness.reference_maps(registry.reference(config["reference"]),
                                  config, traffic, rig, pool, 0)
    return got, want


# The multi-view engine reads its neighbours at integer pixels, so the last
# bits of a match coordinate (the reference's frame changes are matrix
# products, the port's unrolled sums) change nothing on the CPU; the two-view
# engine samples bilinearly, and those bits move a near-tie now and then.
@pytest.mark.parametrize("cell_name,most", [
    ("refr_mvs8_r2.wta", 0.0), ("refr_mvs8_r2.mrf", 0.0),
    ("refr_pair_r5.wta", 0.5), ("refr_pair_r5.mrf", 0.5)])
def test_reference_matches_the_port_on_the_cpu(cell_name, most):
    got, want = answers(cell_name)
    assert got.shape == want.shape
    depth = torch.isfinite(want) & (want > 0)
    assert float(depth.double().mean()) > 0.02     # the check sees depths
    assert mismatch_pct(got, want) <= most


def test_mismatch_kinds():
    want = torch.tensor([1.0, NAN, INF, -1.0, 50.0, 50.0])
    assert mismatch_pct(want.clone(), want) == 0.0
    for k, other in enumerate([2.0, 1.0, NAN, INF, -1.0, 50.01]):
        got = want.clone()
        got[k] = other
        assert mismatch_pct(got, want) == pytest.approx(100.0 / 6)


def test_reference_imports_nothing_of_the_port():
    import subprocess
    import sys
    code = ("import sys, portbench.reference.mvs, portbench.reference.pair, "
            "portbench.reference.compare; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'stereoreconstruction_tpu_torch', 'stereoreconstruction_tpu', "
            "'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=registry.ROOT, check=True)
    assert out.stdout.strip() == "[]"
