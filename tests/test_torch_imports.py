"""The port, chip_smoke.py and kernel_variants.py stay free of JAX and of
the JAX package.

Importing anything under ``stereoreconstruction_tpu`` imports JAX and turns
on x64 (its ``__init__``), and the machine with the GPU has no JAX; so the
port keeps its own copies of what it needs."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "stereoreconstruction_tpu_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PKG.rglob("*.py"))


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert {"stereoreconstruction_tpu_torch.stereo.multiview",
            "stereoreconstruction_tpu_torch.stereo.twoview",
            "stereoreconstruction_tpu_torch.ops.cuda_warp",
            "stereoreconstruction_tpu_torch.ops.cuda_cost_wta",
            "stereoreconstruction_tpu_torch.ops.cuda_sample",
            "stereoreconstruction_tpu_torch.stereo.mrf",
            "stereoreconstruction_tpu_torch.runtime.trace",
            "stereoreconstruction_tpu_torch.optim.lm",
            "stereoreconstruction_tpu_torch.calib.zhang",
            "stereoreconstruction_tpu_torch.calib.rig",
            "stereoreconstruction_tpu_torch.calib.bundle",
            "stereoreconstruction_tpu_torch.calib.refraction",
            "stereoreconstruction_tpu_torch.calib.badata",
            "stereoreconstruction_tpu_torch.calib.floydwarshall",
            "stereoreconstruction_tpu_torch.features.detect",
            "stereoreconstruction_tpu_torch.features.checkerboard",
            "stereoreconstruction_tpu_torch.features.matching",
            "stereoreconstruction_tpu_torch.features.surf",
            "stereoreconstruction_tpu_torch.runtime.checkpoint",
            "stereoreconstruction_tpu_torch.viz.render"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'stereoreconstruction_tpu' "
            "or m.startswith('stereoreconstruction_tpu.')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_sources_do_not_name_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+jax\b|"
                         r"stereoreconstruction_tpu\.",
                         re.MULTILINE)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                       ROOT / "kernel_variants.py"]
    hits = [f"{f.relative_to(ROOT)}: {m.group(0)!r}" for f in files
            for m in pattern.finditer(f.read_text())]
    assert not hits, hits
