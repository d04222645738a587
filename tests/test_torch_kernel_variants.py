"""kernel_variants.py's ablations still apply to the shipped kernels.

Each ablation is a text substitution on a ``csrc`` source; the script
refuses to run one whose text is gone, which would only show on the GPU.
This holds them to the sources here, on the CPU."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import kernel_variants  # noqa: E402


@pytest.mark.parametrize("kernel,variants", [
    ("mvs_sweep", kernel_variants.SWEEP_VARIANTS),
    ("geodesic_weights", kernel_variants.WEIGHTS_VARIANTS),
    ("cost_wta", kernel_variants.COST_VARIANTS),
])
def test_every_variant_applies_to_the_shipped_source(tmp_path, kernel,
                                                     variants):
    out = kernel_variants.variant_sources(kernel, variants, None, tmp_path)
    assert [name for name, _, _ in out] == [v[0] for v in variants]
    shipped = (kernel_variants.CSRC / f"{kernel}.cu").read_text()
    texts = [path.read_text() for _, path, _ in out]
    assert texts[0] == shipped
    # every ablation changes the source, and no two are the same
    assert len(set(texts)) == len(texts)
