#!/usr/bin/env python3
"""The JAX package's SURF results that chip_smoke.py holds the PyTorch
port to, measured on its CPU backend.

Run from the repository root (JAX on the CPU; about a minute):

    JAX_PLATFORMS=cpu python3 scripts/surf_reference.py

The inputs are chip_smoke.py's: the 8 views of its refractive rig rendered
at full size (768x1024, ``render_scene`` at scale 1.0), converted to gray
by the reference's luma in float32 (``chip_smoke.surf_grays``, the
formula of ``data/images.py to_gray``).  For each
view, ``detect_and_describe`` with its defaults (threshold 100, at most
1000 keypoints) gives the keypoint count and the sum of the responses
(float64).  Prints one JSON line, with the wall seconds on this CPU.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from stereoreconstruction_tpu.features.surf import (  # noqa: E402
    detect_and_describe)


def main():
    grays = chip_smoke.surf_grays()
    counts, sums = [], []
    t0 = time.time()
    for g in grays:
        fs = detect_and_describe(g)
        counts.append(len(fs.xy))
        sums.append(float(np.sum(fs.response, dtype=np.float64)))
    print(json.dumps({"keypoints": counts, "response_sums": sums,
                      "s": time.time() - t0}))


if __name__ == "__main__":
    main()
