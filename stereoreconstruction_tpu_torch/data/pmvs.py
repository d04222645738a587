"""Copy of ``stereoreconstruction_tpu/data/pmvs.py`` (numpy).

PMVS interop — export a project in Yasutaka Furukawa's PMVS-2 layout.

Re-implements the reference's PMVS exporter (MainWindow's projection-matrix
export + PMVSDialog runner, gui/mainwindow.cpp:983-1035, gui/dialogs/
pmvsdialog.cpp:52-71): writes ``txt/XXXXXXXX.txt`` CONTOUR projection
matrices, ``visualize/XXXXXXXX.<ext>`` images, and an ``option.txt``.
Running the external pmvs-2 binary is the caller's affair (the reference
shells out with QProcess; we return the command line).
"""

from __future__ import annotations

import os
import shutil
from typing import List, Sequence

import numpy as np


def export_pmvs(out_dir: str, cam_records, image_paths: Sequence[str],
                level: int = 1, csize: int = 2, threshold: float = 0.7,
                wsize: int = 7, min_image_num: int = 3) -> List[str]:
    """Write the PMVS input layout; returns the pmvs-2 argv."""
    os.makedirs(os.path.join(out_dir, "txt"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "visualize"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "models"), exist_ok=True)

    for i, (rec, img) in enumerate(zip(cam_records, image_paths)):
        P = np.asarray(rec.P if hasattr(rec, "P") else rec, np.float64)
        with open(os.path.join(out_dir, "txt", f"{i:08d}.txt"), "w") as f:
            f.write("CONTOUR\n")
            for row in P:
                f.write(" ".join(f"{v:.10g}" for v in row) + "\n")
        ext = os.path.splitext(img)[1] or ".jpg"
        shutil.copy(img, os.path.join(out_dir, "visualize",
                                      f"{i:08d}{ext}"))

    n = len(image_paths)
    with open(os.path.join(out_dir, "option.txt"), "w") as f:
        f.write(f"level {level}\n"
                f"csize {csize}\n"
                f"threshold {threshold}\n"
                f"wsize {wsize}\n"
                f"minImageNum {min_image_num}\n"
                f"CPU 8\n"
                f"timages -1 0 {n}\n"
                f"oimages 0\n")
    return ["pmvs-2", out_dir + os.sep, "option.txt"]
