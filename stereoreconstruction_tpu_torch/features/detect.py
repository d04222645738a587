"""Feature gathering for the calibration verbs.

Port of ``gather_calibration_points`` from
``stereoreconstruction_tpu/features/detect.py`` (numpy).  The detectors
(checkerboard, SURF) and the matcher of that module come with the port's
``features`` slice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..data.project_io import ProjectData


def gather_calibration_points(
        proj: ProjectData, camera_ids: Sequence[str],
        image_set_ids: Sequence[str],
        n_corners: int) -> List[List[Optional[np.ndarray]]]:
    """image_points[cam][set] arrays for CameraCalibration
    (calibrate.cpp:694-716)."""
    out = []
    for cid in camera_ids:
        row = []
        for sid in image_set_ids:
            feats = proj.features.get((sid, cid))
            if feats and len(feats) == n_corners:
                row.append(np.array([[f.x, f.y] for f in feats]))
            else:
                row.append(None)
        out.append(row)
    return out
