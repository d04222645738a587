"""Feature detection driver — the ``FindFeaturesTask`` equivalent
(features/findfeaturestask.cpp): run a detector over (image sets x cameras)
and store results in the project's feature database, then establish
correspondences over all camera pairs (MainWindow::
on_actionFind_Feature_Correspondences_triggered, mainwindow.cpp:1115-1139).

Port of ``stereoreconstruction_tpu/features/detect.py``.  The checkerboard
detector is numpy: image decode and detection fan out over a thread pool.
SURF (features/surf.py) and the descriptor matcher (features/matching.py)
run on the device, CUDA unless the caller names another.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..config import MatchConfig
from ..data.images import load_image, to_gray
from ..data.project_io import FeatureRecord, ProjectData
from ..device import resolve_device
from .checkerboard import find_chessboard_corners
from .matching import find_correspondences


def detect_checkerboards(proj: ProjectData, cols: int = 11, rows: int = 9,
                         image_set_ids: Optional[Sequence[str]] = None,
                         camera_ids: Optional[Sequence[str]] = None,
                         max_workers: int = 8,
                         progress: Optional[Callable[[int, int], None]]
                         = None) -> int:
    """Detect checkerboard corners for every (set, camera) image; fills
    ``proj.features``.  Returns the number of images with detections."""
    set_ids = list(image_set_ids or proj.image_sets)
    cam_ids = list(camera_ids or proj.cameras)

    jobs = []
    for sid in set_ids:
        iset = proj.image_sets.get(sid)
        if iset is None:
            continue
        for cid in cam_ids:
            img = iset.default_image_for_camera(cid)
            if img is not None:
                jobs.append((sid, cid, img.file))

    def run(job):
        sid, cid, path = job
        gray = to_gray(load_image(path, 1.0).rgb)
        corners = find_chessboard_corners(gray, cols, rows)
        return sid, cid, corners

    found = 0
    done = 0
    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        for sid, cid, corners in ex.map(run, jobs):
            done += 1
            if progress:
                progress(done, len(jobs))
            if corners is None:
                continue
            proj.features[(sid, cid)] = [
                FeatureRecord(x=float(x), y=float(y), kind="checkerboard",
                              corner_index=i, image_set_id=sid)
                for i, (x, y) in enumerate(corners)]
            found += 1
    return found


def detect_surf(proj: ProjectData,
                image_set_ids: Optional[Sequence[str]] = None,
                camera_ids: Optional[Sequence[str]] = None,
                threshold: float = 100.0, max_keypoints: int = 1000,
                device=None) -> int:
    """SURF detection over the selected images, on ``device``."""
    from .surf import detect_and_describe

    dev = resolve_device(device)
    set_ids = list(image_set_ids or proj.image_sets)
    cam_ids = list(camera_ids or proj.cameras)
    found = 0
    for sid in set_ids:
        iset = proj.image_sets.get(sid)
        if iset is None:
            continue
        for cid in cam_ids:
            img = iset.default_image_for_camera(cid)
            if img is None:
                continue
            gray = to_gray(load_image(img.file, 1.0).rgb)
            fs = detect_and_describe(gray, threshold=threshold,
                                     max_keypoints=max_keypoints, device=dev)
            if len(fs.xy) == 0:
                continue
            proj.features[(sid, cid)] = [
                FeatureRecord(x=float(x), y=float(y), kind="surf",
                              image_set_id=sid, descriptor=fs.descriptors[i])
                for i, (x, y) in enumerate(fs.xy)]
            found += 1
    return found


def find_all_correspondences(proj: ProjectData,
                             cfg: MatchConfig = MatchConfig(),
                             device=None) -> int:
    """Match every (set, camera-pair) with features; fills
    ``proj.correspondences``.  Returns the number of pairs stored.
    Descriptor distances run on ``device``."""
    dev = resolve_device(device)
    n = 0
    for sid, iset in proj.image_sets.items():
        cam_ids = [c for c in proj.cameras if (sid, c) in proj.features]
        for i in range(len(cam_ids)):
            for j in range(i + 1, len(cam_ids)):
                f1 = proj.features[(sid, cam_ids[i])]
                f2 = proj.features[(sid, cam_ids[j])]
                pairs = find_correspondences(f1, f2, cfg, device=dev)
                if pairs:
                    proj.correspondences[
                        (sid, cam_ids[i], sid, cam_ids[j])] = pairs
                    n += 1
    return n


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
