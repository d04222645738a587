"""Synchronized multi-camera capture interface.

Copy of ``stereoreconstruction_tpu/runtime/capture.py`` (numpy) on the
port's ``data/demosaic.py``.  The reference captures synchronized frames
from up to 16 Point Grey FlyCapture2 cameras with software trigger
registers + Bayer conversion (gui/captureimagesthread.hpp:28-80,
capture_impl/captureimagesthread_pgr.cpp) behind the ``pgr`` build flag.
That hardware SDK is out of scope; the interface is preserved with a
file-backed stub so capture-driven workflows (capture -> demosaic -> image
set) remain scriptable.
"""

from __future__ import annotations

import abc
import glob
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..data.demosaic import DEMOSAICERS


@dataclass
class CapturedFrame:
    camera_index: int
    rgb: np.ndarray       # [H, W, 3] uint8


class CaptureBackend(abc.ABC):
    """CaptureImagesThread<T> equivalent: trigger-synchronized burst
    capture across all attached cameras."""

    @abc.abstractmethod
    def num_cameras(self) -> int: ...

    @abc.abstractmethod
    def capture(self) -> List[CapturedFrame]:
        """One synchronized frame per camera."""


class FileCaptureBackend(CaptureBackend):
    """Stub backend: replays raw Bayer (.pgm/.npy) or image files from
    per-camera directories, applying the selected demosaicer (the
    reference's RAW->PNG conversion uses edge-sensing,
    mainwindow.cpp:1088)."""

    def __init__(self, camera_dirs: Sequence[str], demosaic: str = "es"):
        self.dirs = list(camera_dirs)
        self.demosaic = DEMOSAICERS[demosaic]
        self._cursors = [0] * len(self.dirs)
        self._files = [sorted(glob.glob(os.path.join(d, "*")))
                       for d in self.dirs]

    def num_cameras(self) -> int:
        return len(self.dirs)

    def capture(self) -> List[CapturedFrame]:
        frames = []
        for ci, files in enumerate(self._files):
            if self._cursors[ci] >= len(files):
                raise StopIteration(f"camera {ci} exhausted")
            path = files[self._cursors[ci]]
            self._cursors[ci] += 1
            if path.endswith(".npy"):
                raw = np.load(path)
            else:
                from PIL import Image
                raw = np.asarray(Image.open(path).convert("L"))
            rgb = self.demosaic(raw)
            frames.append(CapturedFrame(camera_index=ci, rgb=rgb))
        return frames
