"""Copy of ``stereoreconstruction_tpu/runtime/checkpoint.py`` (numpy).

Depth-map persistence + mid-task resume.

The reference never persists computed depth maps (explicit TODOs at
stereo/twoviewstereo.cpp:175,197) and cannot resume an interrupted stereo
task; only the project XML round-trips.  Here each view's depth map is
checkpointed as it completes, so a killed multi-view run restarts from the
last finished view, and downstream tools (PLY export, rendering,
cross-checking with different thresholds) can reload results without
recomputing the cost volumes.

Format: one ``depth_<view_id>.npz`` per view containing the float depth map
(NaN/inf sentinels preserved) plus the stereo-config fingerprint; a stale
checkpoint (different config or image shape) is ignored, not trusted.
``config.py`` is the same in both packages, so one config gives one
fingerprint in either, and a directory written by one is read by the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Optional

import numpy as np


def config_fingerprint(cfg) -> str:
    """Stable hash of a (frozen dataclass) stereo config."""
    if dataclasses.is_dataclass(cfg):
        desc = repr(dataclasses.asdict(cfg))
    else:
        desc = repr(cfg)
    return hashlib.sha256(desc.encode()).hexdigest()[:16]


class DepthCheckpoint:
    """Per-view depth-map store rooted at a directory.

    ``read_only``: load what the directory holds and save nothing (the
    ranks of a sharded run other than the one that writes)."""

    def __init__(self, directory: str, cfg=None, *, read_only=False):
        self.dir = directory
        self.fingerprint = config_fingerprint(cfg) if cfg is not None else ""
        self.read_only = read_only
        if not read_only:
            os.makedirs(directory, exist_ok=True)

    def _path(self, view_id: str) -> str:
        return os.path.join(self.dir, f"depth_{view_id}.npz")

    def save(self, view_id: str, depth) -> Optional[str]:
        if self.read_only:
            return None
        depth = np.asarray(depth)
        path = self._path(view_id)
        tmp = path + ".tmp"
        np.savez_compressed(tmp, depth=depth,
                            fingerprint=np.str_(self.fingerprint))
        # np.savez appends .npz to the tmp name
        os.replace(tmp if os.path.exists(tmp) else tmp + ".npz", path)
        return path

    def load(self, view_id: str,
             expect_shape=None) -> Optional[np.ndarray]:
        """Return the stored depth map, or None if absent/stale."""
        path = self._path(view_id)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path) as z:
                if self.fingerprint and \
                        str(z["fingerprint"]) != self.fingerprint:
                    return None
                depth = z["depth"]
        except (OSError, KeyError, ValueError):
            return None
        if expect_shape is not None and tuple(depth.shape) != \
                tuple(expect_shape):
            return None
        return depth

    def has(self, view_id: str, expect_shape=None) -> bool:
        return self.load(view_id, expect_shape) is not None
