"""Plane representation matching the reference's ``util/plane.hpp:26-47``.

Port of ``stereoreconstruction_tpu/geometry/plane.py``: a plane is ``(unit
normal n, scalar distance d)`` with ``x0() = d * n``, both float64 tensors
that may carry leading batch dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .rays import _norm


class Plane(NamedTuple):
    normal: torch.Tensor  # [..., 3], unit length
    dist: torch.Tensor    # [...]

    @property
    def x0(self):
        return self.dist[..., None] * self.normal


def make_plane(normal, dist, device=None):
    """Build a plane, normalizing the normal (Plane3d ctor semantics).
    ``device``: where the tensors live (default: the inputs' device, the
    CPU for numpy or Python values)."""
    normal = torch.as_tensor(normal, dtype=torch.float64, device=device)
    dist = torch.as_tensor(dist, dtype=torch.float64, device=normal.device)
    normal = normal / torch.clamp(_norm(normal), min=1e-300)[..., None]
    return Plane(normal=normal, dist=dist)
