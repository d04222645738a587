"""Batched ray primitives.

Port of ``stereoreconstruction_tpu/geometry/rays.py``: the semantics of the
reference's ``util/ray.{hpp,cpp}`` (``Ray3d::closestPoints`` ray.cpp:53-74,
``intersect(ray, plane)`` ray.cpp:78-88, ``refract(R, P, n, Rout)``
ray.cpp:92-106) as functions over ``[..., 3]`` tensors that broadcast over
their leading dimensions.

A ray is an ``(origin, direction)`` pair; callers pass normalized directions
(``unproject`` and ``refract_ray`` return normalized directions).
"""

from __future__ import annotations

import torch

_EPS = 1e-10


def _dot(a, b):
    """Dot product over the last axis, unrolled in a fixed summation order."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _norm(a):
    return torch.sqrt(_dot(a, a))


def closest_points(o1, d1, o2, d2):
    """Closest points between two rays (each ``[..., 3]``).

    Matches ray.cpp:53-74 including the one-sided clamp: each closest point
    moves along its ray only when the line parameter is positive.
    Returns ``(p1, p2)``, each ``[..., 3]``.
    """
    w0 = o1 - o2
    a = _dot(d1, d1)
    b = _dot(d1, d2)
    c = _dot(d2, d2)
    d = _dot(d1, w0)
    e = _dot(d2, w0)

    den = 1.0 / (a * c - b * b)
    tl = (b * e - c * d) * den
    tr = (a * e - b * d) * den

    p1 = o1 + torch.where(tl > 0, tl, 0.0)[..., None] * d1
    p2 = o2 + torch.where(tr > 0, tr, 0.0)[..., None] * d2
    return p1, p2


def intersect_plane(o, d, normal, dist):
    """Ray/plane intersection (ray.cpp:78-88) with the plane
    ``{x : normal . x = dist}`` (``normal`` unit length).

    Returns ``(point, valid)``; ``valid`` is False when the ray is parallel
    to the plane (|n.d| < 1e-10) or the hit parameter t < 1e-10.
    """
    x0 = dist[..., None] * normal
    nd = _dot(normal, d)
    nd_safe = torch.where(nd.abs() < _EPS, 1.0, nd)
    t = _dot(normal, x0 - o) / nd_safe
    valid = (nd.abs() >= _EPS) & (t >= _EPS)
    p = o + t[..., None] * d
    return p, valid


def refract_ray(o, d, normal, dist, n):
    """Snell-refract a ray through a plane (ray.cpp:92-106).

    ``n`` is the refractive index ratio.  Returns ``(o_out, d_out, valid)``;
    where refraction is impossible (no hit, total internal reflection) the
    input ray comes back unchanged with ``valid = False``, as in
    ``Camera::unproject`` (camera.cpp:455-456).  ``d_out`` is normalized.
    """
    p, hit = intersect_plane(o, d, normal, dist)

    cos_i = -_dot(normal, d)
    cos_t2 = 1.0 - (1.0 - cos_i * cos_i) / (n * n)
    ok = hit & (cos_t2 > 0.0)

    one = torch.ones_like(cos_i)
    sign = torch.where(cos_i > 0.0, -one, one)
    scale = cos_i + n * sign * torch.sqrt(torch.clamp(cos_t2, min=0.0))
    d_new = d + scale[..., None] * normal
    d_new = d_new / torch.clamp(_norm(d_new), min=_EPS)[..., None]

    o_out = torch.where(ok[..., None], p, o)
    d_out = torch.where(ok[..., None], d_new, d)
    return o_out, d_out, ok
