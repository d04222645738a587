from .rays import closest_points, intersect_plane, refract_ray
from .camera import (
    Camera,
    make_camera,
    camera_from_numpy,
    stack_cameras,
    camera_at,
    broadcast_camera,
    project,
    unproject,
    principal_ray,
    from_global_to_local,
)
from .quartic import refraction_radius

__all__ = [
    "closest_points",
    "intersect_plane",
    "refract_ray",
    "Camera",
    "make_camera",
    "camera_from_numpy",
    "stack_cameras",
    "camera_at",
    "broadcast_camera",
    "project",
    "unproject",
    "principal_ray",
    "from_global_to_local",
    "refraction_radius",
]
