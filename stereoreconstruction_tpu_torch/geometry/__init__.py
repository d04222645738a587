from .rays import (closest_points, intersect_plane, refract_ray,
                   ray_ray_distance, ray_midpoint)
from .camera import (
    Camera,
    make_camera,
    camera_from_P,
    camera_from_numpy,
    stack_cameras,
    camera_at,
    broadcast_camera,
    project,
    unproject,
    principal_ray,
    from_global_to_local,
    from_local_to_global,
)
from .plane import Plane, make_plane
from .quartic import refraction_radius

__all__ = [
    "closest_points",
    "intersect_plane",
    "refract_ray",
    "ray_ray_distance",
    "ray_midpoint",
    "Plane",
    "make_plane",
    "Camera",
    "make_camera",
    "camera_from_P",
    "camera_from_numpy",
    "stack_cameras",
    "camera_at",
    "broadcast_camera",
    "project",
    "unproject",
    "principal_ray",
    "from_global_to_local",
    "from_local_to_global",
    "refraction_radius",
]
