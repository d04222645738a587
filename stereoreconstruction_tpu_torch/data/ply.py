"""PLY point-cloud / mesh I/O.

Writer replicates ``outputPLYFile`` (stereo/multiviewstereo.cpp:291-315):
ASCII format, float x/y/z + uchar diffuse_red/green/blue.  The reader handles
both ASCII and binary_little_endian files with arbitrary vertex properties
plus triangle faces (the reference's MainWindow PLY loader supports binary
and faces too, gui/mainwindow.cpp:277-475), and ``generate_normals``
replicates its smooth-look normal synthesis for files without nx/ny/nz
(face-averaged cross products, unit (0,0,1) fallback for pure point clouds
— gui/mainwindow.cpp:421-462).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

_STRUCT_FMT = {
    "char": "b", "int8": "b",
    "uchar": "B", "uint8": "B",
    "short": "h", "int16": "h",
    "ushort": "H", "uint16": "H",
    "int": "i", "int32": "i",
    "uint": "I", "uint32": "I",
    "float": "f", "float32": "f",
    "double": "d", "float64": "d",
}


def write_ply(path: str, points: np.ndarray,
              colors: Optional[np.ndarray] = None) -> None:
    """Write an ASCII PLY file in the reference's exact layout.

    points: [N, 3] float; colors: [N, 3] in 0..255 (defaults to white).
    """
    points = np.asarray(points)
    n = len(points)
    if colors is None:
        colors = np.full((n, 3), 255)
    colors = np.asarray(colors).astype(int)

    with open(path, "w") as f:
        f.write("ply\n"
                "format ascii 1.0\n"
                f"element vertex {n}\n"
                "property float x\n"
                "property float y\n"
                "property float z\n"
                "property uchar diffuse_red\n"
                "property uchar diffuse_green\n"
                "property uchar diffuse_blue\n"
                "end_header\n")
        for p, c in zip(points, colors):
            f.write(f"{p[0]:g} {p[1]:g} {p[2]:g} {c[0]} {c[1]} {c[2]}\n")


@dataclass
class PlyData:
    points: np.ndarray                       # [N, 3]
    colors: Optional[np.ndarray] = None      # [N, 3] 0..255
    normals: Optional[np.ndarray] = None     # [N, 3] unit
    faces: Optional[np.ndarray] = None       # [F, 3] vertex indices


def read_ply_full(path: str) -> PlyData:
    """Read ASCII or binary_little_endian PLY: vertices (arbitrary scalar
    properties) + optional triangle faces."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        n_vertex = 0
        n_face = 0
        props = []            # (name, type) for the vertex element
        face_types = None     # (count type, index type) for the face list
        element = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unterminated PLY header")
            parts = line.decode("ascii", "replace").strip().split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                element = parts[1]
                if element == "vertex":
                    n_vertex = int(parts[2])
                elif element == "face":
                    n_face = int(parts[2])
            elif parts[0] == "property" and element == "vertex":
                if parts[1] == "list":
                    raise ValueError("list properties unsupported for vertex")
                props.append((parts[2], parts[1]))
            elif parts[0] == "property" and element == "face":
                if parts[1] == "list":
                    face_types = (parts[2], parts[3])
            elif parts[0] == "end_header":
                break

        names = [p[0] for p in props]
        faces = []
        if fmt == "ascii":
            data = np.loadtxt(
                [f.readline() for _ in range(n_vertex)], ndmin=2)
            for _ in range(n_face):
                nums = f.readline().split()
                k = int(nums[0])
                idx = [int(v) for v in nums[1:1 + k]]
                # fan-triangulate polygons, like a GL_TRIANGLES consumer
                for t in range(1, k - 1):
                    faces.append((idx[0], idx[t], idx[t + 1]))
        elif fmt == "binary_little_endian":
            rec = "<" + "".join(_STRUCT_FMT[t] for _, t in props)
            size = struct.calcsize(rec)
            raw = f.read(size * n_vertex)
            data = np.array([struct.unpack_from(rec, raw, i * size)
                             for i in range(n_vertex)], dtype=np.float64)
            if n_face and face_types:
                cf = "<" + _STRUCT_FMT[face_types[0]]
                idxf = _STRUCT_FMT[face_types[1]]
                csz = struct.calcsize(cf)
                for _ in range(n_face):
                    k = struct.unpack(cf, f.read(csz))[0]
                    lf = "<" + idxf * k
                    idx = struct.unpack(lf, f.read(struct.calcsize(lf)))
                    for t in range(1, k - 1):
                        faces.append((idx[0], idx[t], idx[t + 1]))
        else:
            raise ValueError(f"unsupported PLY format {fmt!r}")

    def col(name_options):
        for nm in name_options:
            if nm in names:
                return data[:, names.index(nm)]
        return None

    xyz = np.stack([col(["x"]), col(["y"]), col(["z"])], axis=-1)
    r = col(["diffuse_red", "red", "r"])
    rgb = None
    if r is not None:
        rgb = np.stack([r, col(["diffuse_green", "green", "g"]),
                        col(["diffuse_blue", "blue", "b"])], axis=-1)
    nx = col(["nx"])
    normals = None
    if nx is not None:
        normals = np.stack([nx, col(["ny"]), col(["nz"])], axis=-1)
    return PlyData(points=xyz, colors=rgb, normals=normals,
                   faces=np.asarray(faces, np.int64) if faces else None)


def read_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read ASCII or binary_little_endian PLY; returns (xyz [N,3], rgb [N,3]
    or None)."""
    d = read_ply_full(path)
    return d.points, d.colors


def generate_normals(points: np.ndarray,
                     faces: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-vertex normals for a mesh/cloud without them, replicating the
    reference's smooth-look synthesis (gui/mainwindow.cpp:421-462):
    unnormalized face cross products accumulated onto each face's vertices,
    then unit-normalized (zero-degree vertices stay 0); point clouds without
    faces get the constant (0, 0, 1)."""
    points = np.asarray(points, np.float64)
    n = len(points)
    if faces is None or len(faces) == 0:
        out = np.zeros((n, 3))
        out[:, 2] = 1.0
        return out
    faces = np.asarray(faces, np.int64)
    p0, p1, p2 = (points[faces[:, k]] for k in range(3))
    fn = np.cross(p1 - p0, p2 - p0)          # area-weighted, not normalized
    out = np.zeros((n, 3))
    for k in range(3):
        np.add.at(out, faces[:, k], fn)
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return np.where(norm > 1e-10, out / np.maximum(norm, 1e-30), out)
