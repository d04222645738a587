"""Copy of ``stereoreconstruction_tpu/data/formats.py`` (numpy).

HDR image formats: Radiance RGBE and minimal OpenEXR.

The reference writes OpenEXR via the OpenEXR library and Radiance RGBE via
an ``rgbe.h`` module that is not even present in its tree (hdr.cpp:28-30,
80-145).  Both are implemented from scratch here:

* RGBE: flat (uncompressed) Radiance .hdr with shared-exponent encoding,
* EXR: minimal OpenEXR 2.0 writer/reader — single part, no compression,
  half or float channels — enough for interchange with standard tools.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Radiance RGBE
# ---------------------------------------------------------------------------

def float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """[..., 3] float -> [..., 4] uint8 shared-exponent encoding."""
    rgb = np.asarray(rgb, np.float64)
    maxc = rgb.max(axis=-1)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    nz = maxc >= 1e-32
    mant, expo = np.frexp(np.where(nz, maxc, 1.0))
    scale = mant * 256.0 / np.where(nz, maxc, 1.0)
    enc = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., :3] = np.where(nz[..., None], enc, 0)
    out[..., 3] = np.where(nz, expo + 128, 0).astype(np.uint8)
    return out


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    rgbe = np.asarray(rgbe)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)
    return rgbe[..., :3].astype(np.float64) * scale[..., None]


def write_rgbe(path: str, rgb: np.ndarray) -> None:
    """Write a flat (uncompressed) Radiance .hdr file."""
    h, w = rgb.shape[:2]
    data = float_to_rgbe(rgb)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\n")
        f.write(b"FORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(data.tobytes())


def read_rgbe(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        if not f.readline().startswith(b"#?"):
            raise ValueError("not a Radiance file")
        while True:
            line = f.readline()
            if line in (b"\n", b""):
                break
        dims = f.readline().split()
        h, w = int(dims[1]), int(dims[3])
        raw = f.read(h * w * 4)
        first = np.frombuffer(raw[:4], np.uint8) if raw else None
        data = np.frombuffer(raw, np.uint8)
        if len(data) < h * w * 4:
            raise ValueError("RLE RGBE not supported by this reader")
        return rgbe_to_float(data.reshape(h, w, 4))


# ---------------------------------------------------------------------------
# Minimal OpenEXR (single part, uncompressed)
# ---------------------------------------------------------------------------

_EXR_MAGIC = 20000630
_PIXELTYPE_HALF = 1
_PIXELTYPE_FLOAT = 2


def _attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\0" + typ + b"\0" + struct.pack("<i", len(data)) + data


def write_exr(path: str, rgb: np.ndarray, half: bool = True) -> None:
    """Write an uncompressed scanline EXR with R, G, B channels."""
    rgb = np.asarray(rgb)
    h, w = rgb.shape[:2]
    ptype = _PIXELTYPE_HALF if half else _PIXELTYPE_FLOAT
    np_t = np.float16 if half else np.float32
    psize = 2 if half else 4

    chans = b""
    for name in (b"B", b"G", b"R"):    # alphabetical, EXR requirement
        # name\0 + pixelType(4) + pLinear(1) + reserved(3) + xSamp + ySamp
        chans += (name + b"\0" + struct.pack("<i", ptype)
                  + b"\0" + b"\0\0\0"
                  + struct.pack("<ii", 1, 1))
    chans += b"\0"

    dw = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b""
    header += _attr(b"channels", b"chlist", chans)
    header += _attr(b"compression", b"compression", b"\0")  # NO_COMPRESSION
    header += _attr(b"dataWindow", b"box2i", dw)
    header += _attr(b"displayWindow", b"box2i", dw)
    header += _attr(b"lineOrder", b"lineOrder", b"\0")      # INCREASING_Y
    header += _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _attr(b"screenWindowCenter", b"v2f",
                    struct.pack("<ff", 0.0, 0.0))
    header += _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\0"

    preamble = struct.pack("<ii", _EXR_MAGIC, 2) + header
    offset_table_pos = len(preamble)
    data_start = offset_table_pos + 8 * h

    line_bytes = 8 + 3 * w * psize
    offsets = [data_start + i * line_bytes for i in range(h)]

    with open(path, "wb") as f:
        f.write(preamble)
        f.write(struct.pack(f"<{h}Q", *offsets))
        for y in range(h):
            f.write(struct.pack("<ii", y, 3 * w * psize))
            for ch in (2, 1, 0):       # B, G, R order
                f.write(rgb[y, :, ch].astype(np_t).tobytes())


def read_exr(path: str) -> np.ndarray:
    """Read an uncompressed scanline EXR written by ``write_exr`` (or any
    single-part NO_COMPRESSION RGB file)."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("<ii", f.read(8))
        if magic != _EXR_MAGIC:
            raise ValueError("not an EXR file")
        attrs = {}
        while True:
            name = b""
            while True:
                c = f.read(1)
                if c == b"\0":
                    break
                name += c
            if name == b"":
                break
            typ = b""
            while True:
                c = f.read(1)
                if c == b"\0":
                    break
                typ += c
            size = struct.unpack("<i", f.read(4))[0]
            attrs[name] = (typ, f.read(size))

        x0, y0, x1, y1 = struct.unpack("<iiii", attrs[b"dataWindow"][1])
        w = x1 - x0 + 1
        h = y1 - y0 + 1
        if attrs[b"compression"][1] != b"\0":
            raise ValueError("only NO_COMPRESSION supported")

        # channel list
        chdata = attrs[b"channels"][1]
        chans = []
        i = 0
        while chdata[i] != 0:
            j = chdata.index(0, i)
            nm = chdata[i:j].decode()
            ptype = struct.unpack("<i", chdata[j + 1:j + 5])[0]
            chans.append((nm, ptype))
            i = j + 1 + 16
        np_ts = {1: np.float16, 2: np.float32, 0: np.uint32}

        f.read(8 * h)  # offset table
        out = np.zeros((h, w, len(chans)), np.float32)
        for y in range(h):
            _, nbytes = struct.unpack("<ii", f.read(8))
            for ci, (nm, pt) in enumerate(chans):
                t = np_ts[pt]
                arr = np.frombuffer(f.read(w * np.dtype(t).itemsize), t)
                out[y, :, ci] = arr.astype(np.float32)

    name_order = [c[0] for c in chans]
    if name_order == ["B", "G", "R"]:
        out = out[..., ::-1]
    return out


def write_octave_matrix(stream, name: str, mat, timestamp: str = "") -> None:
    """Octave text-format matrix dump — the reference's debugging exporter
    ``outputMatlabMatrixHeader`` (stereo/calibrate.cpp:274-280) plus the
    row-major value block Octave's ``load`` expects.

    ``timestamp`` replaces the reference's QDateTime string (pass "" for
    reproducible output)."""
    import numpy as np
    mat = np.atleast_2d(np.asarray(mat, np.float64))
    stream.write(f"# Created by StereoReconstruction, {timestamp}\n")
    stream.write(f"# name: {name}\n")
    stream.write("# type: matrix\n")
    stream.write(f"# rows: {mat.shape[0]}\n")
    stream.write(f"# columns: {mat.shape[1]}\n")
    for row in mat:
        stream.write(" " + " ".join(repr(float(v)) for v in row) + "\n")
