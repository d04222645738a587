"""Build and load the native task pool (``taskpool.cpp``).

The port's own copy of the JAX package's pool source compiles with
``g++ -O3 -fopenmp -shared -fPIC -std=c++17`` at first use into
``build/native/`` beside the package (listed in ``.gitignore``).  The
library is keyed by a hash of its source and flags, so an edited source
rebuilds and an unchanged one is reused; it is written under a temporary
name and renamed, so processes that build at once do not clash.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "taskpool.cpp"
_BUILD = Path(__file__).resolve().parents[3] / "build" / "native"
GXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")

_loaded = None


def _target() -> Path:
    key = hashlib.sha256(_SRC.read_bytes()
                         + " ".join(GXX_FLAGS).encode()).hexdigest()
    return _BUILD / f"libsrtpu_taskpool-{key[:16]}.so"


def build_native() -> str:
    """The path of the built library, compiling it first if needed.  Raises
    with g++'s output if the source does not compile."""
    out = _target()
    if out.exists():
        return str(out)
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {_SRC.name}:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return str(out)


def load_library() -> ctypes.CDLL:
    global _loaded
    if _loaded is None:
        _loaded = ctypes.CDLL(build_native())
    return _loaded
