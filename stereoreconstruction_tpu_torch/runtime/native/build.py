"""Build and load the port's native libraries: the task pool
(``taskpool.cpp``) and the reference-style two-view oracle
(``twoview_oracle.cpp``, the JAX package's source byte for byte).

Each source compiles with g++ at first use into ``build/native/`` beside
the package (listed in ``.gitignore``): the pool with ``-O3 -fopenmp
-shared -fPIC -std=c++17``, the oracle with the JAX package's flags for it
(``-march=native`` added: g++ then contracts multiply-adds into FMAs, and
the oracle's values equal the JAX package's build bit for bit).  A library
is keyed by a hash of its source and flags, and for ``-march=native`` of
the CPU g++ resolves it to, so an edited source, or a build directory
copied to another machine, rebuilds and an unchanged one is reused; it is
written under a temporary name and renamed, so processes that build at
once do not clash.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

_DIR = Path(__file__).resolve().parent
_BUILD = Path(__file__).resolve().parents[3] / "build" / "native"
GXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")
# each library: (source, g++ flags)
LIBRARIES = {
    "taskpool": ("taskpool.cpp", GXX_FLAGS),
    "twoview_oracle": ("twoview_oracle.cpp",
                       ("-O3", "-march=native") + GXX_FLAGS[1:]),
}

_loaded = {}


@functools.lru_cache(maxsize=None)
def _native_arch() -> str:
    """The CPU that ``-march=native`` names on this machine (g++'s resolved
    ``-march=``)."""
    res = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, check=True)
    return " ".join(ln.split()[-1] for ln in res.stdout.splitlines()
                    if ln.split()[:1] == ["-march="] and len(ln.split()) > 1)


def _target(name: str) -> Path:
    src, flags = LIBRARIES[name]
    tag = " ".join(flags)
    if "-march=native" in flags:
        tag += " " + _native_arch()
    key = hashlib.sha256((_DIR / src).read_bytes()
                         + tag.encode()).hexdigest()
    return _BUILD / f"libsrtpu_{name}-{key[:16]}.so"


def build_native(name: str = "taskpool") -> str:
    """The path of the built library ``name`` (a key of ``LIBRARIES``),
    compiling it first if needed.  Raises with g++'s output if the source
    does not compile."""
    out = _target(name)
    if out.exists():
        return str(out)
    src, flags = LIBRARIES[name]
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run(["g++", *flags, "-o", str(tmp), str(_DIR / src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {src}:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return str(out)


def load_library(name: str = "taskpool") -> ctypes.CDLL:
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build_native(name))
    return _loaded[name]
