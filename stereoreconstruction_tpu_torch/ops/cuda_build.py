"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``.cu`` source has a plain C interface and compiles with ``nvcc`` into
its own shared library, loaded with ``ctypes``.  The build runs at first use
into ``build/cuda/`` beside the package (listed in ``.gitignore``), one
``nvcc`` per source, all started together; a library is keyed by a hash of
its source and flags, so an edited source rebuilds and an unchanged one is
reused.

Flags: ``sm_90a`` (Hopper) and ``--fmad=false``: without contraction every
``a*b+c`` rounds twice, as in the kernels' plain PyTorch versions, so kernel
and plain version compute the same float32 values.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent.parent / "build" / "cuda"
SOURCES = ("geodesic_weights", "mvs_sweep")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _target(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return _BUILD / f"lib{name}-{key[:16]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile (in parallel) and load every kernel library not loaded yet.
    Raises with nvcc's output if a source does not compile."""
    todo = [n for n in SOURCES if n not in _libs]
    if not todo:
        return _libs
    _BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(_CSRC / f"{name}.cu")]
        procs.append((name, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, out, proc in procs:
        log = proc.communicate()[0]
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for name in todo:
        _libs[name] = ctypes.CDLL(str(_target(name)))
    return _libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    if name not in _libs:
        build_all()
    return _libs[name]
