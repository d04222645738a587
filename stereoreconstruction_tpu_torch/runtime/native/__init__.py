"""The port's native (C++) runtime: the task pool of ``taskpool.cpp``, built
with g++ at first use (``build.py``)."""

from .build import build_native, load_library

__all__ = ["build_native", "load_library"]
