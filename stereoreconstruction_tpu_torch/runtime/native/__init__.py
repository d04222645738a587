"""The port's native (C++) runtime, built with g++ at first use
(``build.py``): the task pool of ``taskpool.cpp`` and the reference-style
oracle of ``twoview_oracle.cpp`` (``bindings.py``)."""

from .bindings import (geodesic_weights_native, mvs_depth_maps_native,
                       native_num_threads, twoview_depth_map_native)
from .build import build_native, load_library

__all__ = ["build_native", "load_library", "twoview_depth_map_native",
           "native_num_threads", "mvs_depth_maps_native",
           "geodesic_weights_native"]
