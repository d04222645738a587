"""ctypes bindings of the reference-style native oracle
(``twoview_oracle.cpp``): the CPU baseline of the two-view and multi-view
engines and the float64 oracle of the geodesic weights.

Port of ``stereoreconstruction_tpu/runtime/native/bindings.py``; numpy in,
numpy out.  Cameras are the port's (``geometry.camera.Camera``, tensors on
any device), packed in the oracle's 43-double layout.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .build import load_library

_c_d = ctypes.c_double
_c_i = ctypes.c_int
_p_f = ctypes.POINTER(ctypes.c_float)
_p_u8 = ctypes.POINTER(ctypes.c_uint8)
_p_d = ctypes.POINTER(_c_d)
_p_i = ctypes.POINTER(_c_i)
# each entry point's arguments (twoview_oracle.cpp's extern "C" block)
_ARGTYPES = {
    "twoview_depth_map": [_p_f, _p_u8, _p_f, _p_u8, _c_i, _c_i, _p_d, _p_d,
                          _c_d, _c_d, _c_i, _c_d, _c_i, _c_d, _c_i, _c_d,
                          _c_d, _c_d, _p_d],
    "geodesic_weights_image": [_p_f, _c_i, _c_i, _c_i, _c_d, _c_i, _p_d],
    "oracle_num_threads": [],
    "mvs_depth_maps_native": [_p_f, _p_u8, _c_i, _c_i, _c_i, _p_d, _p_i,
                              _c_i, _c_d, _c_d, _c_i, _c_d, _c_i, _c_d,
                              _c_i, _c_d, _c_d, _c_i, _p_d],
}


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _fn(name: str):
    """The oracle's entry point ``name``, its argument and result types
    declared."""
    fn = getattr(load_library("twoview_oracle"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = _c_i if name == "oracle_num_threads" else None
    return fn


def _camera_params(cam) -> np.ndarray:
    """Pack a Camera into the 43-double native layout: K, Kinv, R, t, C,
    dist, plane_normal, plane_dist, refr_index."""
    return np.concatenate([
        np.atleast_1d(f.detach().cpu().numpy().astype(np.float64)).ravel()
        for f in (cam.K, cam.Kinv, cam.R, cam.t, cam.C, cam.dist,
                  cam.plane_normal, cam.plane_dist, cam.refr_index)])


def twoview_depth_map_native(rgb_ref, mask_ref, rgb_oth, mask_oth,
                             cam_ref, cam_oth, cfg) -> np.ndarray:
    """Reference-style CPU depth map of the reference view (OpenMP rows),
    without the cross-check — the bench baseline.  Returns [H, W]
    float64 with the engine's sentinels."""
    fn = _fn("twoview_depth_map")
    rgb_ref = np.ascontiguousarray(rgb_ref, np.float32)
    rgb_oth = np.ascontiguousarray(rgb_oth, np.float32)
    mask_ref = np.ascontiguousarray(mask_ref, np.uint8)
    mask_oth = np.ascontiguousarray(mask_oth, np.uint8)
    h, w = rgb_ref.shape[:2]
    out = np.empty((h, w), np.float64)
    p_ref = _camera_params(cam_ref)
    p_oth = _camera_params(cam_oth)
    fn(_ptr(rgb_ref, ctypes.c_float), _ptr(mask_ref, ctypes.c_uint8),
       _ptr(rgb_oth, ctypes.c_float), _ptr(mask_oth, ctypes.c_uint8),
       _c_i(h), _c_i(w), _ptr(p_ref, _c_d), _ptr(p_oth, _c_d),
       _c_d(cfg.min_depth), _c_d(cfg.max_depth), _c_i(cfg.num_depth_levels),
       _c_d(cfg.image_scale), _c_i(cfg.window_radius),
       _c_d(cfg.weights.geodesic_sigma), _c_i(cfg.weights.geodesic_iters),
       _c_d(cfg.max_color_diff), _c_d(cfg.bad_ret),
       _c_d(cfg.second_best_factor), _ptr(out, _c_d))
    return out


def geodesic_weights_native(rgb, radius: int, sigma: float = 50.0,
                            iters: int = 3) -> np.ndarray:
    """Whole-image float64 geodesic support weights (geodesicweight.cpp:
    59-135 semantics): rgb [H, W, 3] -> weights [S, S, H, W] float64."""
    fn = _fn("geodesic_weights_image")
    rgb = np.ascontiguousarray(rgb, np.float32)
    h, w = rgb.shape[:2]
    size = 2 * radius + 1
    out = np.empty((size * size, h, w), np.float64)
    fn(_ptr(rgb, ctypes.c_float), _c_i(h), _c_i(w), _c_i(radius),
       _c_d(sigma), _c_i(iters), _ptr(out, _c_d))
    return out.reshape(size, size, h, w)


def native_num_threads() -> int:
    return int(_fn("oracle_num_threads")())


def mvs_depth_maps_native(rgbs, masks, cams, neighbours, cfg,
                          cross_check: bool = True) -> np.ndarray:
    """Reference-style CPU MVS depth maps (Campbell 2009; OpenMP rows) —
    the MVS baseline.

    rgbs [V, H, W, 3]; masks [V, H, W]; cams: the port's Cameras;
    neighbours: per-view index lists (stereo.multiview.select_neighbours).
    Returns depths [V, H, W] float64 (inf = masked, -1 = no peak, NaN =
    failed cross-check — the reference's sentinels)."""
    fn = _fn("mvs_depth_maps_native")
    rgbs = np.ascontiguousarray(rgbs, np.float32)
    masks = np.ascontiguousarray(masks, np.uint8)
    v, h, w = rgbs.shape[:3]
    params = np.ascontiguousarray(
        np.stack([_camera_params(c) for c in cams]))
    max_nbr = max((len(n) for n in neighbours), default=1)
    nbr = np.full((v, max_nbr), -1, np.int32)
    for i, n in enumerate(neighbours):
        nbr[i, :len(n)] = n
    out = np.empty((v, h, w), np.float64)
    fn(_ptr(rgbs, ctypes.c_float), _ptr(masks, ctypes.c_uint8),
       _c_i(v), _c_i(h), _c_i(w), _ptr(params, _c_d),
       _ptr(nbr, _c_i), _c_i(max_nbr),
       _c_d(cfg.min_depth), _c_d(cfg.max_depth), _c_i(cfg.num_depth_levels),
       _c_d(cfg.image_scale), _c_i(cfg.window_radius),
       _c_d(cfg.weights.geodesic_sigma), _c_i(cfg.weights.geodesic_iters),
       _c_d(cfg.ncc_threshold), _c_d(cfg.cross_check_threshold),
       _c_i(1 if cross_check else 0), _ptr(out, _c_d))
    return out
