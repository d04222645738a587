"""Host-side image loading.

Replaces the reference's Qt ``QImage`` + ``VectorImage`` loading path
(util/vectorimage.cpp, stereo/multiviewstereo.cpp:216-244) with PIL + numpy.

Conventions preserved from the reference:

* pixel values are doubles in [0, 255],
* ``to_gray`` uses the reference's (swapped-coefficient) luma
  ``0.11 r + 0.59 g + 0.3 b`` (util/vectorimage.hpp:60-62) — intentionally
  replicated because it changes every NCC value,
* scaling by ``image_scale`` matches ``QImage::scaledToWidth(w * scale,
  Qt::SmoothTransformation)``: target width truncates, height preserves the
  aspect ratio, smooth (area/bilinear) filtering,
* masks come from the alpha channel of the original image: any pixel not
  fully opaque is masked out (multiviewstereo.cpp:225-234).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

try:
    from PIL import Image
    _HAVE_PIL = True
except ImportError:  # pragma: no cover
    _HAVE_PIL = False


@dataclass
class LoadedImage:
    rgb: np.ndarray            # [H, W, 3] float32/float64 in [0, 255]
    mask: np.ndarray           # [H, W] bool (True = usable, "WHITE")
    scale: float = 1.0


def to_gray(rgb: np.ndarray) -> np.ndarray:
    """Reference luma with swapped r/b coefficients
    (util/vectorimage.hpp:60-62)."""
    return 0.11 * rgb[..., 0] + 0.59 * rgb[..., 1] + 0.3 * rgb[..., 2]


def scaled_size(w: int, h: int, scale: float):
    """Qt scaledToWidth semantics: new width = int(w * scale) (C++ double->int
    truncation), height keeps aspect ratio (rounded)."""
    nw = int(w * scale)
    nh = max(1, round(h * nw / w))
    return nw, nh


def load_image(path: str, image_scale: float = 1.0,
               dtype=np.float32) -> LoadedImage:
    """Load an image + alpha mask, optionally downscaled.

    The mask is taken from the *original-resolution* alpha channel and
    downscaled with nearest filtering (Qt::FastTransformation in
    multiviewstereo.cpp:226), then thresholded at full opacity.
    """
    if not _HAVE_PIL:
        raise RuntimeError("PIL is required for image loading")
    img = Image.open(path)
    has_alpha = img.mode in ("RGBA", "LA", "PA")

    if has_alpha:
        rgba = img.convert("RGBA")
    else:
        rgba = img.convert("RGB")

    w, h = rgba.size
    if image_scale != 1.0:
        nw, nh = scaled_size(w, h, image_scale)
        rgb_img = rgba.convert("RGB").resize((nw, nh), Image.BILINEAR)
        if has_alpha:
            alpha = rgba.getchannel("A").resize((nw, nh), Image.NEAREST)
        else:
            alpha = None
    else:
        rgb_img = rgba.convert("RGB")
        alpha = rgba.getchannel("A") if has_alpha else None

    rgb = np.asarray(rgb_img, dtype=dtype)
    if alpha is not None:
        mask = np.asarray(alpha) == 255
    else:
        mask = np.ones(rgb.shape[:2], dtype=bool)
    return LoadedImage(rgb=rgb, mask=mask, scale=image_scale)

