"""``cv2.resize`` on numpy, for the three calls of the laptop path.

The card has no ``cv2``.  The segmenter's crop and its training labels go
through ``cv2.resize`` in the JAX package (``eval/nocs_inference.py``,
``data/laptop_aux.py``); these functions give what it gives:

- :func:`resize_linear` is ``INTER_LINEAR``: half-pixel centres, the source
  coordinate ``(d + 0.5) * src / dst - 0.5`` (float64 for a float image,
  float32 for a uint8 one), its fraction in float32 and cut to 0 where it
  falls before the first or past the last column (rows are clipped instead, with their fraction kept), and no
  antialiasing on a downscale.  float32 images are blended in float32;
  uint8 images with 11-bit fixed-point weights, their horizontal sums
  exact in int32, the vertical blend rounded as OpenCV's SIMD path rounds
  it (each row's sum shifted right by 4, multiplied by its weight and
  shifted right by 16, the two added and rounded off by 2 bits).
- :func:`resize_nearest` is ``INTER_NEAREST``: source index
  ``floor(d * src / dst)``, clamped to ``src - 1``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_COEF_SCALE = 2048  # INTER_RESIZE_COEF_SCALE: 11-bit weights


def _linear_taps(src: int, dst: int, clamp_fraction: bool, fixed: bool):
    """Source index and float32 fraction of each destination pixel, as
    OpenCV computes them: for a float image from the float64 coordinate,
    for a uint8 image from the coordinate rounded to float32.  With
    ``clamp_fraction`` (the columns) a source index before 0 or at or past
    ``src - 1`` is clamped with fraction 0."""
    f = (np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5
    if fixed:
        f = f.astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f.astype(np.float32) - s.astype(np.float32) if fixed else (f - s).astype(np.float32)
    if clamp_fraction:
        edge = (s < 0) | (s >= src - 1)
        f[edge] = 0
        s = np.clip(s, 0, src - 1)
    return s, f


def _weights(f: np.ndarray, fixed: bool):
    w0, w1 = np.float32(1) - f, f
    if fixed:
        return (np.rint(w0 * np.float32(_COEF_SCALE)).astype(np.int64),
                np.rint(w1 * np.float32(_COEF_SCALE)).astype(np.int64))
    return w0, w1


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size)`` (``INTER_LINEAR``) of a float32 or uint8
    image [H, W] or [H, W, C]; ``size`` is (width, height), as cv2 takes it."""
    if img.dtype not in (np.float32, np.uint8):
        raise TypeError(f"resize_linear takes float32 or uint8, not {img.dtype}")
    fixed = img.dtype == np.uint8
    dw, dh = size
    h, w = img.shape[:2]
    xs, fx = _linear_taps(w, dw, True, fixed)
    ys, fy = _linear_taps(h, dh, False, fixed)
    a0, a1 = _weights(fx, fixed)
    b0, b1 = _weights(fy, fixed)
    src = img.astype(np.int64) if fixed else img
    extra = (None,) * (img.ndim - 2)
    a0, a1 = a0[(slice(None),) + extra], a1[(slice(None),) + extra]
    # a clamped column has fraction 0: its second tap adds nothing
    hsum = src[:, xs] * a0 + src[:, np.minimum(xs + 1, w - 1)] * a1
    r0, r1 = np.clip(ys, 0, h - 1), np.clip(ys + 1, 0, h - 1)
    b0, b1 = b0[(slice(None), None) + extra], b1[(slice(None), None) + extra]
    if not fixed:
        return hsum[r0] * b0 + hsum[r1] * b1
    out = ((((hsum[r0] >> 4) * b0) >> 16) + (((hsum[r1] >> 4) * b1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)``; ``size``
    is (width, height)."""
    dw, dh = size
    h, w = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / w))).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / h))).astype(np.int64), h - 1)
    return img[ys[:, None], xs[None, :]]
