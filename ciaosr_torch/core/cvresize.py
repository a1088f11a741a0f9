"""OpenCV-exact ``cv2.resize`` on float images (numpy), without OpenCV.

``resize(img, (h, w), interp)`` gives ``cv2.resize(img, (w, h),
interpolation=...)`` for float32 / float64 images of shape (H, W) or
(H, W, C), to float rounding (the weights are cv2's, computed in the
precision cv2 computes them in; the sums run in float64). Modes:

* ``bilinear`` (INTER_LINEAR): half-pixel centres, edges replicated;
* ``bicubic`` (INTER_CUBIC): Keys' cubic with A = −0.75, edges replicated;
* ``lanczos`` (INTER_LANCZOS4): an 8-tap Lanczos window, cv2's weights;
* ``area`` (INTER_AREA): when neither axis grows, the source cells'
  covered fractions (an integer factor is the block mean); when one axis
  grows (mixed cases too), cv2's own linear variant on both axes, whose
  taps and weights come from the cell edges, not the centres.

A uint8 image is taken in the bicubic mode only: cv2 (OpenCV 5) gives
there the float32 result rounded to the nearest level. An unchanged size
is a copy. As cv2 does, a trailing channel of 1 comes
back dropped. Each axis is a table of (source index, weight) pairs per
output pixel, applied as a gather and a weighted sum: no BLAS, no
threads, safe in forked loader workers.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

MODES = ("bilinear", "bicubic", "area", "lanczos")

_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0),
               (_S45, _S45), (0, -1), (-_S45, _S45))


def _cubic_weights(x: np.ndarray) -> np.ndarray:
    """cv2's interpolateCubic, in the dtype of ``x``."""
    t = x.dtype.type
    a, one = t(-0.75), t(1)
    c0 = ((a * (x + one) - t(5) * a) * (x + one) + t(8) * a) * (x + one) \
        - t(4) * a
    c1 = ((a + t(2)) * x - (a + t(3))) * x * x + one
    y = one - x
    c2 = ((a + t(2)) * y - (a + t(3))) * y * y + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=1)


def _lanczos_weights(fx: np.ndarray) -> np.ndarray:
    """cv2's interpolateLanczos4: sin-based taps, 1e30 where a tap sits on
    the sample, normalised in float32."""
    x = fx.astype(np.float32).astype(np.float64)
    y0 = -(x + 3) * math.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    out = np.empty((len(x), 8), np.float32)
    total = np.zeros(len(x), np.float32)
    for i, (cs0, cs1) in enumerate(_LANCZOS_CS):
        yi = (x.astype(np.float32) + np.float32(3 - i))
        y = -yi.astype(np.float64) * math.pi * 0.25
        with np.errstate(divide="ignore", invalid="ignore"):
            c = ((cs0 * s0 + cs1 * c0) / (y * y)).astype(np.float32)
        c = np.where(np.abs(yi) >= np.float32(1e-6), c, np.float32(1e30))
        out[:, i] = c
        total = total + c
    return out * (np.float32(1) / total)[:, None]


def _interp_table(n_in: int, n_out: int, mode: str, coef: type):
    """(idx, w) of the cv2 interpolation modes (and area's linear
    variant), one row per output pixel; the source position and the
    weights are computed in ``coef`` (float32 or float64)."""
    inv_scale = n_out / n_in
    scale = 1.0 / inv_scale
    d = np.arange(n_out, dtype=np.float64)
    if mode == "area":                     # cv2's area_mode
        sx = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (sx + 1) * inv_scale).astype(coef)
        f = np.where(f <= 0, coef(0), f - np.floor(f))
    else:
        f = ((d + 0.5) * scale - 0.5).astype(coef)
        sx = np.floor(f).astype(np.int64)
        f = f - sx.astype(coef)
    if mode == "bicubic":
        w, k2 = _cubic_weights(f), 2
    elif mode == "lanczos":
        w, k2 = _lanczos_weights(f), 4
    else:                                  # bilinear and area's variant
        w, k2 = np.stack([coef(1) - f, f], axis=1), 1
    taps = w.shape[1]
    idx = sx[:, None] - k2 + 1 + np.arange(taps)[None, :]
    return np.clip(idx, 0, n_in - 1), w.astype(np.float64)


def _area_table(n_in: int, n_out: int):
    """cv2's computeResizeAreaTab: the fraction of each source cell a
    target cell covers, over the target cell's width."""
    scale = 1.0 / (n_out / n_in)
    rows = []
    for dx in range(n_out):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, n_in - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, n_in - 1)
        sx1 = min(sx1, sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, float(np.float32((sx1 - fsx1) / cell))))
        for sx in range(sx1, sx2):
            row.append((sx, float(np.float32(1.0 / cell))))
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, float(np.float32(
                min(min(fsx2 - sx2, 1.0), cell) / cell))))
        rows.append(row)
    taps = max(len(r) for r in rows)
    idx = np.zeros((n_out, taps), np.int64)
    w = np.zeros((n_out, taps), np.float64)
    for i, row in enumerate(rows):
        for j, (s, a) in enumerate(row):
            idx[i, j], w[i, j] = s, a
    return idx, w


def _coef_dtype(mode: str, img_dtype) -> type:
    """The precision of cv2's (OpenCV 5) weights, found against it: the
    linear mode computes them in float64, the cubic mode in float64 for a
    float32 image and in float32 for a float64 one, the others in
    float32."""
    if mode == "bilinear" or (mode == "bicubic" and img_dtype == np.float32):
        return np.float64
    return np.float32


@lru_cache(maxsize=512)
def resize_tables(in_hw: tuple, out_hw: tuple, mode: str,
                  img_dtype=np.float32):
    """Per-axis (idx, w) tables of ``resize`` (cached: read-only)."""
    (h, w), (oh, ow) = in_hw, out_hw
    if mode == "area" and oh <= h and ow <= w:
        return _area_table(h, oh), _area_table(w, ow)
    coef = _coef_dtype(mode, np.dtype(img_dtype))
    return (_interp_table(h, oh, mode, coef),
            _interp_table(w, ow, mode, coef))


def _apply(x: np.ndarray, idx: np.ndarray, w: np.ndarray, axis: int):
    x = np.moveaxis(x, axis, 0)
    shape = (len(idx),) + (1,) * (x.ndim - 1)
    out = np.zeros((len(idx),) + x.shape[1:], np.float64)
    for p in range(idx.shape[1]):
        out += w[:, p].reshape(shape) * x[idx[:, p]]
    return np.moveaxis(out, 0, axis)


def resize(img: np.ndarray, size, interp: str) -> np.ndarray:
    """``cv2.resize(img, (size[1], size[0]), interpolation=interp)``."""
    if interp not in MODES:
        raise ValueError(f"interp must be one of {MODES}, got {interp!r}")
    img = np.asarray(img)
    if img.dtype == np.uint8:
        if interp != "bicubic":
            raise TypeError(f"resize takes uint8 only for 'bicubic' (cv2 "
                            f"resizes 8-bit images in fixed point in the "
                            f"other modes), got {interp!r}")
        out = resize(img.astype(np.float32), size, interp)
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    if img.dtype not in (np.float32, np.float64):
        raise TypeError(f"resize takes float32 or float64, got {img.dtype}")
    if img.ndim not in (2, 3):
        raise ValueError(f"resize takes (H, W) or (H, W, C), got "
                         f"{img.shape}")
    oh, ow = int(size[0]), int(size[1])
    if oh <= 0 or ow <= 0:
        raise ValueError(f"output size must be positive, got {(oh, ow)}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    h, w = img.shape[:2]
    if (oh, ow) == (h, w):
        return img.copy()
    (iy, wy), (ix, wx) = resize_tables((h, w), (oh, ow), interp,
                                         img.dtype.type)
    x = img.astype(np.float64)
    if oh * w < h * ow:        # the smaller intermediate first
        out = _apply(_apply(x, iy, wy, axis=0), ix, wx, axis=1)
    else:
        out = _apply(_apply(x, ix, wx, axis=1), iy, wy, axis=0)
    return out.astype(img.dtype)
