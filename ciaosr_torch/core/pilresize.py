"""Pillow's bicubic ``Image.resize`` on 8-bit images, in integer numpy.

Counterpart of what the JAX package's ``RandomDownSampling(backend=
"pillow")`` calls (``PIL.Image.resize(size, Image.BICUBIC)``), without
Pillow: its ``ImagingResample`` for 8 bits a channel, step for step, so
the result is Pillow's bit for bit.

- The bicubic filter with a = -0.5, support 2·max(in/out, 1).
- Per output pixel x: center = (x + 0.5)·in/out, the window
  [int(center - support + 0.5), int(center + support + 0.5)) cut to the
  image, taps at (x' - center + 0.5)/filterscale, normalized in double,
  then fixed point with 22 fraction bits, rounded half away from zero.
- Each output channel starts its integer sum at 2^21, adds pixel · tap,
  shifts right by 22 and clips to [0, 255].
- The horizontal pass first, its 8-bit result into the vertical pass; a
  pass whose size does not change is skipped (no change at all: a copy).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def bicubic_filter(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic_filter (a = -0.5), in its order of operations."""
    x = np.abs(x)
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * -0.5
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


@lru_cache(maxsize=256)
def coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's precompute_coeffs and normalize_coeffs_8bpc on one axis:
    (xmin (out,) int64, k (out, ksize) int64 fixed-point taps, zero past
    each window). Cached: callers must not write to them."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C casts truncate towards zero; both bounds are cut to the image
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    x = np.arange(ksize)
    inside = x[None] < xmax[:, None]
    w = np.where(inside, bicubic_filter(
        ((x[None] + xmin[:, None]) - center[:, None] + 0.5)
        * (1.0 / filterscale)), 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):      # Pillow's sum, in tap order
        ww = ww + w[:, j]
    safe = np.where(ww == 0.0, 1.0, ww)[:, None]
    w = np.where(ww[:, None] != 0.0, w / safe, w)
    scaled = w * (1 << PRECISION_BITS)
    k = np.trunc(np.where(w < 0, scaled - 0.5, scaled + 0.5))
    return xmin, k.astype(np.int64)


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass of ImagingResample{Horizontal,Vertical}_8bpc along
    ``axis`` of an (H, W, C) uint8 image."""
    in_size = img.shape[axis]
    xmin, k = coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)   # (in, ..., C)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None],
                     in_size - 1)                      # zero taps past it
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int64)
    for j in range(k.shape[1]):
        tap = k[:, j].reshape((out_size,) + (1,) * (src.ndim - 1))
        acc += src[idx[:, j]] * tap
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``PIL.Image.fromarray(img).resize((out_w, out_h), Image.BICUBIC)``
    as an array: img (H, W) or (H, W, C) uint8."""
    if img.dtype != np.uint8:
        raise ValueError(f"resize_bicubic takes uint8 images, got "
                         f"{img.dtype}")
    if min(out_h, out_w) < 1:
        raise ValueError(f"output size {out_h} x {out_w}")
    x = img[..., None] if img.ndim == 2 else img
    if out_w != x.shape[1]:
        x = _pass(x, out_w, 1)
    if out_h != x.shape[0]:
        x = _pass(x, out_h, 0)
    x = np.array(x)    # a copy where no pass ran, as Pillow's
    return x[..., 0] if img.ndim == 2 else x
