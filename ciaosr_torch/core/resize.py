"""MATLAB-exact bicubic resize (numpy), as a gather + matmul per axis.

Counterpart of ciaosr_tpu/core/resize.py (``cubic_kernel``,
``resize_table``, ``imresize_np``): the cubic kernel with a = -0.5, the
kernel widened by 1/scale on downscale (antialiasing), per-row weight
normalization and symmetric (edge-inclusive mirror) boundaries. An
(out, P) index / weight table per axis is applied as one gather and one
einsum in float64. The JAX package's C++ fast path gives the same
numbers; this module has only the numpy path.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


def cubic_kernel(x: np.ndarray) -> np.ndarray:
    """Keys cubic convolution kernel with a = -0.5 (MATLAB 'bicubic')."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    f = (1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1.0)
    f = f + (-0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0) * ((ax > 1.0) & (ax <= 2.0))
    return f


@lru_cache(maxsize=256)
def resize_table(in_length: int, out_length: int, scale: float,
                 antialiasing: bool = True):
    """Per-axis (indices, weights) for MATLAB bicubic resampling:
    indices (out, P) int32 source rows, mirrored into range; weights
    (out, P) float64, rows summing to 1. The arrays are cached: callers
    must not write to them."""
    kernel_width = 4.0
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale

    x = np.arange(1, out_length + 1, dtype=np.float64)
    # inverse mapping: 0.5 in output space -> 0.5 in input space
    u = x / scale + 0.5 * (1.0 - 1.0 / scale)
    left = np.floor(u - kernel_width / 2.0)
    p = int(math.ceil(kernel_width)) + 2

    indices = left[:, None] + np.arange(p, dtype=np.float64)[None, :]
    dist = u[:, None] - indices
    if scale < 1 and antialiasing:
        weights = scale * cubic_kernel(dist * scale)
    else:
        weights = cubic_kernel(dist)
    weights = weights / weights.sum(axis=1, keepdims=True)

    idx = indices.astype(np.int64) - 1  # to 0-based
    # symmetric (mirror, edge-inclusive) boundary: -1 -> 0, -2 -> 1, n -> n-1
    idx = np.where(idx < 0, -1 - idx, idx)
    idx = np.where(idx >= in_length, 2 * in_length - 1 - idx, idx)
    idx = np.clip(idx, 0, in_length - 1)
    return idx.astype(np.int32), weights


def _apply_axis_np(img: np.ndarray, idx: np.ndarray, w: np.ndarray,
                   axis: int) -> np.ndarray:
    moved = np.moveaxis(img, axis, 0)          # (in, ...)
    gathered = moved[idx]                       # (out, P, ...)
    out = np.einsum("op,op...->o...", w, gathered.astype(np.float64))
    return np.moveaxis(out, 0, axis)


def imresize_np(img: np.ndarray, size=None, scale: float | None = None,
                antialiasing: bool = True) -> np.ndarray:
    """Resize an HWC (or HW) float image with MATLAB bicubic semantics.

    Either ``size=(out_h, out_w)`` with an explicit ``scale`` factor, or just
    ``scale`` (output = ceil(in * scale)). Returns float32.
    """
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    in_h, in_w = img.shape[:2]
    if size is None:
        if scale is None:
            raise ValueError("imresize_np needs size or scale")
        out_h, out_w = math.ceil(in_h * scale), math.ceil(in_w * scale)
    else:
        out_h, out_w = size
        if scale is None:
            scale = out_h / in_h
    idx_h, w_h = resize_table(in_h, out_h, float(scale), antialiasing)
    idx_w, w_w = resize_table(in_w, out_w, float(scale), antialiasing)
    out = _apply_axis_np(img.astype(np.float64), idx_h, w_h, axis=0)
    out = _apply_axis_np(out, idx_w, w_w, axis=1)
    out = out.astype(np.float32)
    if squeeze:
        out = out[..., 0]
    return out
