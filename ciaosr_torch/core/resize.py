"""MATLAB-exact bicubic resize, as a gather + matmul per axis.

Counterpart of ciaosr_tpu/core/resize.py (``cubic_kernel``,
``resize_table``, ``imresize_np``, and ``imresize_torch``, the twin of
``imresize_jnp``: the same tables applied to a tensor on its own
device): the cubic kernel with a = -0.5, the
kernel widened by 1/scale on downscale (antialiasing), per-row weight
normalization and symmetric (edge-inclusive mirror) boundaries. An
(out, P) index / weight table per axis is applied as one gather and one
einsum in float64. ``imresize_np`` takes the native C++ library of the
same numerics (``data/native.py``) unless ``CIAOSR_NATIVE=0``, the
switch the JAX package reads.
"""

from __future__ import annotations

import math
import os
from functools import lru_cache

import numpy as np
import torch


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
    ``scale`` (output = ceil(in * scale)). Returns float32. By default the
    native library resizes a float32 copy of the image, as the JAX
    package's ``imresize_np`` does; ``CIAOSR_NATIVE=0`` takes the numpy
    path (the two agree within 1e-6).
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
    if os.environ.get("CIAOSR_NATIVE", "1") != "0":
        from ciaosr_torch.data.native import bicubic_resize
        out = bicubic_resize(img.astype(np.float32), out_h, out_w,
                             float(scale), antialiasing)
        return out[..., 0] if squeeze else out
    idx_h, w_h = resize_table(in_h, out_h, float(scale), antialiasing)
    idx_w, w_w = resize_table(in_w, out_w, float(scale), antialiasing)
    out = _apply_axis_np(img.astype(np.float64), idx_h, w_h, axis=0)
    out = _apply_axis_np(out, idx_w, w_w, axis=1)
    out = out.astype(np.float32)
    if squeeze:
        out = out[..., 0]
    return out


def imresize_torch(img: torch.Tensor, size, scale: float,
                   antialiasing: bool = True) -> torch.Tensor:
    """MATLAB bicubic of an (..., H, W, C) float tensor to ``size`` =
    (out_h, out_w), on the tensor's own device: the tables of
    ``resize_table``, uploaded as f32, applied as one gather and one
    einsum per axis."""
    *lead, in_h, in_w, c = img.shape
    out_h, out_w = size
    idx_h, w_h = resize_table(in_h, out_h, float(scale), antialiasing)
    idx_w, w_w = resize_table(in_w, out_w, float(scale), antialiasing)
    dt = torch.promote_types(img.dtype, torch.float32)
    img = img.to(dt)
    w_h = torch.as_tensor(w_h, dtype=torch.float32, device=img.device).to(dt)
    w_w = torch.as_tensor(w_w, dtype=torch.float32, device=img.device).to(dt)
    g = img.index_select(-3, torch.as_tensor(
        idx_h.ravel(), dtype=torch.long, device=img.device))
    g = g.reshape(*lead, *idx_h.shape, in_w, c)     # (..., out_h, P, W, C)
    out = torch.einsum("op,...opwc->...owc", w_h, g)
    g = out.index_select(-2, torch.as_tensor(
        idx_w.ravel(), dtype=torch.long, device=img.device))
    g = g.reshape(*lead, out_h, *idx_w.shape, c)    # (..., out_h, out_w, P, C)
    return torch.einsum("op,...hopc->...hoc", w_w, g)
