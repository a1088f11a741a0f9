"""Color conversions and tensor→image rounding semantics (numpy).

Transcribed from ciaosr_tpu/core/color.py: mmcv ``bgr2ycbcr(y_only=True)``
as the eval protocol uses it, its inverse ``ycbcr2rgb``, and mmedit
``tensor2img``. ITU-R BT.601 with
TV range: Y = 65.481 R + 128.553 G + 24.966 B + 16 for inputs in [0, 1].
"""

from __future__ import annotations

import numpy as np

_Y_RGB = np.array([65.481, 128.553, 24.966], dtype=np.float64)
_YCBCR_RGB = np.array(
    [[65.481, -37.797, 112.0],
     [128.553, -74.203, -93.786],
     [24.966, 112.0, -18.214]], dtype=np.float64)
_YCBCR_BIAS = np.array([16.0, 128.0, 128.0], dtype=np.float64)


def rgb2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """RGB → YCbCr: float [0, 1] in → float [0, 1] out; uint8 in → float
    in the [16, 235] range."""
    is_uint8 = img.dtype == np.uint8
    img = img.astype(np.float64)
    if not is_uint8:
        img = img * 255.0
    if y_only:
        out = (img @ _Y_RGB) / 255.0 + 16.0
    else:
        out = (img @ _YCBCR_RGB) / 255.0 + _YCBCR_BIAS
    if not is_uint8:
        out = out / 255.0
    return out.astype(np.float32)


def bgr2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """BGR variant (channel-reversed input)."""
    return rgb2ycbcr(np.ascontiguousarray(img[..., ::-1]), y_only=y_only)


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    """YCbCr → RGB for float input in [0, 1], as the JAX package computes
    it: with the inverse of the forward matrix's transpose, which is not
    the inverse of :func:`rgb2ycbcr` (mmcv's ``ycbcr2rgb`` is); no metric
    calls it."""
    img = img.astype(np.float64) * 255.0
    inv = np.linalg.inv(_YCBCR_RGB.T) * 255.0
    out = (img - _YCBCR_BIAS) @ inv
    return (out / 255.0).astype(np.float32)


def tensor2img(arr: np.ndarray, out_type=np.uint8, min_max=(0.0, 1.0),
               bgr: bool = True) -> np.ndarray:
    """Float HWC RGB image → uint8 BGR with mmedit's clamp, rescale and
    rounding (the metrics consume uint8)."""
    arr = np.clip(np.asarray(arr, dtype=np.float32), min_max[0], min_max[1])
    arr = (arr - min_max[0]) / (min_max[1] - min_max[0])
    if bgr and arr.ndim == 3 and arr.shape[-1] == 3:
        arr = arr[..., ::-1]
    if out_type == np.uint8:
        arr = (arr * 255.0).round()
    return arr.astype(out_type)
