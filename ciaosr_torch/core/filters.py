"""OpenCV-exact host filters (numpy / scipy), without OpenCV.

``filter2d`` is ``cv2.filter2D(img, -1, kernel)``: a correlation (not a
convolution) anchored at the kernel's centre (``ksize // 2`` on an even
axis), with reflect-101 borders (``gfedcb|abcdefgh|gfedcba``, repeated
for images smaller than the kernel's reach) or, with
``border="replicate"``, cv2's BORDER_REPLICATE (``aaa|abcdefgh|hhh``).
It computes in float64 on the kernel cv2 would use (rounded to float32
for a float32 image) and returns the image's dtype, the trailing channel
of 1 dropped as cv2 drops it. Three routes, by the kernel's shape and
size:

* an outer product (USM's 51² Gaussian ``k @ k.T``): two 1-D passes
  (reflect-101 only);
* a small kernel (≤ ``DIRECT_TAPS`` taps): a direct correlation;
* a larger one (the blur zoo's kernels, up to 21²): an FFT product over
  the padded image.

The crossover is where the two routes took the same time on a 400² RGB
image (7²: about 19 ms each on one core; at 9² the FFT was 1.4× faster).
scipy.ndimage and scipy.fft run single-threaded here, so the ops are safe
in forked loader workers.

``gaussian_kernel_1d`` is ``cv2.getGaussianKernel(ksize, sigma)`` (float64,
OpenCV's bit-exact variant: its fixed tables for σ ≤ 0 at ksize 1-9 and
its centre values of 1 for even sizes), and ``rgb2gray`` is
``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` on float32 images, bit for bit
(the Poisson noise's draws depend on its last bit); ``bgr2gray`` is
``COLOR_BGR2GRAY`` (NIQE's gray conversion), bit for bit.
"""

from __future__ import annotations

import numpy as np

# kernels with more taps than this take the FFT route (when not separable)
DIRECT_TAPS = 49

# cv2's fixed σ ≤ 0 kernels (getGaussianKernelBitExact)
_FIXED_GAUSSIAN = {
    1: (1.0,),
    3: (0.25, 0.5, 0.25),
    5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
    7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
    9: (0.015625, 0.05078125, 0.1171875, 0.19921875, 0.234375, 0.19921875,
        0.1171875, 0.05078125, 0.015625),
}


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """(ksize, 1) float64, ``cv2.getGaussianKernel(ksize, sigma)``."""
    n = int(ksize)
    if n < 1:
        raise ValueError(f"ksize must be positive, got {ksize}")
    if sigma <= 0 and n in _FIXED_GAUSSIAN:
        return np.asarray(_FIXED_GAUSSIAN[n], np.float64)[:, None]
    s = float(sigma) if sigma > 0 else ((n - 1) * 0.5 - 1) * 0.3 + 0.8
    scale2x = -0.125 / (s * s)
    half = (n - 1) // 2
    # x runs over 2·(i − (n − 1)/2) for the outer taps; cv2 gives the
    # centre tap (two taps on an even size) the value 1
    x = np.arange(1 - n, 1 - n + 2 * half, 2, dtype=np.float64)
    vals = np.exp(x * x * scale2x)
    total = 0.0
    for v in vals:                       # cv2's order of summation
        total += v
    total = total * 2.0 + 1.0 + (1.0 if n % 2 == 0 else 0.0)
    mul = 1.0 / total
    out = np.empty(n, np.float64)
    out[:half] = vals * mul
    out[n - half:] = (vals * mul)[::-1]
    out[half:n - half] = mul
    return out[:, None]


def _fma32(a, b, c):
    """float32 fused multiply-add (the product is exact in float64)."""
    return (a.astype(np.float64) * np.float64(b) + c).astype(np.float32)


# the float32 lanes of OpenCV's vector loop in RGB→gray (8: AVX2); the
# pixels of a row past the last whole vector take its scalar loop, whose
# first block of 4 rounds its 1st and 3rd pixel in another order (found
# against cv2 5.0 column by column)
GRAY_LANES = 8


def _gray(img: np.ndarray, weights, name: str) -> np.ndarray:
    """OpenCV's float32 gray conversion with BT.601 ``weights`` (float32
    constants) in the image's channel order c0, c1, c2: the vector loop
    computes fma(c2, k2, fma(c0, k0, c1·k1)); in a row's tail, the scalar
    loop's first block of 4 takes fma(c2, k2, fma(c1, k1, c0·k0)) for its
    1st and 3rd pixel."""
    img = np.asarray(img)
    if img.dtype != np.float32 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{name} takes (H, W, 3) float32, got "
                         f"{img.dtype} {img.shape}")
    k0, k1, k2 = (np.float32(v) for v in weights)
    c0, c1, c2 = img[..., 0], img[..., 1], img[..., 2]
    out = _fma32(c2, k2, _fma32(c0, k0, c1 * k1))
    w = img.shape[1]
    start = w // GRAY_LANES * GRAY_LANES
    if w - start >= 4:          # the scalar loop's block of 4
        first = [start, start + 2]
        out[:, first] = _fma32(c2[:, first], k2, _fma32(
            c1[:, first], k1, c0[:, first] * k0))
    return out


def rgb2gray(img: np.ndarray) -> np.ndarray:
    """(H, W) gray of an (H, W, 3) RGB float32 image, ``cv2.cvtColor(img,
    cv2.COLOR_RGB2GRAY)`` bit for bit."""
    return _gray(img, (0.299, 0.587, 0.114), "rgb2gray")


def bgr2gray(img: np.ndarray) -> np.ndarray:
    """(H, W) gray of an (H, W, 3) BGR float32 image, ``cv2.cvtColor(img,
    cv2.COLOR_BGR2GRAY)`` bit for bit. cv2 applies its fma order to the
    channels as they lie in memory, so this is not ``rgb2gray`` of the
    channel-reversed image (which differs in the last bit)."""
    return _gray(img, (0.114, 0.587, 0.299), "bgr2gray")


def reflect101_index(n: int, before: int, after: int) -> np.ndarray:
    """Source indices of an axis of ``n`` padded by ``before`` / ``after``
    with cv2's BORDER_REFLECT_101, reflecting again where a pad exceeds
    the axis."""
    p = np.arange(-before, n + after)
    if n == 1:
        return np.zeros_like(p)
    period = 2 * (n - 1)
    p = np.mod(p, period)
    return np.where(p >= n, period - p, p)


def border_index(n: int, before: int, after: int,
                 border: str) -> np.ndarray:
    """Source indices of an axis of ``n`` padded by ``before`` / ``after``
    with the cv2 border ``border``: 'reflect101' (BORDER_REFLECT_101) or
    'replicate' (BORDER_REPLICATE, ``aaa|abcd|ddd``)."""
    if border == "replicate":
        return np.clip(np.arange(-before, n + after), 0, n - 1)
    return reflect101_index(n, before, after)


# the scipy.ndimage mode of each cv2 border
_SCIPY_MODE = {"reflect101": "mirror", "replicate": "nearest"}


def _separable(k: np.ndarray):
    """(column, row) with k == outer(column, row), else None."""
    i, j = np.unravel_index(np.argmax(np.abs(k)), k.shape)
    pivot = k[i, j]
    if pivot == 0:
        return None
    col, row = k[:, j], k[i, :] / pivot
    if np.abs(np.outer(col, row) - k).max() > 1e-12 * abs(pivot):
        return None
    return col, row


def _correlate_axis(img64: np.ndarray, taps: np.ndarray, axis: int):
    from scipy.ndimage import correlate1d
    n = img64.shape[axis]
    a = len(taps) // 2
    if n >= len(taps):
        return correlate1d(img64, taps, axis=axis, mode="mirror")
    # an axis shorter than the kernel: pad by cv2's repeated reflection
    pad = np.take(img64, reflect101_index(n, a, len(taps) - 1 - a),
                  axis=axis)
    out = correlate1d(pad, taps, axis=axis, mode="mirror")
    return np.take(out, np.arange(a, a + n), axis=axis)


def _direct(img64: np.ndarray, k: np.ndarray, border: str) -> np.ndarray:
    from scipy.ndimage import correlate
    kh, kw = k.shape
    h, w = img64.shape[:2]
    kk = k.reshape(k.shape + (1,) * (img64.ndim - 2))
    mode = _SCIPY_MODE[border]
    if h >= kh and w >= kw:
        return correlate(img64, kk, mode=mode)
    ay, ax = kh // 2, kw // 2
    pad = img64[border_index(h, ay, kh - 1 - ay, border)][
        :, border_index(w, ax, kw - 1 - ax, border)]
    return correlate(pad, kk, mode=mode)[ay:ay + h, ax:ax + w]


def _fft(img64: np.ndarray, k: np.ndarray, border: str) -> np.ndarray:
    import scipy.fft as sfft
    kh, kw = k.shape
    h, w = img64.shape[:2]
    ay, ax = kh // 2, kw // 2
    pad = img64[border_index(h, ay, kh - 1 - ay, border)][
        :, border_index(w, ax, kw - 1 - ax, border)]
    shape = (sfft.next_fast_len(pad.shape[0], True),
             sfft.next_fast_len(pad.shape[1], True))
    f_img = sfft.rfft2(pad, shape, axes=(0, 1))
    f_k = sfft.rfft2(k[::-1, ::-1], shape)
    if img64.ndim == 3:
        f_k = f_k[:, :, None]
    out = sfft.irfft2(f_img * f_k, shape, axes=(0, 1))
    return out[kh - 1:kh - 1 + h, kw - 1:kw - 1 + w]


def filter2d(img: np.ndarray, kernel: np.ndarray,
             border: str = "reflect101") -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)`` for a float32 / float64 image of
    shape (H, W) or (H, W, C); ``border="replicate"`` is its
    ``borderType=cv2.BORDER_REPLICATE``."""
    if border not in _SCIPY_MODE:
        raise ValueError(f"border must be one of {sorted(_SCIPY_MODE)}, "
                         f"got {border!r}")
    img = np.asarray(img)
    if img.dtype not in (np.float32, np.float64):
        raise TypeError(f"filter2d takes float32 or float64, got "
                        f"{img.dtype}")
    if img.ndim not in (2, 3):
        raise ValueError(f"filter2d takes (H, W) or (H, W, C), got "
                         f"{img.shape}")
    k = np.asarray(kernel, np.float64)
    if k.ndim == 1:
        k = k[:, None]             # cv2 reads a 1-D array as a column
    if k.ndim != 2:
        raise ValueError(f"kernel must be 2-D, got {k.shape}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    x = img.astype(np.float64)
    # an outer product is found on the kernel as given: the float32
    # rounding below would hide it (and moves a tap by < 1e-7 of itself).
    # cv2 never splits a kernel; the split is the degradation chain's
    # speed path, so the replicate border (NIQE's 7² window on float64,
    # where the direct route gives cv2's bits) keeps cv2's routes
    sep = _separable(k) if min(k.shape) > 1 and border == "reflect101" \
        else None
    # cv2 filters a float32 image with the kernel in float32
    k = k.astype(np.float32 if img.dtype == np.float32 else np.float64)
    k = k.astype(np.float64)
    if sep is not None:
        col, row = sep
        out = _correlate_axis(_correlate_axis(x, col, 0), row, 1)
    elif k.size <= DIRECT_TAPS:
        out = _direct(x, k, border)
    else:
        out = _fft(x, k, border)
    return out.astype(img.dtype)
