"""Host-side PSNR / SSIM (MATLAB-faithful), numpy.

Transcribed from ciaosr_tpu/core/metrics.py (psnr, ssim). Images are
uint8-range HWC arrays; ``convert_to='y'`` converts BGR→Y (BT.601) first;
``crop_border`` trims each edge.
"""

from __future__ import annotations

import numpy as np

from ciaosr_torch.core.color import bgr2ycbcr

try:
    import cv2
except ImportError:  # pragma: no cover - scipy fallback below
    cv2 = None


def _reorder(img: np.ndarray, input_order: str) -> np.ndarray:
    if input_order not in ("HWC", "CHW"):
        raise ValueError(f"Wrong input_order {input_order}")
    if img.ndim == 2:
        return img[..., None]
    if input_order == "CHW":
        return img.transpose(1, 2, 0)
    return img


def _to_y(img: np.ndarray) -> np.ndarray:
    return bgr2ycbcr(img.astype(np.float32) / 255.0, y_only=True) * 255.0


def _crop(img: np.ndarray, crop_border: int) -> np.ndarray:
    if crop_border == 0:
        return img
    return img[crop_border:-crop_border, crop_border:-crop_border]


def psnr(img1: np.ndarray, img2: np.ndarray, crop_border: int = 0,
         input_order: str = "HWC", convert_to: str | None = None) -> float:
    """PSNR on [0,255]-range images; 20·log10(255/√MSE)."""
    if img1.shape != img2.shape:
        raise ValueError(f"shapes differ: {img1.shape} vs {img2.shape}")
    img1 = _reorder(img1, input_order).astype(np.float32)
    img2 = _reorder(img2, input_order).astype(np.float32)
    if isinstance(convert_to, str) and convert_to.lower() == "y":
        img1, img2 = _to_y(img1), _to_y(img2)
    elif convert_to is not None:
        raise ValueError("convert_to must be 'y' or None")
    img1, img2 = _crop(img1, crop_border), _crop(img2, crop_border)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return float(20.0 * np.log10(255.0 / np.sqrt(mse)))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    if cv2 is not None:
        k = cv2.getGaussianKernel(size, sigma)
    else:  # pragma: no cover
        x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
        k = np.exp(-(x ** 2) / (2 * sigma ** 2))[:, None]
        k /= k.sum()
    return np.outer(k, k.T)


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    """Single-channel SSIM: 11×11 σ=1.5 Gaussian window, MATLAB constants,
    valid-region crop [5:-5]."""
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    window = _gaussian_window()

    if cv2 is not None:
        def filt(x):
            return cv2.filter2D(x, -1, window)[5:-5, 5:-5]
    else:  # pragma: no cover
        from scipy.signal import correlate2d

        def filt(x):
            return correlate2d(x, window, mode="valid")

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = filt(img1 ** 2) - mu1_sq
    sigma2_sq = filt(img2 ** 2) - mu2_sq
    sigma12 = filt(img1 * img2) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return float(ssim_map.mean())


def ssim(img1: np.ndarray, img2: np.ndarray, crop_border: int = 0,
         input_order: str = "HWC", convert_to: str | None = None) -> float:
    """Mean per-channel SSIM with the MATLAB-faithful protocol."""
    if img1.shape != img2.shape:
        raise ValueError(f"shapes differ: {img1.shape} vs {img2.shape}")
    img1 = _reorder(img1, input_order)
    img2 = _reorder(img2, input_order)
    if isinstance(convert_to, str) and convert_to.lower() == "y":
        img1 = _to_y(img1.astype(np.float32))[..., None]
        img2 = _to_y(img2.astype(np.float32))[..., None]
    elif convert_to is not None:
        raise ValueError("convert_to must be 'y' or None")
    img1, img2 = _crop(img1, crop_border), _crop(img2, crop_border)
    return float(np.mean([_ssim_single(img1[..., i], img2[..., i])
                          for i in range(img1.shape[2])]))
