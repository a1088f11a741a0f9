"""Host-side metrics, numpy and scipy: PSNR / SSIM (MATLAB-faithful),
NIQE and the matting metrics.

Transcribed from ciaosr_tpu/core/metrics.py, whose OpenCV calls become
the port's own cv2-exact primitives (core/filters.py: ``filter2D`` with
reflect-101 or replicate borders, ``getGaussianKernel``, BGR→gray) and
scipy (``connectedComponentsWithStats`` → ``scipy.ndimage.label``), so
nothing here imports OpenCV. Images are uint8-range HWC arrays;
``convert_to='y'`` converts BGR→Y (BT.601) first; ``crop_border`` trims
each edge.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from ciaosr_torch.core.color import bgr2ycbcr
from ciaosr_torch.core.filters import bgr2gray, filter2d, gaussian_kernel_1d


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
    k = gaussian_kernel_1d(size, sigma)
    return np.outer(k, k.T)


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    """Single-channel SSIM: 11×11 σ=1.5 Gaussian window, MATLAB constants,
    valid-region crop [5:-5]."""
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    window = _gaussian_window()

    def filt(x):
        return filter2d(x, window)[5:-5, 5:-5]

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


# ---------------------------------------------------------------------------
# NIQE (no reference): the pristine MVG parameters (36-dim mean and
# covariance, 7×7 Gaussian window) ship as core/data/niqe_pris_params.npz,
# a byte copy of the JAX package's table. Resolution order: explicit path
# > CIAOSR_NIQE_PARAMS > the port's copy.
# ---------------------------------------------------------------------------

_NIQE_PARAMS = os.path.join(os.path.dirname(__file__), "data",
                            "niqe_pris_params.npz")


def _load_niqe_params(path: str | None = None):
    path = path or os.environ.get("CIAOSR_NIQE_PARAMS") or _NIQE_PARAMS
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"NIQE pristine parameters not found at {path}: point "
            "CIAOSR_NIQE_PARAMS at a niqe_pris_params.npz file "
            "(mu_pris_param, cov_pris_param, gaussian_window)")
    with np.load(path) as data:
        return (data["mu_pris_param"], data["cov_pris_param"],
                data["gaussian_window"])


@functools.lru_cache(maxsize=1)
def _aggd_alpha_grid():
    """The shape parameters of the MATLAB niqe grid ([0.2, 10], step
    1e-3) and the generalized-Gaussian moment ratio rho(a) = Γ(2/a)² /
    (Γ(1/a)·Γ(3/a)) of each; a fit inverts rho by the nearest entry.
    Cached: callers must not write to the arrays."""
    from scipy.special import gamma as G
    alphas = np.arange(0.2, 10.001, 0.001)
    inv = 1.0 / alphas
    return alphas, G(2 * inv) ** 2 / (G(inv) * G(3 * inv))


def _fit_aggd(x: np.ndarray):
    """Moment-match an asymmetric generalized Gaussian to the samples:
    (alpha, beta_left, beta_right), the shape and per-side scales."""
    from scipy.special import gamma as G
    x = np.ravel(x)
    neg, pos = x[x < 0], x[x > 0]
    s_left = np.sqrt(np.mean(neg ** 2)) if neg.size else 0.0
    s_right = np.sqrt(np.mean(pos ** 2)) if pos.size else 0.0
    # asymmetry-corrected moment ratio E|x|²/E x² → invert rho(alpha)
    asym = s_left / s_right if s_right > 0 else np.inf
    ratio = np.mean(np.abs(x)) ** 2 / np.mean(x ** 2)
    target = ratio * (asym ** 3 + 1) * (asym + 1) / (asym ** 2 + 1) ** 2
    alphas, rho = _aggd_alpha_grid()
    alpha = alphas[np.argmin((rho - target) ** 2)]
    side_scale = np.sqrt(G(1 / alpha) / G(3 / alpha))
    return alpha, s_left * side_scale, s_right * side_scale


# neighbour directions of the paired-product features: horizontal,
# vertical and the two diagonals
_NIQE_SHIFTS = ((0, 1), (1, 0), (1, 1), (1, -1))


def _compute_niqe_feature(mscn: np.ndarray) -> list:
    """The 18 features of one block: the AGGD fit of the MSCN
    coefficients (alpha, mean scale), then for each of the four
    neighbour products (alpha, asymmetry mean, beta_l, beta_r)."""
    from scipy.special import gamma as G
    alpha, b_l, b_r = _fit_aggd(mscn)
    feat = [alpha, (b_l + b_r) / 2]
    for shift in _NIQE_SHIFTS:
        alpha, b_l, b_r = _fit_aggd(mscn * np.roll(mscn, shift, axis=(0, 1)))
        feat += [alpha, (b_r - b_l) * (G(2 / alpha) / G(1 / alpha)),
                 b_l, b_r]
    return feat


def niqe_core(img: np.ndarray, mu_pris, cov_pris, gaussian_window,
              block_size_h: int = 96, block_size_w: int = 96) -> float:
    """NIQE of a grayscale [0, 255] image: two scales, a MATLAB-bicubic
    half-downsample between them."""
    from ciaosr_torch.core.resize import imresize_np

    img = img.astype(np.float64)
    h, w = img.shape
    num_block_h = h // block_size_h
    num_block_w = w // block_size_w
    img = img[: num_block_h * block_size_h, : num_block_w * block_size_w]

    distparam = []
    for scale in (1, 2):
        mu = filter2d(img, gaussian_window, border="replicate")
        sigma = np.sqrt(np.abs(
            filter2d(img ** 2, gaussian_window, border="replicate")
            - mu ** 2))
        img_norm = (img - mu) / (sigma + 1)

        feats = []
        # the block COUNT stays fixed across scales; only the slice size
        # halves (the half-size image has as many 48-px blocks as the
        # full-size one has 96-px blocks)
        for idx_h in range(num_block_h):
            for idx_w in range(num_block_w):
                block = img_norm[
                    idx_h * block_size_h // scale:
                    (idx_h + 1) * block_size_h // scale,
                    idx_w * block_size_w // scale:
                    (idx_w + 1) * block_size_w // scale]
                feats.append(_compute_niqe_feature(block))
        distparam.append(np.array(feats))
        if scale == 1:
            img = imresize_np(img / 255.0, scale=0.5) * 255.0
            img = img.astype(np.float64)

    distparam = np.concatenate(distparam, axis=1)
    mu_distparam = np.nanmean(distparam, axis=0)
    distparam_no_nan = distparam[~np.isnan(distparam).any(axis=1)]
    cov_distparam = np.cov(distparam_no_nan, rowvar=False)
    invcov_param = np.linalg.pinv((cov_pris + cov_distparam) / 2)
    # the table stores mu as (1, 36); either layout is taken
    diff = np.ravel(mu_pris) - mu_distparam
    return float(np.sqrt(diff @ invcov_param @ diff))


def niqe(img: np.ndarray, crop_border: int = 0, input_order: str = "HWC",
         convert_to: str = "y", params_path: str | None = None) -> float:
    """NIQE of a uint8-range BGR image (or a gray one): ``convert_to``
    'y' (BT.601 Y) or 'gray' (cv2's BGR2GRAY on float32), rounded, then
    ``crop_border`` trimmed from each edge."""
    mu_pris, cov_pris, gaussian_window = _load_niqe_params(params_path)
    img = _reorder(np.squeeze(img), input_order if img.ndim == 3 else "HWC")
    if img.ndim == 3 and img.shape[2] == 3:
        if convert_to.lower() == "y":
            img = _to_y(img.astype(np.float32))
        elif convert_to.lower() == "gray":
            img = bgr2gray(img.astype(np.float32) / 255.0) * 255.0
        else:
            raise ValueError("convert_to must be 'y' or 'gray'")
    else:
        img = np.squeeze(img)
    img = np.round(img)
    return niqe_core(_crop(img, crop_border), mu_pris, cov_pris,
                     gaussian_window)


# ---------------------------------------------------------------------------
# Matting metrics: alpha mattes, trimaps and predictions as 2-D [0, 255]
# arrays. No shipped config names them.
# ---------------------------------------------------------------------------

def _check_matting_inputs(alpha, trimap, pred_alpha):
    if alpha.ndim != 2 or trimap.ndim != 2 or pred_alpha.ndim != 2:
        raise ValueError(
            "alpha, trimap and pred_alpha must all be 2-D; got "
            f"{alpha.shape}, {trimap.shape}, {pred_alpha.shape}")
    if not ((pred_alpha[trimap == 0] == 0).all()
            and (pred_alpha[trimap == 255] == 255).all()):
        raise ValueError("pred_alpha should be masked by trimap before "
                         "evaluation")


def sad(alpha: np.ndarray, trimap: np.ndarray,
        pred_alpha: np.ndarray) -> float:
    """Sum of absolute differences, /1000."""
    _check_matting_inputs(alpha, trimap, pred_alpha)
    diff = np.abs(pred_alpha.astype(np.float64) / 255
                  - alpha.astype(np.float64) / 255)
    return float(diff.sum() / 1000)


def matting_mse(alpha: np.ndarray, trimap: np.ndarray,
                pred_alpha: np.ndarray) -> float:
    """MSE over the unknown (trimap == 128) region."""
    _check_matting_inputs(alpha, trimap, pred_alpha)
    weight_sum = int((trimap == 128).sum())
    if weight_sum == 0:
        return 0.0
    diff = (pred_alpha.astype(np.float64) / 255
            - alpha.astype(np.float64) / 255)
    return float((diff ** 2).sum() / weight_sum)


def _gauss_gradient(img: np.ndarray, sigma: float) -> np.ndarray:
    """Gaussian-derivative gradient magnitude: G(y)·G'(x) kernels,
    L2-normalized, correlated with replicate borders."""
    epsilon = 1e-2
    half = int(np.ceil(
        sigma * np.sqrt(-2 * np.log(np.sqrt(2 * np.pi) * sigma * epsilon))))
    size = 2 * half + 1
    x = np.arange(size, dtype=np.float64) - half
    g = np.exp(-x ** 2 / (2 * sigma ** 2)) / (sigma * np.sqrt(2 * np.pi))
    dg = -x * g / sigma ** 2
    kx = g[:, None] * dg[None, :]          # d/dx (columns)
    kx /= np.sqrt((kx ** 2).sum())
    img = img.astype(np.float64)
    gx = filter2d(img, kx, border="replicate")
    gy = filter2d(img, kx.T, border="replicate")
    return np.sqrt(gx ** 2 + gy ** 2)


def _normalize_minmax(x: np.ndarray) -> np.ndarray:
    """``cv2.normalize(x, dst, 1.0, 0.0, cv2.NORM_MINMAX)`` of a float64
    array: x·scale + shift onto [0, 1]; a range of at most DBL_EPSILON
    gives scale 0, so a constant array maps to zeros. (cv2 fuses the
    multiply-add, which can move the last bit.)"""
    lo, hi = float(x.min()), float(x.max())
    scale = 1.0 / (hi - lo) if hi - lo > np.finfo(np.float64).eps else 0.0
    return x * scale + (0.0 - lo * scale)


def gradient_error(alpha: np.ndarray, trimap: np.ndarray,
                   pred_alpha: np.ndarray, sigma: float = 1.4) -> float:
    """Gradient error over the unknown region, /1000."""
    _check_matting_inputs(alpha, trimap, pred_alpha)
    alpha_n = _normalize_minmax(alpha.astype(np.float64))
    pred_n = _normalize_minmax(pred_alpha.astype(np.float64))
    a_grad = _gauss_gradient(alpha_n, sigma).astype(np.float32)
    p_grad = _gauss_gradient(pred_n, sigma).astype(np.float32)
    loss = ((a_grad - p_grad) ** 2 * (trimap == 128)).sum()
    return float(loss / 1000)


# cv2's connectivity=4 neighbourhood
_CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])


def connectivity(alpha: np.ndarray, trimap: np.ndarray,
                 pred_alpha: np.ndarray, step: float = 0.1) -> float:
    """Connectivity error: per threshold, the largest 4-connected
    component of the GT ∩ pred binarization (the first in raster order on
    a size tie, as cv2's labels run) defines a round-down map;
    φ-differences ≥ 0.15 are penalized over the unknown region, /1000."""
    from scipy.ndimage import label

    _check_matting_inputs(alpha, trimap, pred_alpha)
    alpha = alpha.astype(np.float32) / 255
    pred_alpha = pred_alpha.astype(np.float32) / 255
    thresh_steps = np.arange(0, 1 + step, step)
    round_down_map = -np.ones_like(alpha)
    for i in range(1, len(thresh_steps)):
        inter = (alpha >= thresh_steps[i]) & (pred_alpha >= thresh_steps[i])
        labels, n = label(inter, structure=_CROSS)
        omega = np.zeros_like(alpha)
        if n:
            sizes = np.bincount(labels.ravel())[1:]
            omega[labels == int(np.argmax(sizes)) + 1] = 1
        mask = (round_down_map == -1) & (omega == 0)
        round_down_map[mask] = thresh_steps[i - 1]
    round_down_map[round_down_map == -1] = 1
    a_diff = alpha - round_down_map
    p_diff = pred_alpha - round_down_map
    a_phi = 1 - a_diff * (a_diff >= 0.15)
    p_phi = 1 - p_diff * (p_diff >= 0.15)
    return float(np.abs(a_phi - p_phi)[trimap == 128].sum() / 1000)


# the reference's name; ``matting_mse`` keeps clear of a pixel MSE
mse = matting_mse
