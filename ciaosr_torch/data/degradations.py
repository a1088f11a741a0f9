"""Real-ESRGAN degradation ops (host-side numpy / scipy).

Counterpart of ciaosr_tpu/data/degradations.py: the kernel zoo, the ops
of the 002 configs' train pipelines (RandomBlur, RandomResize,
RandomNoise, RandomJPEGCompression, RandomScaleResize1,
DegradationsWithShuffle(1), UnsharpMasking) and the rest of the zoo. Each
op makes the same numpy draws in the same order as its twin there (the
same methods, arguments and list types), so one generator state gives
the same images. The OpenCV calls of the reference are the port's own:
``core/filters.py`` (filter2D, getGaussianKernel, RGB→gray),
``core/cvresize.py`` (resize) and ``data/jpeg.py`` (the JPEG round
trip). No torch op runs here: the ops run in forked loader workers.

An op that draws random numbers draws them from ``results['_rng']`` and
raises without it.
"""

from __future__ import annotations

import numpy as np

from ciaosr_torch.config.registry import PIPELINES, build_from_cfg
from ciaosr_torch.core.cvresize import MODES, resize
from ciaosr_torch.core.filters import filter2d, gaussian_kernel_1d, rgb2gray
from ciaosr_torch.data.jpeg import jpeg_roundtrip
from ciaosr_torch.data.pipelines import _rng


# ----------------------------------------------------------- kernel zoo --

def _mesh(ks: int):
    ax = np.arange(ks) - (ks - 1) / 2.0
    xx, yy = np.meshgrid(ax, ax)
    return np.stack([xx, yy], -1)  # (ks, ks, 2)


def _sigma_matrix(sigma_x, sigma_y, theta):
    d = np.array([[sigma_x ** 2, 0], [0, sigma_y ** 2]])
    u = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    return u @ d @ u.T


def _quadratic(ks, sigma_x, sigma_y, theta):
    inv = np.linalg.inv(_sigma_matrix(sigma_x, sigma_y, theta))
    xy = _mesh(ks)
    return np.einsum("hwi,ij,hwj->hw", xy, inv, xy)


def gaussian_kernel(ks, sigma_x, sigma_y=None, theta=0.0, isotropic=True):
    if isotropic:
        sigma_y, theta = sigma_x, 0.0
    k = np.exp(-0.5 * _quadratic(ks, sigma_x, sigma_y, theta))
    return (k / k.sum()).astype(np.float32)


def generalized_gaussian_kernel(ks, sigma_x, sigma_y=None, theta=0.0,
                                beta=1.0, isotropic=True):
    if isotropic:
        sigma_y, theta = sigma_x, 0.0
    q = _quadratic(ks, sigma_x, sigma_y, theta)
    k = np.exp(-0.5 * np.power(q, beta))
    return (k / k.sum()).astype(np.float32)


def plateau_kernel(ks, sigma_x, sigma_y=None, theta=0.0, beta=1.0,
                   isotropic=True):
    if isotropic:
        sigma_y, theta = sigma_x, 0.0
    q = _quadratic(ks, sigma_x, sigma_y, theta)
    k = 1.0 / (np.power(q, beta) + 1.0)
    return (k / k.sum()).astype(np.float32)


def sinc_kernel(ks, omega):
    """Circular low-pass (jinc) filter with cutoff omega."""
    from scipy.special import j1
    ax = np.arange(ks) - (ks - 1) / 2.0
    xx, yy = np.meshgrid(ax, ax)
    r = np.sqrt(xx ** 2 + yy ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        k = omega * j1(omega * r) / (2 * np.pi * r)
    k[(ks - 1) // 2, (ks - 1) // 2] = omega ** 2 / (4 * np.pi)
    return (k / k.sum()).astype(np.float32)


def random_mixed_kernel(rng, kernel_list, kernel_prob, ks, sigma_x, sigma_y,
                        rotate, beta_gau, beta_pla, omega):
    ktype = rng.choice(kernel_list, p=kernel_prob)
    if ktype == "iso":
        return gaussian_kernel(ks, sigma_x, isotropic=True)
    if ktype == "aniso":
        return gaussian_kernel(ks, sigma_x, sigma_y, rotate, isotropic=False)
    if ktype == "generalized_iso":
        return generalized_gaussian_kernel(ks, sigma_x, beta=beta_gau,
                                           isotropic=True)
    if ktype == "generalized_aniso":
        return generalized_gaussian_kernel(ks, sigma_x, sigma_y, rotate,
                                           beta=beta_gau, isotropic=False)
    if ktype == "plateau_iso":
        return plateau_kernel(ks, sigma_x, beta=beta_pla, isotropic=True)
    if ktype == "plateau_aniso":
        return plateau_kernel(ks, sigma_x, sigma_y, rotate, beta=beta_pla,
                              isotropic=False)
    if ktype == "sinc":
        return sinc_kernel(ks, omega)
    raise ValueError(f"unknown kernel type {ktype}")


def _as_list(x):
    return ([x], True) if isinstance(x, np.ndarray) else (list(x), False)


# cv2's interpolation codes (the reference's ``inter_method`` lists)
_CV2_CODES = {1: "bilinear", 2: "bicubic", 3: "area", 4: "lanczos"}


def _jpeg(img, quality):
    u8 = (np.clip(img, 0, 1) * 255.0).round().astype(np.uint8)
    return jpeg_roundtrip(u8, quality).astype(np.float32) / 255.0


# ------------------------------------------------------------ pipelines --

@PIPELINES.register(name="RandomBlur")
class RandomBlur:
    """Kernel-zoo blur with a per-frame parameter walk and a prob gate."""

    def __init__(self, params, keys):
        self.params = params
        self.keys = keys

    def _kernels(self, rng, n):
        p = self.params
        ks = int(rng.choice(p["kernel_size"]))
        sx_rng = p.get("sigma_x", [0, 0])
        sy_rng = p.get("sigma_y", [0, 0])
        rot_rng = p.get("rotate_angle", [-np.pi, np.pi])
        bg_rng = p.get("beta_gaussian", [0.5, 4])
        bp_rng = p.get("beta_plateau", [1, 2])
        om_rng = p.get("omega")
        if om_rng is None:  # Real-ESRGAN default cutoff rule
            om_rng = [np.pi / 3, np.pi] if ks < 13 else [np.pi / 5, np.pi]
        sx = rng.uniform(*sx_rng)
        sy = rng.uniform(*sy_rng)
        rot = rng.uniform(*rot_rng)
        bg = rng.uniform(*bg_rng)
        bp = rng.uniform(*bp_rng)
        om = rng.uniform(*om_rng)
        walk = any(p.get(k, 0) for k in (
            "sigma_x_step", "sigma_y_step", "rotate_angle_step",
            "beta_gaussian_step", "beta_plateau_step", "omega_step"))
        kernels = []
        for _ in range(n):
            kernels.append(random_mixed_kernel(
                rng, p["kernel_list"], p["kernel_prob"], ks, sx, sy, rot,
                bg, bp, om))
            if walk:   # the video path's parameter walk
                def step(v, name, bounds):
                    s = p.get(name, 0)
                    return np.clip(v + rng.uniform(-s, s), *bounds)
                sx = step(sx, "sigma_x_step", sx_rng)
                sy = step(sy, "sigma_y_step", sy_rng)
                rot = step(rot, "rotate_angle_step", rot_rng)
                bg = step(bg, "beta_gaussian_step", bg_rng)
                bp = step(bp, "beta_plateau_step", bp_rng)
                om = step(om, "omega_step", om_rng)
        return kernels

    def __call__(self, results):
        rng = _rng(results)
        if rng.uniform() > self.params.get("prob", 1):
            return results
        for key in self.keys:
            imgs, single = _as_list(results[key])
            kernels = self._kernels(rng, len(imgs))
            out = [filter2d(img, k) for img, k in zip(imgs, kernels)]
            results[key] = out[0] if single else out
        return results


@PIPELINES.register(name="RandomResize")
class RandomResize:
    """Up / down / keep resize by a random factor with a random
    interpolation."""

    def __init__(self, params, keys):
        self.params = params
        self.keys = keys

    def __call__(self, results):
        rng = _rng(results)
        if rng.uniform() > self.params.get("prob", 1):
            return results
        p = self.params
        mode = rng.choice(["up", "down", "keep"], p=p["resize_mode_prob"])
        lo, hi = p["resize_scale"]
        if mode == "up":
            scale = rng.uniform(1, hi)
        elif mode == "down":
            scale = rng.uniform(lo, 1)
        else:
            scale = 1.0
        interp = str(rng.choice(p["resize_opt"], p=p.get("resize_prob")))
        ts = p.get("target_size")
        for key in self.keys:
            imgs, single = _as_list(results[key])
            out = []
            for img in imgs:
                h, w = img.shape[:2]
                size = ts or (int(h * scale), int(w * scale))
                out.append(resize(img, size, interp))
            results[key] = out[0] if single else out
        return results


@PIPELINES.register(name="RandomNoise")
class RandomNoise:
    """Gaussian / Poisson noise with a gray-noise probability."""

    def __init__(self, params, keys):
        self.params = params
        self.keys = keys

    def _gaussian(self, rng, img):
        p = self.params
        sigma = rng.uniform(*p["gaussian_sigma"]) / 255.0
        if rng.uniform() < p.get("gaussian_gray_noise_prob", 0):
            noise = rng.normal(0, sigma, img.shape[:2] + (1,))
        else:
            noise = rng.normal(0, sigma, img.shape)
        return (img + noise).astype(np.float32)

    def _poisson(self, rng, img):
        p = self.params
        scale = rng.uniform(*p["poisson_scale"])
        gray = rng.uniform() < p.get("poisson_gray_noise_prob", 0)
        base = rgb2gray(img.astype(np.float32))[..., None] if gray else img
        vals = 10 ** np.ceil(np.log10(len(np.unique(
            (np.clip(base, 0, 1) * 255).round().astype(np.uint8)))))
        noisy = rng.poisson(np.clip(base, 0, 1) * vals) / vals
        noise = (noisy - np.clip(base, 0, 1)) * scale
        return (img + noise).astype(np.float32)

    def __call__(self, results):
        rng = _rng(results)
        if rng.uniform() > self.params.get("prob", 1):
            return results
        p = self.params
        ntype = rng.choice(p["noise_type"], p=p.get("noise_prob"))
        for key in self.keys:
            imgs, single = _as_list(results[key])
            fn = self._gaussian if ntype == "gaussian" else self._poisson
            out = [fn(rng, img) for img in imgs]
            results[key] = out[0] if single else out
        return results


@PIPELINES.register(name="RandomJPEGCompression")
class RandomJPEGCompression:
    """A JPEG round trip at a uniform quality."""

    def __init__(self, params, keys):
        self.params = params
        self.keys = keys

    def __call__(self, results):
        rng = _rng(results)
        if rng.uniform() > self.params.get("prob", 1):
            return results
        quality = int(rng.integers(*self.params["quality"]))
        for key in self.keys:
            imgs, single = _as_list(results[key])
            out = [_jpeg(img, quality) for img in imgs]
            results[key] = out[0] if single else out
        return results


@PIPELINES.register(name="RandomScaleResize1")
class RandomScaleResize:
    """Resize lq to int(gt_size / U(scale_min, scale_max)) with a random
    interpolation."""

    def __init__(self, params, keys):
        self.params = params
        self.keys = keys

    def __call__(self, results):
        rng = _rng(results)
        if rng.uniform() > self.params.get("prob", 1):
            return results
        p = self.params
        h, w = results["gt"].shape[:2]
        interp = str(rng.choice(p["resize_opt"], p=p.get("resize_prob")))
        ts = p.get("target_size")
        if ts is None:
            factor = 1.0 / rng.uniform(p["scale_min"], p["scale_max"])
            h_out, w_out = h * factor, w * factor
            if p.get("is_size_even", False):
                h_out, w_out = 2 * (h_out // 2), 2 * (w_out // 2)
            ts = (int(h_out), int(w_out))
        imgs, single = _as_list(results["lq"])
        out = [resize(img, ts, interp) for img in imgs]
        results["lq"] = out[0] if single else out
        return results


@PIPELINES.register(name="DegradationsWithShuffle")
@PIPELINES.register(name="DegradationsWithShuffle1")
class DegradationsWithShuffle:
    """Apply a list of degradations in shuffled order; list entries that
    are themselves lists keep their internal order."""

    def __init__(self, degradations, keys, shuffle_idx=None):
        self.keys = keys
        self.shuffle_idx = shuffle_idx
        self.degradations = [self._build(d) for d in degradations]

    def _build(self, cfg):
        if isinstance(cfg, (list, tuple)):
            return [self._build(c) for c in cfg]
        cfg = dict(cfg)
        cfg.setdefault("keys", self.keys)
        return build_from_cfg(cfg, PIPELINES)

    def __call__(self, results):
        rng = _rng(results)
        if self.shuffle_idx is None:
            order = rng.permutation(len(self.degradations))
        else:
            order = list(range(len(self.degradations)))
            sub = [order[i] for i in self.shuffle_idx]
            rng.shuffle(sub)
            for i, v in zip(self.shuffle_idx, sub):
                order[i] = v
        for i in order:
            deg = self.degradations[int(i)]
            for d in (deg if isinstance(deg, list) else [deg]):
                results = d(results)
        return results


@PIPELINES.register(name="UnsharpMasking")
class UnsharpMasking:
    """USM sharpening into '{key}_unsharp': a Gaussian residual, a
    threshold mask softened by the same Gaussian, a weighted add."""

    def __init__(self, keys, kernel_size=51, sigma=0, weight=0.5,
                 threshold=10):
        self.keys = keys
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.weight = weight
        self.threshold = threshold
        k = gaussian_kernel_1d(kernel_size, sigma)
        self.kernel = (k @ k.T).astype(np.float64)

    def _usm(self, img):
        blur = filter2d(img, self.kernel)
        residual = img - blur
        mask = (np.abs(residual) * 255 > self.threshold).astype(np.float32)
        soft_mask = filter2d(mask, self.kernel)
        sharp = np.clip(img + self.weight * residual, 0, 1)
        return (soft_mask * sharp + (1 - soft_mask) * img).astype(np.float32)

    def __call__(self, results):
        for key in self.keys:
            imgs, single = _as_list(results[key])
            out = [self._usm(img) for img in imgs]
            results[f"{key}_unsharp"] = out[0] if single else out
        return results


# ---------------------------------------------------------------------------
# The rest of the zoo (no shipped config runs these).
# ---------------------------------------------------------------------------


def _nonblind_concat(img, level):
    return np.concatenate(
        [img, np.broadcast_to(np.float32(level),
                              (img.shape[0], img.shape[1], 1))], axis=2)


@PIPELINES.register(name="RandomGaussianNoise")
class RandomGaussianNoise:
    """Per-key uniform-sigma Gaussian noise; ``nonblind_noise`` appends the
    sigma as an extra channel."""

    def __init__(self, params, keys):
        self.params = params
        self.keys = keys

    def _apply(self, rng, imgs, level):
        out = []
        for img in imgs:
            noisy = (img + rng.normal(0, 1, img.shape) * level
                     ).astype(np.float32)
            out.append(_nonblind_concat(noisy, level)
                       if self.params.get("nonblind_noise") else noisy)
        return out

    def _level(self, rng):
        lo, hi = self.params["gaussian_sigma"]
        return rng.uniform(lo, hi) / 255.0

    def __call__(self, results):
        rng = _rng(results)
        for key in self.keys:
            level = self._level(rng)       # a fresh level per key
            imgs, single = _as_list(results[key])
            out = self._apply(rng, imgs, level)
            results[key] = out[0] if single else out
        return results


@PIPELINES.register(name="RandomGaussianNoisewithPro")
class RandomGaussianNoisewithPro(RandomGaussianNoise):
    """The level from ``gaussian_beta`` with probability ``prob``, else
    from ``gaussian_sigma``."""

    def _level(self, rng):
        key = ("gaussian_beta" if rng.uniform() < self.params["prob"]
               else "gaussian_sigma")
        lo, hi = self.params[key]
        return rng.uniform(lo, hi) / 255.0


@PIPELINES.register(name="RandomClipGaussianNoise")
class RandomClipGaussianNoise(RandomGaussianNoise):
    """Gaussian noise with the noisy image clipped to [0, 1]."""

    def _apply(self, rng, imgs, level):
        out = []
        for img in imgs:
            noisy = np.clip(img + rng.normal(0, 1, img.shape) * level,
                            0, 1).astype(np.float32)
            out.append(_nonblind_concat(noisy, level)
                       if self.params.get("nonblind_noise") else noisy)
        return out


@PIPELINES.register(name="RandomLevel")
class RandomLevel:
    """Append a uniform noise-level plane as an extra channel."""

    def __init__(self, params, keys):
        self.params = params
        self.keys = keys

    def __call__(self, results):
        rng = _rng(results)
        for key in self.keys:
            level = rng.uniform(*self.params["sigma"]) / 255.0
            imgs, single = _as_list(results[key])
            out = [_nonblind_concat(img, level) for img in imgs]
            results[key] = out[0] if single else out
        return results


@PIPELINES.register(name="RealRandomNoise")
class RealRandomNoise:
    """Shuffled gaussian / poisson / speckle / JPEG noise chain with
    per-frame level walks: gaussian and jpeg always run, poisson and
    speckle behind ``other_prob``; the order is shuffled with probability
    ``shuffle_prob``."""

    def __init__(self, params, keys):
        self.params = params
        self.keys = keys

    def _gaussian(self, rng, imgs):
        p = self.params
        lo, hi = p["gaussian_sigma"]
        sigma = rng.uniform(lo, hi) / 255.0
        step = p.get("gaussian_sigma_step", 0)
        gray = rng.uniform() < p["gaussian_gray_noise_prob"]
        out = []
        for img in imgs:
            shape = img.shape[:2] + (1,) if gray else img.shape
            out.append((img + rng.normal(0, 1, shape) * sigma
                        ).astype(np.float32))
            sigma = np.clip(sigma + rng.uniform(-step, step) / 255.0,
                            lo / 255.0, hi / 255.0)
        return out

    def _poisson(self, rng, imgs):
        p = self.params
        lo, hi = p["poisson_scale"]
        scale = rng.uniform(lo, hi)
        step = p.get("poisson_scale_step", 0)
        gray = rng.uniform() < p["poisson_gray_noise_prob"]
        out = []
        for img in imgs:
            base = rgb2gray(img.astype(np.float32))[..., None] if gray \
                else img
            base = np.clip((base * 255.0).round(), 0, 255) / 255.0
            vals = 2 ** np.ceil(np.log2(len(np.unique(base))))
            noise = rng.poisson(base * vals) / vals - base
            out.append((img + noise * scale).astype(np.float32))
            scale = np.clip(scale + rng.uniform(-step, step), lo, hi)
        return out

    def _speckle(self, rng, imgs):
        from scipy.linalg import orth
        lo, hi = self.params["speckle_level"]
        out = []
        for img in imgs:
            level = int(rng.integers(lo, hi + 1))
            img = np.clip(img, 0, 1)
            r = rng.uniform()
            if r > 0.6:
                img = img + img * rng.normal(0, level / 255.0, img.shape
                                             ).astype(np.float32)
            elif r < 0.4:
                img = img + img * rng.normal(
                    0, level / 255.0, (*img.shape[:2], 1)).astype(np.float32)
            else:
                L = hi / 255.0
                D = np.diag(rng.random(3))
                U = orth(rng.random((3, 3)))
                cov = U.T @ D @ U
                img = img + img * rng.multivariate_normal(
                    np.zeros(3), np.abs(L ** 2 * cov), img.shape[:2]
                ).astype(np.float32)
            out.append(np.clip(img, 0, 1).astype(np.float32))
        return out

    def _jpeg(self, rng, imgs):
        lo, hi = self.params["quality_range"]
        out = []
        for img in imgs:
            q = int(rng.integers(lo, hi + 1))
            out.append(_jpeg(img, q))
        return out

    def _chain(self, rng, imgs):
        p = self.params
        order = list(range(len(p["noise_type"])))
        if rng.uniform() < p["shuffle_prob"]:
            order = list(rng.permutation(order))
        for i in order:
            ntype = p["noise_type"][i]
            if ntype == "gaussian":
                imgs = self._gaussian(rng, imgs)
            elif ntype == "poisson":
                if rng.uniform() < p["other_prob"]:
                    imgs = self._poisson(rng, imgs)
            elif ntype == "speckle":
                if rng.uniform() < p["other_prob"]:
                    imgs = self._speckle(rng, imgs)
            elif ntype == "jpeg":
                imgs = self._jpeg(rng, imgs)
            else:
                raise NotImplementedError(
                    f'"noise_type" [{ntype}] is not implemented.')
        return imgs

    def __call__(self, results):
        rng = _rng(results)
        if rng.uniform() > self.params.get("prob", 1):
            return results
        for key in self.keys:
            imgs, single = _as_list(results[key])
            out = self._chain(rng, imgs)
            results[key] = out[0] if single else out
        return results


@PIPELINES.register(name="RealRandomResize")
class RealRandomResize:
    """Down-up (or up-down) resize round trip at a random scale and
    interpolation, back to the original size."""

    def __init__(self, params, keys):
        self.params = params
        self.keys = keys

    def __call__(self, results):
        rng = _rng(results)
        p = self.params
        if rng.uniform() > p.get("prob", 1):
            return results
        opt = str(rng.choice(p["resize_opt"], p=p.get("resize_prob"))).lower()
        if opt not in MODES:
            raise NotImplementedError(f"resize_opt [{opt}] is not "
                                      "implemented")
        mode = rng.choice(["up", "down", "keep"], p=p["resize_mode_prob"])
        lo, hi = p["resize_scale"]
        scale = (rng.uniform(1, hi) if mode == "up"
                 else rng.uniform(lo, 1) if mode == "down" else 1.0)
        for key in self.keys:
            imgs, single = _as_list(results[key])
            h, w = imgs[0].shape[:2]
            h_out, w_out = h * scale, w * scale
            if p.get("is_size_even", False):
                h_out, w_out = 2 * (h_out // 2), 2 * (w_out // 2)
            tgt = (int(h_out), int(w_out))
            out = [resize(resize(img, tgt, opt), (h, w), opt)
                   for img in imgs]
            results[key] = out[0] if single else out
        return results


@PIPELINES.register(name="UVSRDegradation")
class UVSRDegradation:
    """Video → frame-fused LR degradation: a 5-frame reflection-padded
    temporal mean, stride-s temporal decimation (keep-first) and a
    MATLAB-bicubic 1/s spatial downsample per frame. Frames are numpy
    (T, H, W, C)."""

    def __init__(self, params, keys):
        if params.get("fuse_frames", 5) != 5:
            raise ValueError("fuse_frames must be 5")
        self.params = params
        self.keys = keys

    def _apply(self, imgs):
        from ciaosr_torch.core.resize import imresize_np
        imgs = np.asarray(imgs, np.float32)
        if imgs.shape[0] <= 5:
            raise ValueError("need more than fuse_frames frames")
        # reflection pad [1, 0] in front, [-2, -3] behind, 5-wide means
        padded = np.concatenate([imgs[1:2], imgs[0:1], imgs,
                                 imgs[-2:-1], imgs[-3:-2]], axis=0)
        fused = np.stack([padded[i - 2:i + 3].mean(axis=0)
                          for i in range(2, len(padded) - 2)], axis=0)
        if self.params.get("down", True):
            sf = self.params["scale"]
            if sf[1] != sf[2]:
                raise ValueError("spatial scales must match")
            fused = fused[::sf[0]]
            fused = np.stack([imresize_np(f, scale=1.0 / sf[1])
                              for f in fused], axis=0)
        return fused

    def __call__(self, results):
        for key in self.keys:
            results[key] = self._apply(results[key])
        return results


def _require_av():
    try:
        import av  # noqa: F401
        return av
    except ImportError as e:  # pragma: no cover - av absent in CI
        raise ImportError(
            "PyAV is required for video compression degradations "
            "(reference random_degradations.py:288 `assert has_av`); "
            "install `av` or drop the video-compression entries") from e


@PIPELINES.register(name="RandomVideoCompression")
class RandomVideoCompression:
    """An mp4 encode / decode round trip at a random codec and bitrate.
    Requires PyAV."""

    def __init__(self, params, keys):
        self.av = _require_av()
        self.params = params
        self.keys = keys

    def _compress(self, rng, imgs):  # pragma: no cover - needs av
        import io
        av = self.av
        codec = str(rng.choice(self.params["codec"],
                               p=self.params.get("codec_prob")))
        lo, hi = self.params["bitrate"]
        bitrate = int(rng.integers(lo, hi + 1))
        buf = io.BytesIO()
        with av.open(buf, "w", "mp4") as container:
            stream = container.add_stream(codec, rate=1)
            stream.height, stream.width = imgs[0].shape[:2]
            stream.pix_fmt = "yuv420p"
            stream.bit_rate = bitrate
            for img in imgs:
                u8 = (np.clip(img, 0, 1) * 255.0).round().astype(np.uint8)
                frame = av.VideoFrame.from_ndarray(u8, format="rgb24")
                frame.pict_type = "NONE"
                for packet in stream.encode(frame):
                    container.mux(packet)
            for packet in stream.encode():
                container.mux(packet)
        out = []
        with av.open(buf, "r", "mp4") as container:
            if container.streams.video:
                for frame in container.decode(video=0):
                    out.append(frame.to_rgb().to_ndarray().astype(
                        np.float32) / 255.0)
        return out

    def __call__(self, results):  # pragma: no cover - needs av
        rng = _rng(results)
        if rng.uniform() > self.params.get("prob", 1):
            return results
        for key in self.keys:
            imgs, single = _as_list(results[key])
            out = self._compress(rng, imgs)
            results[key] = out[0] if single else out
        return results


@PIPELINES.register(name="OldRandomNoise")
class OldRandomNoise(RealRandomNoise):
    """KAIR-style paired (lq, gt) video degradation chain: 16 shuffled
    slots of blur / resize round trip / gaussian / poisson / speckle /
    JPEG / video compression / random shift, applied to ``gt`` to make
    ``lq`` while a clean copy is tracked.

    Kept from the JAX package, as it documents them: the reference's
    ``_add_blur`` / ``_add_resize`` read their output lists outside the
    probability gate (UnboundLocalError when the gate misses) and
    ``_add_resize`` returns the last frame instead of the lists; here the
    gates no-op and the lists flow through. The video-compression slots
    need PyAV only when the params configure a codec.
    """

    def __init__(self, params, keys):
        super().__init__(params, keys)
        if "codec" in params:
            self.av = _require_av()

    def _blur_pair(self, rng, imgs, hqs):
        if rng.random() >= self.params.get("blur_prob", 0.5):
            return imgs, hqs
        from scipy.ndimage import convolve
        sf = int(rng.choice(self.params.get("sf", [2, 3, 4])))
        wd = 2.0 + 0.2 * sf
        ks = 2 * int(rng.integers(2, 12)) + 3
        k = gaussian_kernel(ks, wd * rng.random() + 1e-6)[..., None]

        def blur(im):
            return convolve(im, k, mode="mirror").astype(np.float32)
        return [blur(i) for i in imgs], [blur(h) for h in hqs]

    def _resize_pair(self, rng, imgs, hqs):
        code = int(rng.choice(self.params.get("inter_method", [1, 2, 3])))
        if code not in _CV2_CODES:
            raise NotImplementedError(
                f"inter_method {code}: the port resizes with cv2 codes "
                f"{sorted(_CV2_CODES)}")
        interp = _CV2_CODES[code]
        r = rng.random()
        sf = (rng.uniform(1, 2) if r > 0.75
              else rng.uniform(0.5, 1) if r < 0.25 else 1.0)
        if sf == 1.0:
            return imgs, hqs

        def rt(im):
            h0, w0 = im.shape[:2]
            w1, h1 = int(sf * w0) // 2 * 2, int(sf * h0) // 2 * 2
            im = resize(resize(im, (h1, w1), interp), (h0, w0), interp)
            return np.clip(im, 0.0, 1.0).astype(np.float32)

        return [rt(i) for i in imgs], [rt(h) for h in hqs]

    def _shift_pair(self, rng, imgs, hqs):
        if rng.random() >= self.params.get("shift_prob", 0.5):
            return imgs, hqs
        dy = 2 * int(rng.integers(0, 5))   # even: video-codec constraint
        dx = 2 * int(rng.integers(0, 5))
        return ([i[dy:, dx:] for i in imgs], [h[dy:, dx:] for h in hqs])

    def __call__(self, results):
        rng = _rng(results)
        gt, single = _as_list(results["gt"])
        imgs = [np.asarray(g, np.float32).copy() for g in gt]
        hqs = [np.asarray(g, np.float32).copy() for g in gt]
        n_deg = 16
        order = (list(rng.permutation(n_deg))
                 if rng.random() < self.params.get("shuffle_prob", 0.5)
                 else list(range(n_deg)))
        for i in order:
            if i == 0:
                imgs, hqs = self._blur_pair(rng, imgs, hqs)
            elif i in (1, 8):
                imgs, hqs = self._resize_pair(rng, imgs, hqs)
            elif i in (2, 9):
                imgs = self._gaussian(rng, imgs)
            elif i in (3, 10):
                imgs = self._poisson(rng, imgs)
            elif i in (4, 11):
                imgs = self._speckle(rng, imgs)
            elif i in (6, 14):
                imgs = self._jpeg(rng, imgs)
            elif i in (7, 15) and "codec" in self.params:
                imgs = RandomVideoCompression._compress(self, rng, imgs)
            elif i == 13:
                imgs, hqs = self._shift_pair(rng, imgs, hqs)
        results["lq"] = imgs[0] if single else imgs
        results["gt"] = hqs[0] if single else hqs
        return results


@PIPELINES.register(name="NorResize")
class NorResize:
    """Fixed-interpolation resize to a mode/scale-derived (or given)
    target size.

    The reference's version references an undefined ``img`` in a leftover
    crop block and fails on any call; this is the intended behaviour with
    that block removed, as in the JAX package.
    """

    def __init__(self, params, keys):
        self.params = params
        self.keys = keys
        if params["resize_opt"] not in MODES:
            raise NotImplementedError(
                f"resize_opt [{params['resize_opt']}] is not implemented")

    def __call__(self, results):
        rng = _rng(results)
        p = self.params
        interp = p["resize_opt"]
        target_size = p.get("target_size")
        resize_step = p.get("resize_step", 0) if target_size is None else 0

        def size_of(h, w, scale):
            h_out, w_out = h * scale, w * scale
            if p.get("is_size_even", False):
                h_out, w_out = 2 * (h_out // 2), 2 * (w_out // 2)
            return (int(h_out), int(w_out))

        for key in self.keys:
            imgs, single = _as_list(results[key])
            h, w = imgs[0].shape[:2]
            if target_size is None:
                mode = rng.choice(["up", "down", "keep"],
                                  p=p["resize_mode_prob"])
                lo, hi = p["resize_scale"]
                scale = (rng.uniform(1, hi) if mode == "up"
                         else rng.uniform(lo, 1) if mode == "down" else 1.0)
                if p.get("patch_size"):
                    h = w = p["patch_size"]
                tgt = size_of(h, w, scale)
            else:
                tgt = tuple(target_size)
            out = []
            for img in imgs:
                out.append(resize(img, tgt, interp))
                if resize_step:
                    lo, hi = p["resize_scale"]
                    scale = np.clip(
                        scale + rng.uniform(-resize_step, resize_step),
                        lo, hi)
                    tgt = size_of(h, w, scale)
            results[key] = out[0] if single else out
        return results
