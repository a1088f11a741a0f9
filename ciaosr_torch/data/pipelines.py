"""Host-side pipeline ops (numpy), the mmedit pipeline surface.

Counterpart of ciaosr_tpu/data/pipelines.py: the ops of the configs'
train, valid and test pipelines, the crops and the coordinate variants,
and ``Compose``. Each op is a callable ``op(results: dict) -> dict``; keys follow the
reference protocol ('lq', 'gt', 'coord', 'cell', 'scale', '*_path').
Images are HWC float32 / uint8 numpy arrays. An op that draws a random
number draws it from ``results['_rng']``, a ``numpy.random.Generator``
the dataset passes; there is no module-level generator.
"""

from __future__ import annotations

import numpy as np

from ciaosr_torch.config.registry import PIPELINES, build_from_cfg
from ciaosr_torch.core.resize import imresize_np
from ciaosr_torch.data.imageio import imread


def _rng(results) -> np.random.Generator:
    try:
        return results["_rng"]
    except KeyError:
        raise KeyError("this op draws random numbers: give the sample a "
                       "numpy Generator as results['_rng'] (the datasets "
                       "do)") from None


def make_coord_np(shape) -> np.ndarray:
    """(H·W, 2) float32 pixel centres in [-1, 1], (y, x) on the last axis,
    computed in float32 as the JAX package's ``make_coord_np`` does."""
    def centers(n):
        r = 1.0 / n
        return -1.0 + r + 2.0 * r * np.arange(n, dtype=np.float32)
    h, w = shape
    grid = np.stack(np.meshgrid(centers(h), centers(w), indexing="ij"),
                    axis=-1)
    return grid.reshape(-1, 2).astype(np.float32)


def make_cell_np(target_shape) -> np.ndarray:
    """(H·W, 2) float32 cells, every query (2/H, 2/W)."""
    h, w = target_shape
    cell = np.empty((h * w, 2), dtype=np.float32)
    cell[:, 0] = 2.0 / h
    cell[:, 1] = 2.0 / w
    return cell


@PIPELINES.register(name="LoadImageFromFile")
class LoadImageFromFile:
    """Read an image from ``results[f'{key}_path']`` into ``results[key]``
    as HWC uint8 in the requested channel order (default rgb)."""

    def __init__(self, io_backend="disk", key="gt", flag="color",
                 channel_order="rgb", **kwargs):
        self.key = key
        self.channel_order = channel_order

    def __call__(self, results):
        img = imread(results[f"{self.key}_path"], self.channel_order)
        results[self.key] = img
        results[f"{self.key}_ori_shape"] = img.shape
        return results


@PIPELINES.register(name="RescaleToZeroOne")
class RescaleToZeroOne:
    def __init__(self, keys):
        self.keys = keys

    def __call__(self, results):
        for k in self.keys:
            results[k] = results[k].astype(np.float32) / 255.0
        return results


@PIPELINES.register(name="RandomDownSampling")
class RandomDownSampling:
    """LQ synthesis: scale ∈ [min, max) uniform; crop an HR patch of
    round(patch·s) and bicubic-downsample it to the LR patch, or (no
    ``patch_size``, eval) the whole image cut to an integer LR grid.
    Only the 'matlab' backend (MATLAB-exact bicubic) is ported."""

    def __init__(self, scale_min=1.0, scale_max=4.0, patch_size=None,
                 interpolation="bicubic", backend="matlab"):
        if scale_max < scale_min:
            raise ValueError(f"scale_max {scale_max} < scale_min "
                             f"{scale_min}")
        if backend != "matlab":
            raise NotImplementedError(
                f"RandomDownSampling backend {backend!r} is not ported "
                "(ROADMAP queue 1 item 6(a)); use 'matlab'")
        self.scale_min = scale_min
        self.scale_max = scale_max
        self.patch_size = patch_size
        self.interpolation = interpolation

    def __call__(self, results):
        img = results["gt"]
        if self.scale_max == self.scale_min:
            scale = self.scale_min
        else:
            scale = _rng(results).uniform(self.scale_min, self.scale_max)
        if self.patch_size is None:
            h_lr = int(img.shape[0] / scale + 1e-9)
            w_lr = int(img.shape[1] / scale + 1e-9)
            gt = img[: round(h_lr * scale), : round(w_lr * scale)]
            lq = imresize_np(gt, size=(h_lr, w_lr), scale=1.0 / scale)
        else:
            rng = _rng(results)
            w_lr = self.patch_size
            w_hr = round(w_lr * scale)
            x0 = int(rng.integers(0, img.shape[0] - w_hr + 1))
            y0 = int(rng.integers(0, img.shape[1] - w_hr + 1))
            gt = img[x0:x0 + w_hr, y0:y0 + w_hr]
            lq = imresize_np(gt, size=(w_lr, w_lr), scale=1.0 / scale)
        results["gt"] = gt
        results["lq"] = lq
        results["scale"] = scale
        return results


@PIPELINES.register(name="Flip")
class Flip:
    """Flip ``keys`` along one axis with probability ``flip_ratio`` (one
    draw for all keys)."""

    def __init__(self, keys, flip_ratio=0.5, direction="horizontal"):
        if direction not in ("horizontal", "vertical"):
            raise ValueError(f"direction {direction!r}: horizontal or "
                             "vertical")
        self.keys = keys
        self.flip_ratio = flip_ratio
        self.axis = 1 if direction == "horizontal" else 0

    def __call__(self, results):
        if _rng(results).random() < self.flip_ratio:
            for k in self.keys:
                results[k] = np.ascontiguousarray(
                    np.flip(results[k], axis=self.axis))
        return results


@PIPELINES.register(name="RandomTransposeHW")
class RandomTransposeHW:
    """Swap H and W of ``keys`` with probability ``transpose_ratio``."""

    def __init__(self, keys, transpose_ratio=0.5):
        self.keys = keys
        self.transpose_ratio = transpose_ratio

    def __call__(self, results):
        if _rng(results).random() < self.transpose_ratio:
            for k in self.keys:
                results[k] = np.ascontiguousarray(
                    results[k].transpose(1, 0, 2))
        return results


@PIPELINES.register(name="ImageToTensor")
class ImageToTensor:
    """HWC float32 (the reference's CHW layout marker; the port keeps
    NHWC on the host)."""

    def __init__(self, keys):
        self.keys = keys

    def __call__(self, results):
        for k in self.keys:
            arr = results[k]
            if arr.ndim == 2:
                arr = arr[..., None]
            results[k] = np.ascontiguousarray(arr.astype(np.float32))
        return results


@PIPELINES.register(name="GenerateCoordinateAndCell")
class GenerateCoordinateAndCell:
    """Coordinates and cells of the target grid, optionally subsampled.

    Training (``sample_quantity``): flatten gt to (N, 3) and keep
    ``sample_quantity`` queries, a random permutation (``is_shuffle``) or
    a contiguous run from a random start. Eval: the full grid of the
    target size (``target_size``, else the gt's, else lq × ``scale``).
    """

    def __init__(self, sample_quantity=None, scale=None, target_size=None,
                 is_shuffle=True):
        self.sample_quantity = sample_quantity
        self.scale = scale
        self.target_size = target_size
        self.is_shuffle = is_shuffle

    def __call__(self, results):
        if self.target_size is not None:
            target = tuple(self.target_size)
        elif "gt" in results and results["gt"].ndim == 3:
            target = results["gt"].shape[:2]
        elif self.scale is not None and "lq" in results:
            target = (round(results["lq"].shape[0] * self.scale),
                      round(results["lq"].shape[1] * self.scale))
        else:
            raise KeyError("cannot infer target size for coordinates")

        coord = make_coord_np(target)
        cell = make_cell_np(target)

        if self.sample_quantity is not None and "gt" in results:
            gt_flat = results["gt"].reshape(-1, results["gt"].shape[-1])
            n = gt_flat.shape[0]
            rng = _rng(results)
            if self.is_shuffle:
                sel = rng.permutation(n)[: self.sample_quantity]
            else:
                start = int(rng.integers(0, n - self.sample_quantity + 1))
                sel = np.arange(start, start + self.sample_quantity)
            coord = coord[sel]
            cell = cell[sel]
            results["gt"] = np.ascontiguousarray(gt_flat[sel])
            if "gt_unsharp" in results:
                unsharp = results["gt_unsharp"].reshape(
                    -1, results["gt_unsharp"].shape[-1])
                results["gt_unsharp"] = np.ascontiguousarray(unsharp[sel])

        results["coord"] = coord
        results["cell"] = cell
        results["target_size"] = target
        return results


@PIPELINES.register(name="Collect")
class Collect:
    def __init__(self, keys, meta_keys=()):
        self.keys = keys
        self.meta_keys = meta_keys

    def __call__(self, results):
        out = {k: results[k] for k in self.keys}
        out["meta"] = {k: results.get(k) for k in self.meta_keys}
        for extra in ("scale", "target_size"):
            if extra in results:
                out["meta"].setdefault(extra, results[extra])
        return out


@PIPELINES.register(name="RandomBicubicSampling")
class RandomBicubicSampling(RandomDownSampling):
    """The reference's in-tree twin of RandomDownSampling: the same op on
    the MATLAB-exact bicubic."""

    def __init__(self, scale_min=1.0, scale_max=4.0, patch_size=None,
                 interpolation="bicubic", **kwargs):
        super().__init__(scale_min=scale_min, scale_max=scale_max,
                         patch_size=patch_size, interpolation=interpolation)


@PIPELINES.register(name="GenerateCoordinateAndCell1")
class GenerateCoordinateAndCell1(GenerateCoordinateAndCell):
    """The reference's local variant: the same op (gt_unsharp included)."""


@PIPELINES.register(name="GenerateCoordinateAndCell2")
class GenerateCoordinateAndCell2:
    """The super-sampling-eval variant, with the reference's semantics:

    * with a gt, the gt is flattened to (H·W, C) and the target grid is
      (round(H/scale·scale1), round(W/scale·scale1)), the two steps kept
      (rounding the intermediate differs from round(H·scale1/scale));
    * with ``sample_quantity``, indices drawn without replacement over the
      target grid index both coord and the flattened gt (only scale1 ==
      scale pairs them consistently, as in the reference);
    * without a gt, ``target_size`` (its last two entries) is the grid.

    The target size goes to results['target_size']; the op keeps no state.
    """

    def __init__(self, sample_quantity=None, scale=None, scale1=None,
                 target_size=None):
        self.sample_quantity = sample_quantity
        self.scale = scale
        self.scale1 = scale1
        self.target_size = target_size

    def __call__(self, results):
        if "gt" in results:
            gt = results["gt"]
            h, w = gt.shape[:2]
            results["gt"] = np.ascontiguousarray(
                gt.reshape(-1, gt.shape[-1]))
            h_lr, w_lr = h / self.scale, w / self.scale
            target = (round(h_lr * self.scale1), round(w_lr * self.scale1))
        else:
            if self.target_size is None or len(self.target_size) < 2:
                raise ValueError("GenerateCoordinateAndCell2 without a gt "
                                 "needs target_size")
            target = tuple(self.target_size[-2:])

        coord = make_coord_np(target)
        if self.sample_quantity is not None and "gt" in results:
            sel = _rng(results).choice(len(coord), self.sample_quantity,
                                       replace=False)
            coord = coord[sel]
            results["gt"] = np.ascontiguousarray(results["gt"][sel])

        cell = np.ones_like(coord)
        cell[:, 0] *= 2 / target[-2]
        cell[:, 1] *= 2 / target[-1]
        results["coord"] = coord
        results["cell"] = cell
        results["target_size"] = target
        return results


@PIPELINES.register(name="RandomCrop")
class RandomCrop:
    """A random ``patch_size`` square of each of ``keys`` (one draw pair
    per key)."""

    def __init__(self, patch_size, keys=("gt",)):
        self.patch_size = patch_size
        self.keys = keys

    def __call__(self, results):
        rng = _rng(results)
        p = self.patch_size
        for k in self.keys:
            img = results[k]
            h, w = img.shape[:2]
            y0 = int(rng.integers(0, max(h - p, 0) + 1))
            x0 = int(rng.integers(0, max(w - p, 0) + 1))
            results[k] = img[y0:y0 + p, x0:x0 + p]
        return results


@PIPELINES.register(name="ContinuousPairedRandomCrop")
class ContinuousPairedRandomCrop:
    """Paired crop at the float scale gt/lq: an ``lq_patch_size`` lq patch
    and the gt patch at the rounded scaled offset and size."""

    def __init__(self, lq_patch_size, keys=("lq", "gt")):
        self.lq_patch_size = lq_patch_size
        self.keys = keys

    def __call__(self, results):
        lq, gt = results["lq"], results["gt"]
        scale = gt.shape[0] / lq.shape[0]
        p = self.lq_patch_size
        rng = _rng(results)
        y0 = int(rng.integers(0, lq.shape[0] - p + 1))
        x0 = int(rng.integers(0, lq.shape[1] - p + 1))
        gp = round(p * scale)
        results["lq"] = lq[y0:y0 + p, x0:x0 + p]
        yg, xg = round(y0 * scale), round(x0 * scale)
        results["gt"] = gt[yg:yg + gp, xg:xg + gp]
        return results


@PIPELINES.register(name="Crop")
class Crop:
    """A random (or centre) ``crop_size`` (h, w) crop of each of ``keys``."""

    def __init__(self, keys, crop_size, random_crop=True, **kwargs):
        self.keys = keys
        self.crop_size = crop_size
        self.random_crop = random_crop

    def __call__(self, results):
        ch, cw = self.crop_size
        for k in self.keys:
            img = results[k]
            h, w = img.shape[:2]
            if self.random_crop:
                rng = _rng(results)
                y0 = int(rng.integers(0, max(h - ch, 0) + 1))
                x0 = int(rng.integers(0, max(w - cw, 0) + 1))
            else:
                y0, x0 = max(0, (h - ch) // 2), max(0, (w - cw) // 2)
            results[k] = img[y0:y0 + ch, x0:x0 + cw]
        return results


@PIPELINES.register(name="ModCrop")
class ModCrop:
    """Cut ``key`` to a multiple of int(results['scale']) (default 1)."""

    def __init__(self, key="gt"):
        self.key = key

    def __call__(self, results):
        img = results[self.key]
        scale = int(results.get("scale", 1))
        h, w = img.shape[:2]
        results[self.key] = img[: h - h % scale, : w - w % scale]
        return results


@PIPELINES.register(name="PairedRandomCrop")
class PairedRandomCrop:
    """Paired lq / gt random crop at the integer scale gt // lq."""

    def __init__(self, gt_patch_size):
        self.gt_patch_size = gt_patch_size

    def __call__(self, results):
        lq, gt = results["lq"], results["gt"]
        scale = gt.shape[0] // lq.shape[0]
        lq_patch = self.gt_patch_size // scale
        rng = _rng(results)
        y0 = int(rng.integers(0, lq.shape[0] - lq_patch + 1))
        x0 = int(rng.integers(0, lq.shape[1] - lq_patch + 1))
        results["lq"] = lq[y0:y0 + lq_patch, x0:x0 + lq_patch]
        results["gt"] = gt[y0 * scale:y0 * scale + self.gt_patch_size,
                           x0 * scale:x0 * scale + self.gt_patch_size]
        return results


@PIPELINES.register(name="PairedRandomCropwScale")
class PairedRandomCropwScale:
    """Paired crop at the float scale gt/lq (equal in H and W): a fixed lq
    patch, the gt patch int(lq_patch·scale) at int(offset·scale)."""

    def __init__(self, lq_patch_size):
        self.lq_patch_size = lq_patch_size

    def __call__(self, results):
        lq, gt = results["lq"], results["gt"]
        h_lq, w_lq = lq.shape[:2]
        h_gt, w_gt = gt.shape[:2]
        scale = h_gt / h_lq
        if h_gt / h_lq != w_gt / w_lq:
            raise ValueError(
                f"Scale mismatches: GT {(h_gt, w_gt)} is not {scale}x of "
                f"LQ {(h_lq, w_lq)}")
        p = self.lq_patch_size
        if h_lq < p or w_lq < p:
            raise ValueError(f"LQ {(h_lq, w_lq)} smaller than patch {p}")
        gp = int(p * scale)
        rng = _rng(results)
        y0 = int(rng.integers(0, h_lq - p + 1))
        x0 = int(rng.integers(0, w_lq - p + 1))
        results["lq"] = lq[y0:y0 + p, x0:x0 + p]
        yg, xg = int(y0 * scale), int(x0 * scale)
        results["gt"] = gt[yg:yg + gp, xg:xg + gp]
        return results


@PIPELINES.register(name="CopyValues")
class CopyValues:
    def __init__(self, src_keys, dst_keys):
        self.src_keys = src_keys
        self.dst_keys = dst_keys

    def __call__(self, results):
        for s, d in zip(self.src_keys, self.dst_keys):
            results[d] = np.copy(results[s]) \
                if isinstance(results[s], np.ndarray) else results[s]
        return results


@PIPELINES.register(name="Quantize")
class Quantize:
    """Round float [0, 1] images to 8-bit levels (they stay float32)."""

    def __init__(self, keys):
        self.keys = keys

    def __call__(self, results):
        for k in self.keys:
            results[k] = np.clip(
                np.round(results[k] * 255.0) / 255.0, 0.0, 1.0
            ).astype(np.float32)
        return results


# the Real-ESRGAN degradation ops of ciaosr_tpu/data/degradations.py, which
# the 002 configs' train pipelines run; not ported yet
DEGRADATIONS = frozenset((
    "RandomBlur", "RandomResize", "RandomNoise", "RandomJPEGCompression",
    "RandomScaleResize1", "DegradationsWithShuffle",
    "DegradationsWithShuffle1", "UnsharpMasking", "RandomGaussianNoise",
    "RandomGaussianNoisewithPro", "RandomClipGaussianNoise", "RandomLevel",
    "RealRandomNoise", "RealRandomResize", "UVSRDegradation",
    "RandomVideoCompression", "OldRandomNoise", "NorResize"))


def build_op(cfg):
    """A pipeline op from its config dict; a degradation op raises."""
    if cfg.get("type") in DEGRADATIONS:
        raise NotImplementedError(
            f"pipeline op {cfg['type']!r} is a Real-ESRGAN degradation "
            "(ciaosr_tpu/data/degradations.py), not ported yet: ROADMAP "
            "queue 1 item 7 (data/degradations.py)")
    return build_from_cfg(cfg, PIPELINES)


class Compose:
    def __init__(self, ops):
        self.ops = [op if callable(op) and not isinstance(op, dict)
                    else build_op(op) for op in ops]

    def __call__(self, results):
        for op in self.ops:
            results = op(results)
            if results is None:
                return None
        return results
