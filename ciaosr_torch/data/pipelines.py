"""Host-side eval pipeline ops (numpy), the mmedit pipeline surface.

Counterpart of the ops of ciaosr_tpu/data/pipelines.py that the 001
configs' ``test_pipeline`` and ``valid_pipeline`` name, and ``Compose``.
Each op is a callable ``op(results: dict) -> dict``; keys follow the
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


class Compose:
    def __init__(self, ops):
        self.ops = [op if callable(op) and not isinstance(op, dict)
                    else build_from_cfg(op, PIPELINES) for op in ops]

    def __call__(self, results):
        for op in self.ops:
            results = op(results)
            if results is None:
                return None
        return results
