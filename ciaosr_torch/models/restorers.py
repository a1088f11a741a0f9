"""Eval restorer around CiaoSRNet: normalization, dense-grid prediction,
overlap-average tiling and the metric protocol.

Counterpart of ciaosr_tpu/models/restorers.py::CiaoSRRestorer for integer
scales. Rational scales and the per-query chunked path are not ported yet
(ROADMAP.md queue 1 items 5 and 7). The module holds its weights; there
is no params argument.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Any

import numpy as np
import torch

from ciaosr_torch.core.color import tensor2img
from ciaosr_torch.core.metrics import psnr, ssim
from ciaosr_torch.models.builder import build_generator

_RATIONAL = ("rational scales are not ported yet: ROADMAP.md queue 1 "
             "item 7")


def _int_scale(scale) -> int:
    f = Fraction(scale).limit_denominator(64) if isinstance(scale, float) \
        else Fraction(scale)
    if f.denominator != 1 or f < 1:
        raise NotImplementedError(f"scale {scale}: {_RATIONAL}")
    return int(f)


class CiaoSRRestorer:
    """Classical CiaoSR restorer (eval). Runs on ``device`` (default: the
    CUDA device; raises without one unless ``device="cpu"``)."""

    allowed_metrics = {"PSNR": psnr, "SSIM": ssim}

    def __init__(self, generator: dict, rgb_mean=(0.4488, 0.4371, 0.4040),
                 rgb_std=(1.0, 1.0, 1.0), test_cfg: Any = None, *,
                 device=None, seed: int = 0):
        self.generator = build_generator(generator, device=device, seed=seed)
        self.device = next(self.generator.parameters()).device
        self.rgb_mean = torch.tensor(rgb_mean, dtype=torch.float32,
                                     device=self.device)
        self.rgb_std = torch.tensor(rgb_std, dtype=torch.float32,
                                    device=self.device)
        self.test_cfg = test_cfg or {}

    # ----------------------------------------------------------- forward --
    def normalize(self, img: torch.Tensor) -> torch.Tensor:
        return (img - self.rgb_mean) / self.rgb_std

    def denormalize(self, rgb: torch.Tensor) -> torch.Tensor:
        return rgb * self.rgb_std + self.rgb_mean

    @torch.inference_mode()
    def _decode(self, lq_tiles: torch.Tensor, scale: int) -> torch.Tensor:
        """Denormalized dense-grid decode, NOT clamped."""
        img = self.generator.decode_grid(self.normalize(lq_tiles), scale)
        return self.denormalize(img)

    def grid_predict(self, lq_tiles: torch.Tensor, scale) -> torch.Tensor:
        """(N, h, w, 3) LR tiles in [0, 1] on the device → (N, s·h, s·w, 3)
        clamped to [0, 1] (JAX ``_grid_fn``)."""
        return torch.clamp(self._decode(lq_tiles, _int_scale(scale)),
                           0.0, 1.0)

    def _to_device(self, lq: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(lq, np.float32),
                               device=self.device)

    def predict(self, lq: np.ndarray, target_shape) -> np.ndarray:
        """Full-image SR to an integer multiple of the LR size:
        lq (H, W, 3) → (th, tw, 3)."""
        th, tw = target_shape
        h, w = lq.shape[:2]
        if th % h or tw % w or th // h != tw // w or th < h:
            raise NotImplementedError(
                f"target {th}x{tw} from {h}x{w} is not an integer scale: "
                f"{_RATIONAL} (per-query decode: ROADMAP.md queue 1 item 5)")
        out = self.grid_predict(self._to_device(lq)[None], th // h)
        return out[0].cpu().numpy()

    @torch.inference_mode()
    def predict_tiled(self, lq: np.ndarray, scale, tile: int,
                      tile_overlap: int = 32) -> np.ndarray:
        """Overlap-average tiling with fixed (tile, tile) LR tiles; the
        tile outputs are averaged on the device and clamped once, after
        the average (a per-tile clamp would disagree wherever a prediction
        leaves [0, 1] under one tile but not its neighbour)."""
        s = _int_scale(scale)
        h, w = lq.shape[:2]
        tile = min(tile, h, w)
        stride = max(tile - tile_overlap, 1)
        hs = sorted(set(list(range(0, h - tile, stride)) + [h - tile]))
        ws = sorted(set(list(range(0, w - tile, stride)) + [w - tile]))
        lq_t = self._to_device(lq)
        acc = torch.zeros(h * s, w * s, 3, device=self.device)
        cnt = torch.zeros(h * s, w * s, 1, device=self.device)
        for hi in hs:
            for wi in ws:
                out = self._decode(lq_t[None, hi:hi + tile, wi:wi + tile], s)
                acc[hi * s:(hi + tile) * s, wi * s:(wi + tile) * s] += out[0]
                cnt[hi * s:(hi + tile) * s, wi * s:(wi + tile) * s] += 1.0
        return torch.clamp(acc / cnt, 0.0, 1.0).cpu().numpy()

    def forward_test(self, lq: np.ndarray, target_shape=None,
                     scale=None) -> np.ndarray:
        """Tiled when test_cfg.tile is set, otherwise full-image."""
        cfg = self.test_cfg
        scale = scale if scale is not None else cfg.get("scale")
        if cfg.get("tile"):
            return self.predict_tiled(lq, scale, int(cfg["tile"]),
                                      int(cfg.get("tile_overlap", 32)))
        if target_shape is None:
            s = _int_scale(scale)
            target_shape = (lq.shape[0] * s, lq.shape[1] * s)
        return self.predict(lq, target_shape)

    def evaluate(self, output: np.ndarray, gt: np.ndarray) -> dict:
        """Metric protocol: uint8 BGR images, crop_border and convert_to
        from test_cfg."""
        cfg = self.test_cfg
        out_img, gt_img = tensor2img(output), tensor2img(gt)
        return {name: self.allowed_metrics[name](
                    out_img, gt_img, crop_border=cfg.get("crop_border", 0),
                    convert_to=cfg.get("convert_to"))
                for name in cfg.get("metrics", ["PSNR"])}
