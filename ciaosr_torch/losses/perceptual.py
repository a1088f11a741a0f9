"""Perceptual (VGG19 feature) and style (Gram) loss.

Counterpart of ciaosr_tpu/losses/perceptual.py: per-layer weights over
``VGG19Features`` taps, an L1 or MSE criterion, the Gram style term and
the unconditional ``norm_img`` map [-1, 1] → [0, 1]. Images are NCHW.
VGG's parameters are frozen; gradients reach the prediction only.

Weights load lazily, at the first call, in this order: the
``pretrained=`` path; else the ``CIAOSR_VGG19_WEIGHTS`` file; else, as an
explicit opt-in, ``pretrained="synthetic"`` or ``CIAOSR_VGG19_SYNTHETIC``:
seeded random weights (the port's own draw, which cannot equal the JAX
package's flax init), with a warning; else ``FileNotFoundError``. No
weights are ever downloaded.
"""

from __future__ import annotations

import logging
import os

import torch

from ciaosr_torch.config.registry import LOSSES
from ciaosr_torch.models.vgg import VGG19Features

SYNTHETIC_SEED = 7


def gram(feat: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, C, C) / (H·W·C)."""
    b, c, h, w = feat.shape
    f = feat.reshape(b, c, h * w)
    return f @ f.transpose(1, 2) / (h * w * c)


@LOSSES.register(name="PerceptualLoss")
class PerceptualLoss:
    def __init__(self, layer_weights: dict, vgg_type: str = "vgg19",
                 use_input_norm: bool = True, perceptual_weight: float = 1.0,
                 style_weight: float = 0.0, norm_img: bool = True,
                 criterion: str = "l1", pretrained: str | None = None):
        if vgg_type != "vgg19":
            raise ValueError("only vgg19 is supported")
        self.layer_weights = {int(k): float(v)
                              for k, v in layer_weights.items()}
        self.perceptual_weight = perceptual_weight
        self.style_weight = style_weight
        self.norm_img = norm_img
        self.criterion = criterion
        self.vgg = VGG19Features(tuple(sorted(self.layer_weights)),
                                 use_input_norm).requires_grad_(False)
        self._pretrained = pretrained
        self.loaded = False

    def load_weights(self) -> None:
        """Load (or, on the explicit opt-in, draw) VGG19's weights."""
        path = self._pretrained or os.environ.get("CIAOSR_VGG19_WEIGHTS")
        if path == "synthetic" or (not path and os.environ.get(
                "CIAOSR_VGG19_SYNTHETIC")):
            logging.getLogger(__name__).warning(
                "PerceptualLoss: using SYNTHETIC (random) VGG19 weights — "
                "perceptual values are not comparable to the reference's "
                "pretrained features")
            self.vgg.init_synthetic_(SYNTHETIC_SEED)
        elif not path or not os.path.exists(path):
            raise FileNotFoundError(
                "PerceptualLoss needs pretrained VGG19 weights. Pass "
                "pretrained=<path to torchvision vgg19 .pth> in the loss "
                "config or set CIAOSR_VGG19_WEIGHTS (or "
                "CIAOSR_VGG19_SYNTHETIC=1 for explicitly-synthetic "
                "soak/benchmark runs). (No network access: the reference "
                "downloads them via torchvision.)")
        else:
            sd = torch.load(path, map_location="cpu", weights_only=False)
            sd = sd.get("state_dict", sd) if isinstance(sd, dict) else sd
            self.vgg.load_torchvision_(sd)
        self.loaded = True

    def _crit(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.criterion == "l1":
            return torch.mean(torch.abs(a - b))
        return torch.mean((a - b) ** 2)

    def __call__(self, x: torch.Tensor, gt: torch.Tensor):
        """x, gt: (B, 3, H, W) → (perceptual or None, style or None)."""
        if not self.loaded:
            self.load_weights()
        self.vgg.to(x.device)
        if self.norm_img:
            x = (x + 1.0) * 0.5
            gt = (gt + 1.0) * 0.5
        fx, fgt = self.vgg(x), self.vgg(gt)
        percep = style = None
        if self.perceptual_weight > 0:
            percep = sum(w * self._crit(fx[k], fgt[k])
                         for k, w in self.layer_weights.items()) \
                * self.perceptual_weight
        if self.style_weight > 0:
            style = sum(w * self._crit(gram(fx[k]), gram(fgt[k]))
                        for k, w in self.layer_weights.items()) \
                * self.style_weight
        return percep, style
