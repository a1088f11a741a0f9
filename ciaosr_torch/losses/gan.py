"""Adversarial and pixel losses.

Counterpart of ciaosr_tpu/losses/gan.py (the mmedit ``GANLoss`` surface):
``vanilla`` (BCE with logits in its stable form), ``lsgan`` (MSE),
``wgan``, ``hinge`` and ``smgan`` (soft-mask GAN). The generator's loss is
scaled by ``loss_weight``, the discriminator's never. Predictions and
masks are NCHW, as the discriminator gives them. Pixel losses:
``L1Loss``, ``MSELoss``, ``CharbonnierLoss`` with ``mean`` / ``sum`` /
``none`` reductions and an optional elementwise weight.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ciaosr_torch.config.registry import LOSSES

GAN_TYPES = ("vanilla", "lsgan", "wgan", "hinge", "smgan")


def _bce_with_logits(x: torch.Tensor, target: float) -> torch.Tensor:
    # max(x, 0) - x·t + log(1 + exp(-|x|)), as the JAX package writes it
    return torch.mean(torch.clamp(x, min=0) - x * target
                      + torch.log1p(torch.exp(-torch.abs(x))))


def interp_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """NCHW bilinear resize with align_corners=True: source coordinate
    dst · (in − 1) / (out − 1) (the smgan branch's resize of the
    prediction to the mask's size)."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


def gaussian_blur_71(mask: torch.Tensor, kernel_size: int = 71,
                     sigma: float = 10.0) -> torch.Tensor:
    """Depthwise 2-D Gaussian blur with zero padding (the smgan
    discriminator's fake target); NCHW."""
    x = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    k2 = torch.as_tensor(np.outer(g, g), dtype=torch.float32,
                         device=mask.device)
    c = mask.shape[1]
    kernel = k2[None, None].expand(c, 1, -1, -1)
    return F.conv2d(mask, kernel, padding=(kernel_size - 1) // 2, groups=c)


@LOSSES.register(name="GANLoss")
class GANLoss:
    """gan_type ∈ {vanilla, lsgan, wgan, hinge, smgan}."""

    def __init__(self, gan_type: str = "vanilla", real_label_val: float = 1.0,
                 fake_label_val: float = 0.0, loss_weight: float = 1.0):
        if gan_type not in GAN_TYPES:
            raise ValueError(f"unsupported gan_type {gan_type}")
        self.gan_type = gan_type
        self.real_label_val = real_label_val
        self.fake_label_val = fake_label_val
        self.loss_weight = loss_weight

    def __call__(self, pred: torch.Tensor, target_is_real: bool,
                 is_disc: bool = False,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
        label = self.real_label_val if target_is_real \
            else self.fake_label_val
        if self.gan_type == "vanilla":
            loss = _bce_with_logits(pred, label)
        elif self.gan_type == "lsgan":
            loss = torch.mean((pred - label) ** 2)
        elif self.gan_type == "wgan":
            loss = -torch.mean(pred) if target_is_real else torch.mean(pred)
        elif self.gan_type == "hinge":
            if is_disc:
                loss = torch.mean(torch.relu(1 - pred if target_is_real
                                             else 1 + pred))
            else:
                loss = -torch.mean(pred)
        elif mask is not None and is_disc and not target_is_real:
            # smgan's discriminator on fakes: the blurred mask is the target
            if pred.shape[2:] != mask.shape[2:]:
                pred = interp_bilinear_align_corners(pred, *mask.shape[2:])
            loss = torch.mean((pred - gaussian_blur_71(mask).detach()) ** 2)
        else:
            # smgan otherwise: the reference scales the scalar mean by
            # mask / mask.mean() and means again, which cancels, so it is
            # the plain MSE (after the same resize when a mask is given)
            if mask is not None and pred.shape[2:] != mask.shape[2:]:
                pred = interp_bilinear_align_corners(pred, *mask.shape[2:])
            loss = torch.mean((pred - label) ** 2)
        return loss if is_disc else loss * self.loss_weight


def _reduce(x: torch.Tensor, reduction: str, weight=None) -> torch.Tensor:
    if weight is not None:
        x = x * weight
    if reduction == "mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    return x


@LOSSES.register(name="L1Loss")
class L1Loss:
    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean"):
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * _reduce(torch.abs(pred - target),
                                          self.reduction, weight)


@LOSSES.register(name="MSELoss")
class MSELoss:
    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean"):
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * _reduce((pred - target) ** 2,
                                          self.reduction, weight)


@LOSSES.register(name="CharbonnierLoss")
class CharbonnierLoss:
    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean",
                 eps: float = 1e-12):
        self.loss_weight = loss_weight
        self.reduction = reduction
        self.eps = eps

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * _reduce(
            torch.sqrt((pred - target) ** 2 + self.eps), self.reduction,
            weight)
