"""Real-world GAN restorer: the generator, its EMA copy and a U-Net
discriminator, with pixel, perceptual and GAN losses.

Counterpart of ciaosr_tpu/models/real_restorer.py (``RealCiaoSR``). One
train step (``make_gan_train_step``), in the JAX step's order:

1. at ``start_iter`` the generator is re-seeded from the EMA copy;
2. the generator phase, when ``step % disc_steps == 0`` and ``step >=
   disc_init_steps``: pixel, perceptual and GAN losses on the targets the
   three ``is_use_sharpened_gt_in_*`` flags route (``gt_unsharp`` or
   ``gt``), the discriminator's forward with ``update_stats=False`` and
   no gradient into it, then the generator's optimizer and schedule step.
   A gated step runs the generator forward without grad (the fakes for
   the discriminator) and reports zeros under the same loss keys;
3. the discriminator phase: real, then fake (detached), both with
   ``update_stats=True`` (the fake pass starts from the ``u`` the real
   pass stored), then its optimizer and schedule step;
4. the EMA update on every step, e·m + p·(1 − m), in place (so the Swin
   blocks' packed-weight cache, keyed on version counters, sees it).

The flat queries (B, ns, 3) become (B, √ns, √ns, 3) images row-major and
only then NCHW: a contiguous run of ns queries from a wider crop is a
strip, and the reshape makes a square of it (the reference's quirk, kept).
``forward_test`` evaluates the EMA copy when ``is_use_ema``.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from ciaosr_torch.config.registry import (COMPONENTS, LOSSES, MODELS,
                                          build_from_cfg)
from ciaosr_torch.core import trace
from ciaosr_torch.models.builder import init_weights_
from ciaosr_torch.models.restorers import CiaoSRRestorer
from ciaosr_torch.parallel.mesh import all_reduce_grads
import ciaosr_torch.losses.gan  # noqa: F401  (registers the losses)
import ciaosr_torch.losses.perceptual  # noqa: F401
import ciaosr_torch.models.discriminator  # noqa: F401  (registers D)


@dataclass
class GANTrainState:
    """What a GAN step changes besides the restorer's modules: the step
    count, both optimizers and both schedules (the discriminator's None
    without a discriminator)."""
    step: int
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer | None
    g_sched: Any
    d_sched: Any


def query_images(flat: torch.Tensor) -> torch.Tensor:
    """(B, ns, 3) queries → (B, 3, √ns, √ns): reshaped row-major to
    (B, √ns, √ns, 3) first, then made NCHW."""
    b, ns, c = flat.shape
    side = math.isqrt(ns)
    return flat.reshape(b, side, side, c).permute(0, 3, 1, 2)


@MODELS.register(name="RealCiaoSR")
class RealCiaoSRRestorer(CiaoSRRestorer):
    def __init__(self, generator: dict, discriminator: dict | None = None,
                 rgb_mean=(0.4488, 0.4371, 0.4040), rgb_std=(1.0, 1.0, 1.0),
                 pixel_loss: dict | None = None,
                 perceptual_loss: dict | None = None,
                 gan_loss: dict | None = None,
                 is_use_sharpened_gt_in_pixel: bool = False,
                 is_use_sharpened_gt_in_percep: bool = False,
                 is_use_sharpened_gt_in_gan: bool = False,
                 is_use_ema: bool = True, train_cfg: Any = None,
                 test_cfg: Any = None, *, device=None, seed: int = 0):
        super().__init__(generator=generator, rgb_mean=rgb_mean,
                         rgb_std=rgb_std, pixel_loss=pixel_loss,
                         train_cfg=train_cfg, test_cfg=test_cfg,
                         device=device, seed=seed)
        self.generator_ema = copy.deepcopy(self.generator).requires_grad_(
            False)
        self.discriminator = None
        if discriminator:
            disc = build_from_cfg(discriminator, COMPONENTS)
            init_weights_(disc, seed + 1)
            disc.init_stats_(seed + 1)
            self.discriminator = disc.to(self.device)
        self.pixel_loss = build_from_cfg(pixel_loss, LOSSES) \
            if pixel_loss else None
        self.gan_loss = build_from_cfg(gan_loss, LOSSES) if gan_loss else None
        self.perceptual_loss = build_from_cfg(perceptual_loss, LOSSES) \
            if perceptual_loss else None
        self.use_sharp_pixel = is_use_sharpened_gt_in_pixel
        self.use_sharp_percep = is_use_sharpened_gt_in_percep
        self.use_sharp_gan = is_use_sharpened_gt_in_gan
        self.is_use_ema = is_use_ema
        tc = dict(train_cfg or {})
        self.disc_steps = tc.get("disc_steps", 1)
        self.disc_init_steps = tc.get("disc_init_steps", 0)
        self.ema_momentum = tc.get("ema_momentum", 0.999)
        # the step at which the generator re-seeds from the EMA copy; -1:
        # never (the reference's default)
        self.ema_start_iter = tc.get("start_iter", -1)

    @property
    def has_gan(self) -> bool:
        return self.discriminator is not None and self.gan_loss is not None

    def loss_keys(self) -> list[str]:
        """The generator phase's loss keys, in the order they add up."""
        keys = ["loss_pix"] if self.pixel_loss else []
        if self.perceptual_loss:
            if self.perceptual_loss.perceptual_weight > 0:
                keys.append("loss_perceptual")
            if self.perceptual_loss.style_weight > 0:
                keys.append("loss_style")
        if self.has_gan:
            keys.append("loss_gan")
        return keys

    def _targets(self, batch: dict) -> tuple:
        gt = self.normalize(batch["gt"])
        unsharp = self.normalize(batch["gt_unsharp"]) \
            if "gt_unsharp" in batch else gt
        return gt, unsharp

    def generator_losses(self, batch: dict):
        """(total, {key: loss}, fake images (B, 3, √ns, √ns)) of the
        generator phase, with the graph into the generator's parameters."""
        gt, unsharp = self._targets(batch)
        pred = self.generator(self.normalize(batch["lq"]), batch["coord"],
                              batch["cell"])
        pred_img = query_images(pred)
        losses: dict = {}
        total = 0.0
        if self.pixel_loss:
            losses["loss_pix"] = self.pixel_loss(
                pred, unsharp if self.use_sharp_pixel else gt)
            total = total + losses["loss_pix"]
        if self.perceptual_loss:
            percep, style = self.perceptual_loss(pred_img, query_images(
                unsharp if self.use_sharp_percep else gt))
            if percep is not None:
                losses["loss_perceptual"] = percep
                total = total + percep
            if style is not None:
                losses["loss_style"] = style
                total = total + style
        if self.has_gan:
            fake = self.discriminator(pred_img, update_stats=False)
            losses["loss_gan"] = self.gan_loss(fake, True, is_disc=False)
            total = total + losses["loss_gan"]
        return total, losses, pred_img

    def make_gan_train_step(self, g_opt: torch.optim.Optimizer,
                            d_opt: torch.optim.Optimizer | None,
                            schedulers: tuple, mesh=None) -> Callable:
        """``train_step(state, batch) -> (state, metrics)``; ``batch``:
        lq (B, H, W, 3), gt and optionally gt_unsharp (B, ns, 3), coord and
        cell (B, ns, 2) on the device; ``schedulers``: (the generator's,
        the discriminator's or None). Metrics are device tensors. Under a
        ``mesh`` (parallel/mesh.py) each optimizer steps on the gradients'
        mean over the ranks, so the weights, and with them the EMA copy and
        the spectral norms' ``u``, stay equal on every rank."""
        g_sched, d_sched = schedulers
        gen, ema, disc = self.generator, self.generator_ema, \
            self.discriminator
        live_p, ema_p = list(gen.parameters()), list(ema.parameters())
        disc_p = list(disc.parameters()) if disc is not None else []
        m = self.ema_momentum

        def train_step(state: GANTrainState, batch: dict):
            step = state.step
            with trace.span("train.step", request=step):
                trace.count("train.steps")
                return phases(state, batch, step)

        def phases(state: GANTrainState, batch: dict, step: int):
            if self.ema_start_iter >= 0 and step == self.ema_start_iter:
                with torch.no_grad():
                    torch._foreach_copy_(live_p, ema_p)

            # ---- generator phase, gated
            if step % self.disc_steps == 0 and step >= self.disc_init_steps:
                if disc is not None:
                    disc.requires_grad_(False)
                g_opt.zero_grad(set_to_none=True)
                with trace.span("train.forward", device=True):
                    total, losses, pred_img = self.generator_losses(batch)
                with trace.span("train.backward", device=True):
                    total.backward()
                if mesh is not None:
                    with trace.span("train.all_reduce", device=True):
                        all_reduce_grads(mesh, live_p)
                with trace.span("train.optimizer", device=True):
                    g_opt.step()
                    g_sched.step()
                losses = {k: v.detach() for k, v in losses.items()}
            else:
                with torch.no_grad(), trace.span("train.forward",
                                                 device=True):
                    pred_img = query_images(self.generator(
                        self.normalize(batch["lq"]), batch["coord"],
                        batch["cell"]))
                zero = torch.zeros((), device=self.device)
                losses = {k: zero for k in self.loss_keys()}

            # ---- discriminator phase
            if self.has_gan:
                with trace.span("train.disc", device=True):
                    disc.requires_grad_(True)
                    gt, unsharp = self._targets(batch)
                    gt_img = query_images(unsharp if self.use_sharp_gan
                                          else gt)
                    d_opt.zero_grad(set_to_none=True)
                    loss_real = self.gan_loss(disc(gt_img, update_stats=True),
                                              True, is_disc=True)
                    loss_fake = self.gan_loss(disc(pred_img.detach(),
                                                   update_stats=True),
                                              False, is_disc=True)
                    (loss_real + loss_fake).backward()
                    all_reduce_grads(mesh, disc_p)
                    d_opt.step()
                    d_sched.step()
                losses["loss_d_real"] = loss_real.detach()
                losses["loss_d_fake"] = loss_fake.detach()

            # ---- EMA, on every step, in place
            with torch.no_grad(), trace.span("train.ema", device=True):
                torch._foreach_mul_(ema_p, m)
                torch._foreach_add_(ema_p, live_p, alpha=1.0 - m)
            state.step += 1
            return state, losses

        return train_step

    def forward_test(self, lq, target_shape=None, scale=None, mesh=None):
        """``CiaoSRRestorer.forward_test`` of the EMA copy when
        ``is_use_ema`` (the reference's inference), else of the
        generator."""
        if not self.is_use_ema:
            return super().forward_test(lq, target_shape, scale, mesh)
        live = self.generator
        self.generator = self.generator_ema
        try:
            return super().forward_test(lq, target_shape, scale, mesh)
        finally:
            self.generator = live
