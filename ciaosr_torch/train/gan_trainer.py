"""GAN (real-world) training: two optimizers, the EMA copy, staged
``load_from``.

Counterpart of ciaosr_tpu/train/gan_trainer.py. ``GANTrainer`` runs the
``Trainer`` loop (train/trainer.py: log, eval and checkpoint hooks,
auto-resume, ``resume_from``) over ``RealCiaoSRRestorer.
make_gan_train_step``, with ``cfg.optimizers.generator`` and
``.discriminator`` (the generator's when absent; none without a
discriminator, where the JAX package inits optax on an empty tree), both
on ``lr_config``'s schedule, data-parallel over the ``Trainer``'s mesh
(the generator's and the discriminator's gradients each averaged over
the ranks before their optimizer steps; the three modules broadcast from
rank 0 after the resume). Before resuming it seeds the generator and
its EMA copy from ``cfg.load_from`` (train/checkpoint.py::
load_staged_generator). Its checkpoints hold ``generator.``,
``generator_ema.`` and ``discriminator.`` tensors, and ``optimizer`` and
``scheduler`` dicts under ``generator`` and ``discriminator``.
"""

from __future__ import annotations

import torch

from ciaosr_torch.models.real_restorer import GANTrainState
from ciaosr_torch.train.checkpoint import load_staged_generator
from ciaosr_torch.train.optim import build_optimizer
from ciaosr_torch.train.trainer import Trainer, _to_cpu


class GANTrainer(Trainer):
    """Real-world GAN training of ``restorer`` (a RealCiaoSRRestorer), in
    place."""

    def _make_step(self):
        """The generator's and the discriminator's optimizers and
        schedules (``self.optimizer``, ``self.scheduler``; ``self.
        d_optimizer``, ``self.d_scheduler``), the state at step 0 and
        ``make_gan_train_step``."""
        r = self.restorer
        opt_cfg = dict(self.cfg.optimizers)
        lr_cfg = dict(self.cfg.get("lr_config") or {})
        self.optimizer, self.scheduler = build_optimizer(
            r.generator.parameters(), dict(opt_cfg["generator"]), lr_cfg)
        self.d_optimizer = self.d_scheduler = None
        if r.discriminator is not None:
            self.d_optimizer, self.d_scheduler = build_optimizer(
                r.discriminator.parameters(),
                dict(opt_cfg.get("discriminator", opt_cfg["generator"])),
                lr_cfg)
        state = GANTrainState(0, self.optimizer, self.d_optimizer,
                              self.scheduler, self.d_scheduler)
        return state, r.make_gan_train_step(
            self.optimizer, self.d_optimizer,
            (self.scheduler, self.d_scheduler), self.mesh)

    def _modules(self) -> dict:
        r = self.restorer
        mods = {"generator": r.generator, "generator_ema": r.generator_ema}
        if r.discriminator is not None:
            mods["discriminator"] = r.discriminator
        return mods

    def _optimizers(self) -> dict:
        opts = {"generator": (self.optimizer, self.scheduler)}
        if self.d_optimizer is not None:
            opts["discriminator"] = (self.d_optimizer, self.d_scheduler)
        return opts

    def state_dict(self) -> dict:
        sd = {f"{name}.{k}": v.detach().cpu()
              for name, mod in self._modules().items()
              for k, v in mod.state_dict().items()}
        opts = self._optimizers()
        return {
            "meta": {"iter": self.state.step, "config": self.cfg.text,
                     "torch": torch.__version__},
            "state_dict": sd,
            "optimizer": {k: _to_cpu(o.state_dict())
                          for k, (o, _) in opts.items()},
            "scheduler": {k: s.state_dict() for k, (_, s) in opts.items()},
            "step": self.state.step,
        }

    def load_state_dict(self, ckpt: dict) -> None:
        sd = ckpt["state_dict"]
        for name, mod in self._modules().items():
            pfx = f"{name}."
            mod.load_state_dict({k[len(pfx):]: v for k, v in sd.items()
                                 if k.startswith(pfx)}, strict=True)
        for k, (opt, sched) in self._optimizers().items():
            opt.load_state_dict(ckpt["optimizer"][k])
            sched.load_state_dict(ckpt["scheduler"][k])
        self.state.step = int(ckpt["step"])

    def _maybe_resume(self) -> None:
        """The staged ``load_from`` (generator and EMA copy), then the
        classical resume rules."""
        load_from = self.cfg.get("load_from")
        if load_from:
            gen, ema = load_staged_generator(load_from, self.cfg.model)
            self.restorer.generator.load_state_dict(gen, strict=True)
            self.restorer.generator_ema.load_state_dict(ema, strict=True)
            self.progress(f"[load_from] generator and its EMA copy from "
                          f"{load_from}")
        super()._maybe_resume()
