"""Optimizers and LR schedules from reference-style config dicts.

Counterpart of ciaosr_tpu/train/optim.py (optax): Adam, AdamW and SGD map
to ``torch.optim`` with the JAX package's hyper-parameters, and the Step
policy to a ``LambdaLR`` whose lr at update k (0-based, before k
``scheduler.step()`` calls) equals ``optax.piecewise_constant_schedule``
at count k: base·γ^(number of boundaries ≤ k). As in the JAX package,
AdamW takes only ``weight_decay`` from its config (optax's default betas
and eps), and SGD only ``momentum``.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def build_schedule(base_lr: float,
                   lr_config: dict | None) -> Callable[[int], float]:
    """lr at update count k (0-based)."""
    policy = (lr_config or {}).get("policy", "Fixed" if not lr_config
                                   else "Step")
    if policy in ("Fixed", "fixed"):
        return lambda k: base_lr
    if policy not in ("Step", "step"):
        raise ValueError(f"unsupported lr policy {policy}")
    gamma = lr_config.get("gamma", 0.5)
    steps = sorted(int(s) for s in lr_config.get("step", []))

    def schedule(k: int) -> float:
        lr = base_lr
        for s in steps:
            if k >= s:
                lr *= gamma
        return lr

    return schedule


def build_optimizer(params: Iterable[torch.nn.Parameter], opt_cfg: dict,
                    lr_config: dict | None = None):
    """(optimizer, scheduler) for ``params``; call ``scheduler.step()``
    after every ``optimizer.step()``."""
    cfg = dict(opt_cfg)
    otype = cfg.pop("type", "Adam").lower()
    lr = cfg.pop("lr", 1e-4)
    if otype == "adam":
        betas = tuple(cfg.pop("betas", (0.9, 0.999)))
        opt = torch.optim.Adam(params, lr=lr, betas=betas,
                               eps=cfg.pop("eps", 1e-8))
    elif otype == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=cfg.pop("weight_decay", 1e-2))
    elif otype == "sgd":
        opt = torch.optim.SGD(params, lr=lr,
                              momentum=cfg.pop("momentum", 0.9))
    else:
        raise ValueError(f"unsupported optimizer {otype}")
    schedule = build_schedule(lr, lr_config)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda k: schedule(k) / lr)
    return opt, scheduler
