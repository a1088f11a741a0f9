"""The classical (L1) train step.

Counterpart of ciaosr_tpu/train/trainer.py::make_train_step and
TrainState. One call runs the restorer's ``train_forward`` (the generator
forward and the normalized L1 loss), the backward (through row 12 for the
Swin blocks when the generator has ``use_kernels``), the optimizer step
and the scheduler step, and returns the loss as a device tensor: nothing
waits for the device. The Trainer loop, its hooks, logging and
checkpoints are not ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

BATCH_KEYS = ("lq", "gt", "coord", "cell")


@dataclass
class TrainState:
    step: int
    generator: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler


def make_train_step(restorer, optimizer: torch.optim.Optimizer,
                    scheduler) -> Callable:
    """``train_step(state, batch) -> (state, {"loss_pix": loss})``;
    ``batch`` holds lq (B, H, W, 3), gt (B, Q, 3), coord and cell (B, Q,
    2) on the generator's device. ``state.step`` counts the updates."""

    def train_step(state: TrainState, batch: dict):
        optimizer.zero_grad(set_to_none=True)
        loss, _ = restorer.train_forward(*(batch[k] for k in BATCH_KEYS))
        loss.backward()
        optimizer.step()
        scheduler.step()
        state.step += 1
        return state, {"loss_pix": loss.detach()}

    return train_step
