"""Classical (L1) training: the train step, the logger and the Trainer loop.

Counterpart of ciaosr_tpu/train/trainer.py: ``make_train_step`` and
``TrainState``, ``MetricLogger`` (the JSONL records and the printed line;
no TensorBoard output) and ``Trainer``, the iteration-based loop with its
hooks: log every ``log_config.interval``, eval every
``evaluation.interval``, a checkpoint every ``checkpoint_config.interval``
and once at the end (train/checkpoint.py), auto-resume from the run's own
work_dir or ``resume_from``.

One train step runs the restorer's ``train_forward`` on its
``batch_keys`` (the generator forward and the L1 loss), the backward
(through row 12 for the Swin blocks when the generator has
``use_kernels``), the optimizer step
and the scheduler step, and returns the loss as a device tensor: nothing
waits for the device. The loop syncs with the device once per log
interval (the interval's mean loss) and copies the state to the host only
on a save step.

Several GPUs (a ``mesh`` of parallel/mesh.py, one process per GPU): every
rank draws the same global batch and keeps its ``shard_batch`` rows; the
gradients are averaged over the ranks before the optimizer steps; the
initial (or resumed) state is broadcast from rank 0; the logged means are
averaged over the ranks once per log interval. Only rank 0 prints, writes
the log and saves, and a barrier follows each save. ``eval_fn`` is a
collective: every rank calls it.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ciaosr_torch.parallel.mesh import (Mesh, all_reduce_grads,
                                        all_reduce_sum_, replicate,
                                        shard_batch)
from ciaosr_torch.train.checkpoint import CheckpointManager, restore_external
from ciaosr_torch.train.optim import build_optimizer

BATCH_KEYS = ("lq", "gt", "coord", "cell")


@dataclass
class TrainState:
    step: int
    generator: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler


def make_train_step(restorer, optimizer: torch.optim.Optimizer,
                    scheduler, mesh: Mesh | None = None) -> Callable:
    """``train_step(state, batch) -> (state, {"loss_pix": loss})``;
    ``batch`` holds the restorer's ``batch_keys`` (default lq (B, H, W,
    3), gt (B, Q, 3), coord and cell (B, Q, 2); a ``BasicRestorer``'s lq
    and gt) on the generator's device. ``state.step`` counts the
    updates. Under a ``mesh`` the optimizer steps on the gradients' mean
    over the ranks."""
    keys = getattr(restorer, "batch_keys", BATCH_KEYS)
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def train_step(state: TrainState, batch: dict):
        optimizer.zero_grad(set_to_none=True)
        loss, _ = restorer.train_forward(*(batch[k] for k in keys))
        loss.backward()
        all_reduce_grads(mesh, params)
        optimizer.step()
        scheduler.step()
        state.step += 1
        return state, {"loss_pix": loss.detach()}

    return train_step


def _mean(vals: list, mesh: Mesh | None = None) -> float:
    """The mean of an interval's values: device tensors are stacked,
    averaged over the ranks (one all-reduce) and read in one copy (the
    interval's one sync), then averaged in numpy as the JAX logger
    averages its arrays. Plain numbers (the eval's, the same on every
    rank) are averaged as they are."""
    if all(isinstance(v, torch.Tensor) for v in vals):
        t = all_reduce_sum_(mesh, torch.stack(vals))
        if mesh is not None and mesh.world > 1:
            t = t / mesh.world
        return float(t.cpu().numpy().mean())
    return float(np.mean([float(v) for v in vals]))


class MetricLogger:
    """JSONL logging (the TextLoggerHook's records): every ``interval``
    steps one record ``{"step", <interval means>, <extra>, "time"}`` in
    ``<work_dir>/train_log.jsonl`` and the line ``[iter N] k=v ...``.
    Under a ``mesh`` every rank computes the record (its means are over
    the ranks) and only rank 0 writes and prints it."""

    def __init__(self, work_dir: str, interval: int = 100, progress=print,
                 mesh: Mesh | None = None):
        self.interval = interval
        os.makedirs(work_dir, exist_ok=True)
        self.path = os.path.join(work_dir, "train_log.jsonl")
        self.progress = progress
        self.mesh = mesh
        self._acc: dict[str, list] = {}

    def log(self, step: int, metrics: dict,
            extra: dict | None = None) -> dict | None:
        """Add a step's metrics; on a log step returns the record."""
        for k, v in metrics.items():
            self._acc.setdefault(k, []).append(v)
        if step % self.interval != 0:
            return None
        means = {k: _mean(v, self.mesh) for k, v in self._acc.items()}
        self._acc.clear()
        rec = {"step": step, **means, **(extra or {}), "time": time.time()}
        if self.mesh is None or self.mesh.is_main:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
            msg = " ".join(f"{k}={v:.4g}" for k, v in means.items())
            self.progress(f"[iter {step}] {msg}")
        return rec


def to_device(batch: dict, device: torch.device) -> dict:
    """The batch's arrays (every key but the 'meta' list) on ``device``:
    on a CUDA device through pinned host memory with ``non_blocking``
    copies."""
    out = {}
    for k, v in batch.items():
        if k == "meta":
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class Trainer:
    """Classical (L1) CiaoSR training of ``restorer``'s generator, in
    place, with the optimizer and schedule of ``cfg``; data-parallel over
    ``mesh``'s ranks (default: this process alone)."""

    def __init__(self, restorer, cfg, work_dir: str,
                 resume_from: str | None = None, auto_resume: bool = True,
                 progress=print, mesh: Mesh | None = None):
        self.restorer = restorer
        self.cfg = cfg
        self.work_dir = work_dir
        self.resume_from = resume_from
        self.auto_resume = auto_resume
        self.mesh = mesh or Mesh(device=restorer.device)
        self.progress = progress if self.mesh.is_main else _quiet
        self.state, self.train_step = self._make_step()
        ckpt_cfg = cfg.get("checkpoint_config") or {}
        self.ckpt = CheckpointManager(
            work_dir, interval=ckpt_cfg.get("interval", 3000),
            max_to_keep=ckpt_cfg.get("max_to_keep", 10),
            keep_best_metric=ckpt_cfg.get("keep_best_metric"))
        self.logger = MetricLogger(
            work_dir, interval=(cfg.get("log_config") or {}).get(
                "interval", 100), progress=progress, mesh=self.mesh)

    def _make_step(self):
        """(the train state at step 0, the train step): the config's
        optimizer and schedule (``self.optimizer``, ``self.scheduler``)
        over the generator."""
        gen = self.restorer.generator
        self.optimizer, self.scheduler = build_optimizer(
            gen.parameters(), dict(self.cfg.optimizers),
            dict(self.cfg.get("lr_config") or {}))
        return (TrainState(0, gen, self.optimizer, self.scheduler),
                make_train_step(self.restorer, self.optimizer,
                                self.scheduler, self.mesh))

    def _modules(self) -> dict:
        """The trained modules by checkpoint prefix."""
        return {"generator": self.restorer.generator}

    # ------------------------------------------------------- checkpoints
    def state_dict(self) -> dict:
        """The train state as a checkpoint (tensors copied to the host)."""
        gen = self.state.generator
        return {
            "meta": {"iter": self.state.step, "config": self.cfg.text,
                     "torch": torch.__version__},
            "state_dict": {f"generator.{k}": v.detach().cpu()
                           for k, v in gen.state_dict().items()},
            "optimizer": _to_cpu(self.optimizer.state_dict()),
            "scheduler": self.scheduler.state_dict(),
            "step": self.state.step,
        }

    def load_state_dict(self, ckpt: dict) -> None:
        sd = {k[len("generator."):]: v
              for k, v in ckpt["state_dict"].items()
              if k.startswith("generator.")}
        self.state.generator.load_state_dict(sd, strict=True)
        self.optimizer.load_state_dict(ckpt["optimizer"])
        self.scheduler.load_state_dict(ckpt["scheduler"])
        self.state.step = int(ckpt["step"])

    def _maybe_resume(self) -> None:
        """``resume_from`` (a work_dir, checkpoints dir or file) takes
        precedence over auto-resume from the run's own work_dir;
        ``auto_resume=False`` turns the latter off."""
        if self.resume_from:
            ckpt, step = restore_external(self.resume_from)
            self.load_state_dict(ckpt)
            self.progress(f"[resume] from {self.resume_from} @ iteration "
                          f"{step}")
        elif self.auto_resume:
            ckpt, step = self.ckpt.restore()
            if ckpt is not None:
                self.load_state_dict(ckpt)
                self.progress(f"[resume] from iteration {step}")

    def _save(self, step: int, metrics: dict | None = None) -> None:
        """Rank 0 saves iteration ``step``; every rank waits for the file."""
        if self.mesh.is_main:
            self.ckpt.save(step, self.state_dict(), metrics)
        self.mesh.barrier()

    # -------------------------------------------------------------- loop
    def _next(self, it) -> dict:
        """The next batch: where the loop waits on the loader."""
        return next(it)

    def run(self, loader, total_iters: int, eval_fn=None,
            eval_interval: int | None = None) -> TrainState:
        """Train to ``total_iters`` updates from the resumed step; the
        loader starts again from its first batch on a resume, as in the
        JAX package. ``eval_fn()`` evaluates the live weights and returns
        a dict of metrics (on every rank: it is a collective)."""
        self._maybe_resume()
        for module in self._modules().values():
            replicate(self.mesh, module)
        device = self.restorer.device
        it = iter(loader)
        try:
            state, step = self.state, self.state.step
            win_t0, win_n = time.time(), 0
            last_eval: dict = {}
            while step < total_iters:
                batch = to_device(shard_batch(self.mesh, self._next(it)),
                                  device)
                state, metrics = self.train_step(state, batch)
                step = state.step
                win_n += 1
                extra = None
                if step % self.logger.interval == 0:
                    ips = win_n / max(time.time() - win_t0, 1e-9)
                    extra = {"lr": self.optimizer.param_groups[0]["lr"],
                             "iters_per_s": ips}
                    win_t0, win_n = time.time(), 0
                self.logger.log(step, metrics, extra)
                if eval_fn and eval_interval and step % eval_interval == 0:
                    last_eval = eval_fn()
                    self.progress(f"[eval @ {step}] {last_eval}")
                    self.logger.log(step, {f"val_{k}": v
                                           for k, v in last_eval.items()
                                           if isinstance(v, (int, float))})
                # the host copy of the state only on a save step
                if step % self.ckpt.interval == 0:
                    self._save(step, last_eval)
            self._save(step)
        finally:
            close = getattr(it, "close", None)
            if close:
                close()
        return state


def _quiet(*_) -> None:
    pass


def _to_cpu(obj):
    """A (nested) state dict with its tensors copied to the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_cpu(v) for v in obj]
    return obj
