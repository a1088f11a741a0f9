"""The port's training checkpoints: one ``torch.save`` file per save.

Counterpart of ciaosr_tpu/train/checkpoint.py's ``CheckpointManager``,
``resolve_checkpoint_dir``, ``restore_external`` and
``load_staged_generator`` (orbax there). A save
of iteration N writes ``<work_dir>/checkpoints/iter_N.pth`` in the mmcv
layout the port's ``.pth`` loader reads (convert/load.py):

* ``meta``: ``iter``, ``config`` (the config's text), ``metrics`` (the
  last eval's, for ``keep_best_metric``), ``torch``;
* ``state_dict``: the generator's tensors under ``generator.`` (a GAN
  run's also ``generator_ema.`` and ``discriminator.``, the spectral
  norms' ``u`` and ``sigma`` included);
* ``optimizer``, ``scheduler``: their ``state_dict()`` (a GAN run's: a
  dict of them under ``generator`` and ``discriminator``); ``step``: N.

A save writes a temporary name and then ``os.replace``-s it, so a run
killed mid-save leaves no torn file for auto-resume. After each save the
manager prunes to ``max_to_keep`` files with orbax's rule: the newest, or
with ``keep_best_metric`` the best by that metric, maximized (ties keep
the newer).
"""

from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"^iter_(\d+)\.pth$")


def checkpoint_name(step: int) -> str:
    return f"iter_{step}.pth"


def list_steps(ckpt_dir: str) -> list[int]:
    """The iterations saved under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                os.listdir(ckpt_dir)) if m)


def read_checkpoint(path: str) -> dict:
    """A checkpoint file as saved (tensors on the CPU)."""
    # the meta dict holds plain objects, which weights_only refuses
    return torch.load(path, map_location="cpu", weights_only=False)


class CheckpointManager:
    """Saves, prunes and finds the checkpoints of one run's work_dir."""

    def __init__(self, work_dir: str, max_to_keep: int = 10,
                 interval: int = 3000, keep_best_metric: str | None = None):
        self.dir = os.path.abspath(os.path.join(work_dir, "checkpoints"))
        os.makedirs(self.dir, exist_ok=True)
        self.interval = interval
        self.max_to_keep = max_to_keep
        self.keep_best_metric = keep_best_metric
        # (step, metrics) of the files present, ascending; the metrics are
        # read back only where pruning needs them
        self._saved = [(s, self._metrics(s) if keep_best_metric else None)
                       for s in list_steps(self.dir)]

    def path(self, step: int) -> str:
        return os.path.join(self.dir, checkpoint_name(step))

    def _metrics(self, step: int) -> dict:
        meta = torch.load(self.path(step), map_location="cpu", mmap=True,
                          weights_only=False).get("meta", {})
        return meta.get("metrics") or {}

    def latest_step(self) -> int | None:
        return self._saved[-1][0] if self._saved else None

    def save(self, step: int, state: dict, metrics: dict | None = None):
        """Write ``state`` (the checkpoint dict without its metrics) as
        iteration ``step``, then prune; a step already saved last is
        skipped (the final save right after a periodic one)."""
        if self.latest_step() == step:
            return
        metrics = {k: float(v) for k, v in (metrics or {}).items()
                   if isinstance(v, (int, float))}
        state = dict(state, meta=dict(state.get("meta", {}),
                                      metrics=metrics))
        tmp = os.path.join(self.dir, f".{checkpoint_name(step)}.tmp")
        torch.save(state, tmp)
        os.replace(tmp, self.path(step))
        self._saved.append((step, metrics))
        self._prune()

    def _prune(self) -> None:
        n = self.max_to_keep
        if n is None or len(self._saved) <= n:
            return
        if self.keep_best_metric:
            key = self.keep_best_metric
            ranked = sorted(self._saved,
                            key=lambda sm: sm[1].get(key, float("-inf")))
            keep = {s for s, _ in ranked[-n:]} if n else set()
        else:
            keep = {s for s, _ in self._saved[-n:]} if n else set()
        for s, _ in self._saved:
            if s not in keep:
                os.remove(self.path(s))
        self._saved = [sm for sm in self._saved if sm[0] in keep]

    def restore(self) -> tuple[dict | None, int | None]:
        """The newest checkpoint and its iteration, or (None, None)."""
        step = self.latest_step()
        if step is None:
            return None, None
        return read_checkpoint(self.path(step)), step


def resolve_checkpoint(path: str) -> str:
    """A user's checkpoint path → a checkpoint file: the file itself, or
    the newest checkpoint of a training work_dir (holding
    ``checkpoints/``), of the checkpoints directory itself, or of
    ``<work_dir>/latest`` (the configs' ``test_checkpoint_path``; also
    ``latest.pth``)."""
    path = os.path.abspath(path)
    if os.path.isfile(path):
        return path
    if os.path.basename(path) in ("latest", "latest.pth"):
        path = os.path.dirname(path)
    nested = os.path.join(path, "checkpoints")
    ckpt_dir = nested if os.path.isdir(nested) else path
    steps = list_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints found at {path}")
    return os.path.join(ckpt_dir, checkpoint_name(steps[-1]))


def restore_external(path: str) -> tuple[dict, int]:
    """The checkpoint ``path`` resolves to, and its iteration: the
    ``--resume-from`` semantics, as against auto-resume from the run's own
    work_dir."""
    ckpt = read_checkpoint(resolve_checkpoint(path))
    return ckpt, int(ckpt["step"])


def load_staged_generator(path: str, model_cfg: dict) -> tuple[dict, dict]:
    """Stage 2's ``load_from``: the (generator, EMA copy) state_dicts of
    ``model_cfg['generator']`` from a stage-1 run. ``path`` resolves as in
    ``resolve_checkpoint``; the file may be the port's GAN checkpoint
    (``generator.`` and ``generator_ema.``), its classical one (the
    generator seeds both) or a reference ``.pth`` (convert/load.py, EMA
    copy where it has one)."""
    from ciaosr_torch.convert.load import (checkpoint_state_dict, has_ema,
                                           load_torch_checkpoint)

    raw = read_checkpoint(resolve_checkpoint(path))
    gen = load_torch_checkpoint(raw, model_cfg)
    ema = load_torch_checkpoint(raw, model_cfg, ema=True) \
        if has_ema(checkpoint_state_dict(raw)) else gen
    return gen, ema
