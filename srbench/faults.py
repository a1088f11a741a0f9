"""Faults planted in the program under test, to show that ``correct``
catches them (the benchmark's own runs plant none). Each takes the
program after its set-up: the restorer for an eval cell; the restorer and
its train step for a training cell, returning the step to run."""

from __future__ import annotations

import torch


def altered_answer(restorer) -> None:
    """Every decode's output changed where it is produced: one 8 × 8 block
    of every tile brightened by 0.1."""
    gen = restorer.generator
    decode = gen.decode_grid

    def broken(*args, **kw):
        out = decode(*args, **kw).clone()
        out[:, :8, :8, :] += 0.1
        return out

    gen.decode_grid = broken


def half_tiles(restorer) -> None:
    """Half of each tile group left out: only its first half decoded, the
    overlap-average taken over the tiles that came back."""
    decode = restorer._decode

    def broken(lq_tiles, *args, **kw):
        keep = max(1, lq_tiles.shape[0] // 2)
        return decode(lq_tiles[:keep], *args, **kw)

    restorer._decode = broken


def unchanged_state(restorer, step):
    """A step that computes its loss and returns the state unchanged."""
    def broken(state, batch):
        with torch.no_grad():
            total, losses, _ = restorer.generator_losses(batch)
        state.step += 1
        return state, {k: v.detach() for k, v in losses.items()}
    return broken


def half_batch(restorer, step):
    """A step over the first half of the batch only, the loss its mean."""
    def broken(state, batch):
        n = max(1, batch["lq"].shape[0] // 2)
        return step(state, {k: v[:n] for k, v in batch.items()})
    return broken


EVAL = {"altered_answer": altered_answer, "half_tiles": half_tiles}
TRAIN = {"unchanged_state": unchanged_state, "half_batch": half_batch}
