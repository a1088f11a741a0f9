"""The numbers that decide ``correct``, and their limits.

Eval cells compare every pixel of a sample of the pictures the window
finished with the plain reference's picture (the widest gap, on [0, 1]).
The training cell compares the first three steps with the reference's:
the first step's loss (``first_loss_gap``; the worst of the three,
``loss_gap``, is read too but not compared: Adam's first updates, about
±lr whatever a gradient's size, turn round-off into diverging weights), the
norm of the first gradient as the optimizer got it, and the norm of the
weights' and the EMA copy's change after the three steps, each leaf's gap
between the two norms over the larger of the reference's norm of that
leaf and of the median leaf, the worst leaf.
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of the changes.

A number that is not finite fails. Limits live in
``srbench/limits/<workload>.json`` as {name: {"limit": x, ...}}.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

QUIET_GRAD = 1e-3


def picture_gap(out: np.ndarray, ref: np.ndarray) -> float:
    """max |out − ref| over every pixel and channel (inf on a shape
    mismatch)."""
    if out.shape != ref.shape:
        return math.inf
    return float(np.max(np.abs(out.astype(np.float64) - ref)))


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def leaf_gap(got: dict, ref: dict, keep=None) -> float:
    """Worst leaf's |‖got‖ − ‖ref‖| / max(‖ref‖, median leaf ‖ref‖)."""
    gn, rn = _norms(got), _norms(ref)
    names = [k for k in rn if keep is None or k in keep]
    med = float(np.median([rn[k] for k in names]))
    return max(abs(gn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names)


def moving_leaves(ref_grads: dict) -> set:
    norms = _norms(ref_grads)
    med = float(np.median(list(norms.values())))
    return {k for k, v in norms.items() if v >= QUIET_GRAD * med}


def train_numbers(prog: dict, ref: dict, start: dict) -> dict:
    """prog / ref: {"losses": [3 floats], "grad": {leaf: tensor},
    "params": {leaf: tensor}, "ema": {leaf: tensor}} after three steps
    from ``start`` (the weights before the first)."""
    keep = moving_leaves(ref["grad"])
    gaps = [abs(a - b) / abs(b) for a, b in
            zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        gaps = [math.inf]

    def change(d):
        return {k: d[k] - start[k] for k in start}

    return {"first_loss_gap": gaps[0], "loss_gap": max(gaps),
            "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
            "change_gap": leaf_gap(change(prog["params"]),
                                   change(ref["params"]), keep),
            "ema_change_gap": leaf_gap(change(prog["ema"]),
                                       change(ref["ema"]), keep)}


def load_limits(root: Path, workload: str) -> dict:
    path = root / "srbench" / "limits" / f"{workload}.json"
    if not path.exists():
        return {}
    return {k: float(v["limit"]) for k, v in
            json.loads(path.read_text()).items()}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit: each finite and at most its limit. A limit whose number is
    missing fails, and so does a cell with no limit at all."""
    checks, ok = {}, bool(limits)
    for name, limit in limits.items():
        value = float(numbers.get(name, math.nan))
        ok = ok and math.isfinite(value) and value <= limit
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
