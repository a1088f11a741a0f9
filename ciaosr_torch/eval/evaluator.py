"""Evaluation loop: dataset → restorer → mean metrics.

Counterpart of ciaosr_tpu/eval/evaluator.py for one process: each sample
of the dataset goes through ``restorer.forward_test`` at its target size
(the meta ``target_size``, else the gt's shape) and scale, is scored by
``restorer.evaluate`` against its gt, and the per-image metrics are
averaged. Gathering over several GPUs is not ported (ROADMAP queue 1
item 8(b)).
"""

from __future__ import annotations

import os
import time

import numpy as np

from ciaosr_torch.core.color import tensor2img
from ciaosr_torch.data.imageio import write_png


def _save_png(path: str, img01: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_png(path, tensor2img(img01, bgr=False))


def evaluate_dataset(restorer, dataset, save_path: str | None = None,
                     log_every: int = 10, progress=print) -> dict:
    """Run the eval protocol over a dataset; returns the mean of each
    metric, ``n_images`` and ``elapsed_s``."""
    per_image = []
    t0 = time.time()
    for idx in range(len(dataset)):
        sample = dataset[idx]
        lq = sample["lq"]
        gt = sample.get("gt")
        meta = sample.get("meta", {})
        target = meta.get("target_size")
        if target is None and gt is not None and gt.ndim == 3:
            target = gt.shape[:2]
        scale = meta.get("scale") or getattr(dataset, "scale", None)
        out = restorer.forward_test(lq, target_shape=target, scale=scale)
        rec = {"idx": idx}
        if gt is not None and gt.ndim == 3:
            rec.update(restorer.evaluate(out, gt))
        per_image.append(rec)
        if save_path:
            name = os.path.splitext(os.path.basename(
                meta.get("gt_path") or f"img_{idx}"))[0]
            _save_png(os.path.join(save_path, f"{name}.png"), out)
        if (idx + 1) % log_every == 0:
            progress(f"[eval] {idx + 1}/{len(dataset)} "
                     f"({(time.time() - t0) / (idx + 1):.2f}s/img)")

    keys = sorted({k for r in per_image for k in r} - {"idx"})
    vals = {k: [r[k] for r in per_image
                if k in r and not np.isnan(r[k])] for k in keys}
    summary = {k: float(np.mean(v)) for k, v in vals.items() if v}
    summary["n_images"] = len(per_image)
    summary["elapsed_s"] = time.time() - t0
    return summary
