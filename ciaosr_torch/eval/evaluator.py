"""Evaluation loop: dataset → restorer → mean metrics.

Counterpart of ciaosr_tpu/eval/evaluator.py: each sample of the dataset
goes through ``restorer.forward_test`` at its target size (the meta
``target_size``, else the gt's shape) and scale, is scored by
``restorer.evaluate`` against its gt, and the per-image metrics are
averaged.

Over several GPUs (a ``mesh`` of parallel/mesh.py) rank r takes images r,
r+N, ... and the per-image metrics are all-gathered as one NaN-padded
array of fixed shape, whose columns come from ``test_cfg["metrics"]``:
so a ragged count (3 images over 2 ranks) or a rank with no image gives
every rank the same summary. With ``shard_tiles`` every rank takes every
image and shards its tiles instead (``predict_tiled``), and nothing is
gathered. JAX's processes each own all their local chips, so JAX strides
images over processes and shards tiles over local chips; a port process
owns one GPU, so sharded tiles are sharded over the ranks.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ciaosr_torch.core.color import tensor2img
from ciaosr_torch.data.imageio import write_png
from ciaosr_torch.parallel.mesh import all_gather_rows


def _save_png(path: str, img01: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_png(path, tensor2img(img01, bgr=False))


def _gather(restorer, per_image: list[dict], n_images: int,
            mesh) -> list[dict]:
    """Every rank's per-image records, by index: each rank's as a
    NaN-padded (ceil(n_images / N), keys) array, all-gathered."""
    test_cfg = getattr(restorer, "test_cfg", None) or {}
    keys = sorted({"idx", *test_cfg.get("metrics", ["PSNR"])})
    cap = max(1, -(-n_images // mesh.world))
    arr = np.full((cap, len(keys)), np.nan, np.float64)
    for i, r in enumerate(per_image):
        arr[i] = [float(r.get(k, np.nan)) for k in keys]
    rows = all_gather_rows(mesh, arr)
    idx_col = keys.index("idx")
    return sorted((dict(zip(keys, row)) for row in rows
                   if np.isfinite(row[idx_col])), key=lambda r: r["idx"])


def evaluate_dataset(restorer, dataset, save_path: str | None = None,
                     log_every: int = 10, progress=print, mesh=None,
                     shard_tiles: bool = False) -> dict:
    """Run the eval protocol over a dataset; returns the mean of each
    metric, ``n_images`` and ``elapsed_s``. Under a ``mesh`` it is a
    collective (every rank must call it) and every rank returns the same
    summary; each picture is saved by the one rank that made it (rank 0
    under ``shard_tiles``), and only rank 0 logs progress."""
    grouped = mesh is not None and mesh.group is not None
    strided = grouped and not shard_tiles
    rank, world = (mesh.rank, mesh.world) if strided else (0, 1)
    main = mesh is None or mesh.is_main
    indices = range(rank, len(dataset), world)
    per_image = []
    t0 = time.time()
    for n, idx in enumerate(indices):
        sample = dataset[idx]
        lq = sample["lq"]
        gt = sample.get("gt")
        meta = sample.get("meta", {})
        target = meta.get("target_size")
        if target is None and gt is not None and gt.ndim == 3:
            target = gt.shape[:2]
        scale = meta.get("scale") or getattr(dataset, "scale", None)
        out = restorer.forward_test(lq, target_shape=target, scale=scale,
                                    mesh=mesh if shard_tiles else None)
        rec = {"idx": idx}
        if gt is not None and gt.ndim == 3:
            rec.update(restorer.evaluate(out, gt))
        per_image.append(rec)
        if save_path and (strided or main):
            name = os.path.splitext(os.path.basename(
                meta.get("gt_path") or f"img_{idx}"))[0]
            _save_png(os.path.join(save_path, f"{name}.png"), out)
        if main and (n + 1) % log_every == 0:
            progress(f"[eval] {n + 1}/{len(indices)} "
                     f"({(time.time() - t0) / (n + 1):.2f}s/img)")
    if strided:
        per_image = _gather(restorer, per_image, len(dataset), mesh)

    keys = sorted({k for r in per_image for k in r} - {"idx"})
    vals = {k: [r[k] for r in per_image
                if k in r and not np.isnan(r[k])] for k in keys}
    summary = {k: float(np.mean(v)) for k, v in vals.items() if v}
    summary["n_images"] = len(per_image)
    summary["elapsed_s"] = time.time() - t0
    return summary
