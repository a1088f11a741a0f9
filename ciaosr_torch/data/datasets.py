"""Folder datasets and the repeat wrapper (the mmedit dataset surface).

Counterpart of ciaosr_tpu/data/datasets.py: SRFolderGTDataset (gt only,
the LQ made by the pipeline), SRFolderDataset (paired lq / gt folders
matched by stem through ``filename_tmpl``), RepeatDataset.

``dataset[idx]`` is one sample; ``dataset.load(idx, rng)`` is the same
sample with its pipeline drawing from the numpy Generator ``rng`` (the
loader hands every sample of a batch that batch's generator). A seeded
SRFolderGTDataset keeps its own per-sample generator either way.
"""

from __future__ import annotations

import os

import numpy as np

from ciaosr_torch.config.registry import DATASETS, build_from_cfg
from ciaosr_torch.data.pipelines import Compose

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp")


def scan_images(folder: str) -> list[str]:
    files = sorted(
        os.path.join(folder, f) for f in os.listdir(folder)
        if f.lower().endswith(IMG_EXTS))
    if not files:
        raise FileNotFoundError(f"no images under {folder}")
    return files


@DATASETS.register(name="SRFolderGTDataset")
class SRFolderGTDataset:
    """GT-only folder; LQ synthesized by the pipeline. Sample ``idx``
    draws from ``numpy.random.default_rng((seed, idx))``; without a seed,
    from the generator ``load`` is given, else from one unseeded generator
    the dataset owns."""

    def __init__(self, gt_folder: str, pipeline, scale=None, seed=None,
                 **kwargs):
        self.pipeline = Compose(pipeline)   # an op not ported raises first
        self.paths = scan_images(gt_folder)
        self.scale = scale
        self.seed = seed
        self._rng = np.random.default_rng() if seed is None else None

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        return self.load(idx)

    def load(self, idx, rng: np.random.Generator | None = None):
        if self.seed is not None:
            rng = np.random.default_rng((self.seed, idx))
        elif rng is None:
            rng = self._rng
        return self.pipeline({"gt_path": self.paths[idx], "_rng": rng})


@DATASETS.register(name="SRFolderDataset")
class SRFolderDataset:
    """Paired lq/gt folders, matched by stem via filename_tmpl."""

    def __init__(self, lq_folder: str, gt_folder: str, pipeline,
                 scale=None, filename_tmpl="{}", **kwargs):
        gt_paths = scan_images(gt_folder)
        self.pairs = []
        lq_by_stem = {}
        for p in scan_images(lq_folder):
            stem = os.path.splitext(os.path.basename(p))[0]
            lq_by_stem[stem] = p
        for g in gt_paths:
            stem = os.path.splitext(os.path.basename(g))[0]
            lq_stem = filename_tmpl.format(stem)
            if lq_stem in lq_by_stem:
                self.pairs.append((lq_by_stem[lq_stem], g))
            else:
                raise FileNotFoundError(
                    f"no lq match for {g} (looked for stem {lq_stem})")
        self.pipeline = Compose(pipeline)
        self.scale = scale

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx):
        return self.load(idx)

    def load(self, idx, rng: np.random.Generator | None = None):
        lq_path, gt_path = self.pairs[idx]
        results = {"lq_path": lq_path, "gt_path": gt_path,
                   "scale": self.scale}
        if rng is not None:
            results["_rng"] = rng
        return self.pipeline(results)


@DATASETS.register(name="RepeatDataset")
class RepeatDataset:
    def __init__(self, dataset, times: int):
        self.dataset = dataset if not isinstance(dataset, dict) \
            else build_dataset(dataset)
        self.times = times

    def __len__(self):
        return len(self.dataset) * self.times

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]

    def load(self, idx, rng: np.random.Generator | None = None):
        return self.dataset.load(idx % len(self.dataset), rng)


def build_dataset(cfg: dict):
    return build_from_cfg(cfg, DATASETS)
