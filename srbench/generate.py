"""The one traffic generator. A traffic mix is a data file under
``srbench/traffic/`` whose ``kind`` names what it makes:

* ``photos``: a pool of LR photographs for a closed loop, every seed
  given the same sizes (``long_side`` × each of ``short_sides``; the
  sizes at positions ``portrait_at`` of that list stand upright) in the
  same order (``loop``), the contents drawn from the seed;
* ``train_batches``: a pool of training batches (``batch`` LR patches of
  ``lq_size``², ``queries`` HR queries a patch), every seed given the same
  HR scales (``pool`` × ``batch`` of them, evenly spread over
  [``scale_min``, ``scale_max``]) in another order, the pictures and the
  queries drawn from the seed.

Everything is made on the device, in bulk, from a ``torch.Generator``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def _u(g, n, device, lo=0.0, hi=1.0) -> torch.Tensor:
    return torch.rand(n, generator=g, device=device) * (hi - lo) + lo


def picture(g, h: int, w: int, device) -> torch.Tensor:
    """A seeded photograph-like picture (h, w, 3) in [0, 1], quantized to
    8 bits: low-frequency waves, a dozen hard-edged patches, fine grain."""
    f32 = dict(device=device, dtype=torch.float32)
    y = torch.arange(h, **f32)[:, None] / max(h, w)
    x = torch.arange(w, **f32)[None, :] / max(h, w)
    img = torch.zeros(h, w, 3, device=device)
    for _ in range(4):
        fy, fx = _u(g, 2, device, 0.5, 6.0).tolist()
        ph = float(_u(g, 1, device, 0.0, 6.28))
        amp = _u(g, 3, device, 0.2, 1.0)
        img += amp * torch.sin(2 * math.pi * (fy * y + fx * x) + ph)[..., None]
    for _ in range(12):
        y0, x0 = (_u(g, 2, device) * torch.tensor([h, w], device=device)
                  ).long().tolist()
        dy, dx = (_u(g, 2, device, 0.05, 0.4) * torch.tensor(
            [h, w], device=device)).long().tolist()
        img[y0:y0 + dy, x0:x0 + dx] += _u(g, 3, device, -1.0, 1.0)
    img += 0.05 * torch.randn(h, w, 3, generator=g, device=device)
    img = (img - img.amin()) / (img.amax() - img.amin())
    return torch.round(img * 255.0) / 255.0


def photo_sizes(mix: dict) -> list[tuple[int, int]]:
    portrait = set(mix.get("portrait_at", []))
    return [(mix["long_side"], s) if i in portrait else (s, mix["long_side"])
            for i, s in enumerate(mix["short_sides"])]


def photos(mix: dict, seed: int, device) -> tuple[list[np.ndarray], list]:
    """(pictures as host float32 arrays (h, w, 3), one a size, contents
    drawn from the seed; the loop's order, the pool's indices in the order
    ``loop`` gives, the same for every seed: the allocator and the copies
    then see the same sequence of sizes in every run)."""
    g = _gen(seed, device)
    pics = [picture(g, h, w, device).cpu().numpy()
            for h, w in photo_sizes(mix)]
    loop = list(mix["loop"])
    if sorted(loop) != list(range(len(pics))):
        raise ValueError("loop must visit every picture of the pool once")
    return pics, loop


def _unsharp(img: torch.Tensor, weight: float = 0.5) -> torch.Tensor:
    """img + weight·(img − blur(img)), clipped: the sharpened target."""
    x = img.permute(2, 0, 1)[None]
    blur = F.avg_pool2d(F.pad(x, (2, 2, 2, 2), mode="reflect"), 5, 1)
    return torch.clamp(x + weight * (x - blur), 0, 1)[0].permute(1, 2, 0)


def train_batches(mix: dict, seed: int, device) -> list[dict]:
    """``pool`` batches: lq (B, L, L, 3), gt and gt_unsharp (B, Q, 3),
    coord and cell (B, Q, 2) on ``device``."""
    g = _gen(seed, device)
    b, lq_size, nq = mix["batch"], mix["lq_size"], mix["queries"]
    n = mix["pool"] * b
    scales = torch.linspace(mix["scale_min"], mix["scale_max"], n)
    scales = scales[torch.randperm(n, generator=g, device=device).cpu()]
    batches = []
    for i in range(mix["pool"]):
        lq, gt, sharp, coord, cell = [], [], [], [], []
        for s in scales[i * b:(i + 1) * b].tolist():
            hr_side = max(lq_size, round(lq_size * s))
            hr = picture(g, hr_side, hr_side, device)
            lo = F.interpolate(hr.permute(2, 0, 1)[None], size=(lq_size,
                                                                lq_size),
                               mode="bicubic", antialias=True,
                               align_corners=False)
            lq.append(torch.round(lo.clamp(0, 1)[0].permute(1, 2, 0) * 255)
                      / 255)
            sel = torch.randperm(hr_side * hr_side, generator=g,
                                 device=device)[:nq]
            centres = -1.0 + (2.0 * torch.arange(
                hr_side, device=device, dtype=torch.float32) + 1.0) / hr_side
            coord.append(torch.stack([centres[sel // hr_side],
                                      centres[sel % hr_side]], -1))
            cell.append(torch.full((nq, 2), 2.0 / hr_side, device=device))
            gt.append(hr.reshape(-1, 3)[sel])
            sharp.append(_unsharp(hr).reshape(-1, 3)[sel])
        batches.append(dict(lq=torch.stack(lq), gt=torch.stack(gt),
                            gt_unsharp=torch.stack(sharp),
                            coord=torch.stack(coord),
                            cell=torch.stack(cell)))
    return batches
