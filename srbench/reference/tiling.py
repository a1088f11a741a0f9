"""Overlap-average tiling of an LR picture at an integer scale, as the
published CiaoSR test code tiles: fixed square tiles at a stride of
tile − overlap, the last row and column of tiles flush with the border,
each HR pixel the mean of the tiles that cover it, clamped to [0, 1]."""

from __future__ import annotations

import numpy as np
import torch


def tile_starts(n: int, tile: int, overlap: int) -> list[int]:
    """Tile starts along an axis of n pixels (tile ≤ n)."""
    stride = max(tile - overlap, 1)
    return sorted(set(list(range(0, n - tile, stride)) + [n - tile]))


def tile_grid(h: int, w: int, tile: int, overlap: int):
    """(tile, row starts, column starts) of an h × w picture."""
    tile = min(tile, h, w)
    return tile, tile_starts(h, tile, overlap), tile_starts(w, tile, overlap)


def count_tiles(h: int, w: int, tile: int, overlap: int) -> int:
    _, hs, ws = tile_grid(h, w, tile, overlap)
    return len(hs) * len(ws)


@torch.no_grad()
def upscale_tiled(upscale, lq: np.ndarray, s: int, tile: int, overlap: int,
                  mean, device) -> np.ndarray:
    """``upscale(x, s)`` (normalized NCHW tile → (1, sT, sT, 3)) over the
    tiles of lq (H, W, 3) in [0, 1]; ``mean`` is the RGB mean that
    normalizes (std 1). Returns (sH, sW, 3) float32 in [0, 1]."""
    h, w = lq.shape[:2]
    tile, hs, ws = tile_grid(h, w, tile, overlap)
    x = torch.as_tensor(np.asarray(lq, np.float32), device=device)
    mean_t = torch.as_tensor(mean, dtype=torch.float32, device=device)
    acc = torch.zeros(s * h, s * w, 3, device=device)
    cnt = torch.zeros(s * h, s * w, 1, device=device)
    for hi in hs:
        for wi in ws:
            t = (x[hi:hi + tile, wi:wi + tile] - mean_t).permute(2, 0, 1)
            out = upscale(t[None], s)[0] + mean_t
            acc[s * hi:s * (hi + tile), s * wi:s * (wi + tile)] += out
            cnt[s * hi:s * (hi + tile), s * wi:s * (wi + tile)] += 1.0
    return torch.clamp(acc / cnt, 0.0, 1.0).cpu().numpy()
