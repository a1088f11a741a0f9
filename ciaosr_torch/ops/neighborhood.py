"""Neighbourhood extraction on NHWC, tap-major layout.

Counterpart of ciaosr_tpu/ops/neighborhood.py. The flattened patch layout
is tap-major, ``j = tap * C + c`` with ``tap = dy * k + dx``; PyTorch's
``F.unfold`` is channel-major (``c * k² + tap``), and the decoder packs its
weights accordingly (ops/kernels/decoder.py). ``gather_patches`` alone is
channel-major: the per-query decoder feeds it to the MLPs as it is.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def tap_major_perm(c: int, k2: int = 9) -> np.ndarray:
    """perm[tap_major_idx] = channel_major_idx for a (k², C) unfold block."""
    o = np.arange(k2 * c)
    return (o % c) * k2 + o // c


def unfold_nhwc(feat: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """k×k zero-padded neighbourhoods: (B, H, W, C) → (B, H, W, k·k·C)."""
    _, h, w, _ = feat.shape
    pad = ksize // 2
    padded = F.pad(feat, (0, 0, pad, pad, pad, pad))
    return torch.cat([padded[:, dy:dy + h, dx:dx + w, :]
                      for dy in range(ksize) for dx in range(ksize)], dim=-1)


def gather_patches(feat: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                   ksize: int = 3) -> torch.Tensor:
    """k×k zero-padded neighbourhoods at integer centres: feat (B, H, W, C),
    iy/ix (B, ...) in-range indices → (B, ..., k·k·C), channel-major
    (``c·k² + tap``: the layout of ``F.unfold`` and of the reference-layout
    MLPs that read it; the JAX counterpart is tap-major)."""
    b, h, w, c = feat.shape
    flat = feat.reshape(b, h * w, c)
    lead = iy.shape[1:]
    r = ksize // 2
    taps = []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            y, x = iy + dy, ix + dx
            valid = (y >= 0) & (y < h) & (x >= 0) & (x < w)
            idx = (y.clamp(0, h - 1) * w + x.clamp(0, w - 1)).reshape(b, -1)
            v = torch.gather(flat, 1, idx.long()[..., None].expand(-1, -1, c))
            taps.append(torch.where(valid[..., None],
                                    v.reshape(b, *lead, c), 0.0))
    return torch.stack(taps, -1).reshape(b, *lead, c * ksize * ksize)


def extract_patches_same(x: torch.Tensor, ksize: int,
                         stride: int) -> torch.Tensor:
    """k×k patches with TF 'SAME' zero padding at a stride:
    (B, H, W, C) → (B, L, k·k·C), L = ceil(H/s)·ceil(W/s), tap-major."""
    b, h, w, c = x.shape
    out_h = -(-h // stride)
    out_w = -(-w // stride)
    pad_h = max(0, (out_h - 1) * stride + ksize - h)
    pad_w = max(0, (out_w - 1) * stride + ksize - w)
    top, left = pad_h // 2, pad_w // 2
    padded = F.pad(x, (0, 0, left, pad_w - left, top, pad_h - top))
    span_h = (out_h - 1) * stride + 1
    span_w = (out_w - 1) * stride + 1
    taps = [padded[:, dy:dy + span_h:stride, dx:dx + span_w:stride, :]
            for dy in range(ksize) for dx in range(ksize)]
    return torch.cat(taps, dim=-1).reshape(b, out_h * out_w,
                                            ksize * ksize * c)


def shift_edge(t: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """(B, H, W, C) map read at the edge-clamped position (y+dy, x+dx)."""
    if dy == 0 and dx == 0:
        return t
    _, h, w, _ = t.shape
    ys = torch.clamp(torch.arange(h, device=t.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=t.device) + dx, 0, w - 1)
    return t[:, ys][:, :, xs]
