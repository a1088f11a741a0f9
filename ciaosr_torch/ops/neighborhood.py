"""Neighbourhood extraction on NHWC, tap-major layout.

Counterpart of ciaosr_tpu/ops/neighborhood.py. The flattened patch layout
is tap-major, ``j = tap * C + c`` with ``tap = dy * k + dx``; PyTorch's
``F.unfold`` is channel-major (``c * k² + tap``), and the decoder packs its
weights accordingly (ops/kernels/decoder.py).
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
