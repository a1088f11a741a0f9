"""Resampling primitives with PyTorch grid-sample semantics, on NHWC.

Counterpart of ciaosr_tpu/ops/sampling.py. Conventions (align_corners=False):
  unnormalized coord  ix = ((x + 1) * W - 1) / 2
  nearest index       round-half-even(ix)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def nearest_index(coord: torch.Tensor, size: int) -> torch.Tensor:
    """Nearest-neighbour source index for normalized coords in [-1, 1]
    (int32). Out-of-range coords give out-of-range indices; callers clamp."""
    ix = ((coord + 1.0) * size - 1.0) / 2.0
    return torch.round(ix).to(torch.int32)   # torch.round: half to even


def grid_sample_bilinear_border(feat: torch.Tensor,
                                coord: torch.Tensor) -> torch.Tensor:
    """Bilinear grid-sample with 'border' padding (coordinate clamping).
    feat (B, H, W, C); coord (B, Q, 2) in (y, x) order → (B, Q, C)."""
    b, h, w, c = feat.shape
    iy = torch.clamp(((coord[..., 0] + 1.0) * h - 1.0) / 2.0, 0.0, h - 1.0)
    ix = torch.clamp(((coord[..., 1] + 1.0) * w - 1.0) / 2.0, 0.0, w - 1.0)
    y0, x0 = torch.floor(iy), torch.floor(ix)
    wy, wx = (iy - y0)[..., None], (ix - x0)[..., None]
    y0i, x0i = y0.long(), x0.long()
    y1i, x1i = torch.clamp(y0i + 1, 0, h - 1), torch.clamp(x0i + 1, 0, w - 1)
    flat = feat.reshape(b, h * w, c)

    def tap(yi, xi):
        return torch.gather(flat, 1, (yi * w + xi)[..., None].expand(
            -1, -1, c))

    return (tap(y0i, x0i) * (1 - wy) * (1 - wx) + tap(y0i, x1i) * (1 - wy)
            * wx + tap(y1i, x0i) * wy * (1 - wx) + tap(y1i, x1i) * wy * wx)


def interpolate_bilinear(x: torch.Tensor, out_h: int,
                         out_w: int) -> torch.Tensor:
    """``F.interpolate(mode='bilinear', align_corners=False)`` on NHWC,
    no antialias. x: (B, H, W, C) → (B, out_h, out_w, C)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).contiguous()


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """``interpolate_bilinear`` to 2H × 2W (align_corners False) on NCHW,
    by slices and adds: out[2i] = x[i-1]/4 + 3x[i]/4 and out[2i+1] =
    3x[i]/4 + x[i+1]/4 along each axis, the edges clamped. Its backward is
    slices and adds too, so it gives the same bits on every run, where
    F.interpolate's CUDA backward adds by atomics. x: (B, C, H, W)."""
    def axis(v: torch.Tensor, dim: int) -> torch.Tensor:
        n = v.shape[dim]
        prev = torch.cat([v.narrow(dim, 0, 1), v.narrow(dim, 0, n - 1)], dim)
        nxt = torch.cat([v.narrow(dim, 1, n - 1), v.narrow(dim, n - 1, 1)],
                        dim)
        even = 0.25 * prev + 0.75 * v
        odd = 0.75 * v + 0.25 * nxt
        return torch.stack([even, odd], dim + 1).flatten(dim, dim + 1)

    return axis(axis(x, 2), 3)
