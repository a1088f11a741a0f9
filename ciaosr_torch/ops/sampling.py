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


def interpolate_bilinear(x: torch.Tensor, out_h: int,
                         out_w: int) -> torch.Tensor:
    """``F.interpolate(mode='bilinear', align_corners=False)`` on NHWC,
    no antialias. x: (B, H, W, C) → (B, out_h, out_w, C)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).contiguous()
