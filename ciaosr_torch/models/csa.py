"""Cross-Scale (non-local) Attention, average=True.

Counterpart of ciaosr_tpu/models/csa.py::CrossScaleAttention: reflect pad
to a multiple of s; 1×1 conv + PReLU embed/match maps; bilinear
downsample and L2-normalized 3×3 key patches (1e-4 floor); the stencil
middle (K4, ops/kernels/csa_stencil.py); the strided down conv, /6 and the
crop. The JAX package's VMEM admission logic has no counterpart here.
Public tensors are NHWC; the convs run NCHW.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ciaosr_torch.models.rdn import conv
from ciaosr_torch.ops.kernels.csa_stencil import (csa_stencil,
                                                  csa_stencil_plain)
from ciaosr_torch.ops.neighborhood import extract_patches_same


def _block(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 1), nn.PReLU())


def _basic(x: torch.Tensor, blk: nn.Sequential,
           dtype: torch.dtype) -> torch.Tensor:
    return F.prelu(conv(x, blk[0], dtype), blk[1].weight.to(dtype))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class CrossScaleAttention(nn.Module):
    """Scale-aware non-local attention over s·3×3 ↔ 3×3 patch pairs."""

    def __init__(self, channels: int = 64, reduction: int = 2,
                 scales: Sequence[int] = (2,), softmax_scale: float = 10.0,
                 average: bool = True):
        super().__init__()
        if not average:
            raise NotImplementedError(
                "CrossScaleAttention(average=False) (argmax + overlap-add) "
                "is not ported yet: ROADMAP.md queue 1 item 3")
        cr = channels // reduction
        self.scales = tuple(scales)
        self.softmax_scale = softmax_scale
        self.conv_match_1 = _block(channels, cr)
        self.conv_match_2 = _block(channels, cr)
        self.conv_assembly = _block(channels, channels)
        for s in self.scales:
            setattr(self, "down" if s == 2 else f"downx{s}",
                    nn.Conv2d(channels, channels, 3, stride=s, padding=1))

    def forward(self, x: torch.Tensor, use_kernel: bool = False,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """x: (B, H, W, C) → (B, H, W, C·len(scales)). ``use_kernel``
        routes the middle through K4 (its plain version on CPU tensors);
        otherwise the plain version runs wherever x lies."""
        _, h, w, _ = x.shape
        outs = []
        for s in self.scales:
            match, keys, embed = self.stencil_inputs(x, s, dtype)
            middle = csa_stencil if use_kernel else csa_stencil_plain
            y = middle(match, keys, embed, self.softmax_scale, s)
            down = getattr(self, "down" if s == 2 else f"downx{s}")
            y = conv(y.permute(0, 3, 1, 2), down, dtype) / 6.0
            outs.append(y[:, :, :h, :w])
        return _nhwc(torch.cat(outs, dim=1))

    def stencil_inputs(self, x: torch.Tensor, s: int, dtype: torch.dtype):
        """The middle's inputs at scale s: match (B, Hp, Wp, Cr), keys
        (B, L, 9Cr) and embed (B, Hp, Wp, C), contiguous, in ``dtype``;
        Hp, Wp are H, W reflect-padded up to multiples of s."""
        _, h, w, _ = x.shape
        xn = x.permute(0, 3, 1, 2)
        pad_h, pad_w = (s - h % s) % s, (s - w % s) % s
        xp = F.pad(xn, (0, pad_w, 0, pad_h), mode="reflect") \
            if (pad_h or pad_w) else xn
        hp, wp = h + pad_h, w + pad_w
        embed = _nhwc(_basic(xp, self.conv_assembly, dtype))
        match = _nhwc(_basic(xp, self.conv_match_1, dtype))
        ref = F.interpolate(xp.to(dtype), size=(hp // s, wp // s),
                            mode="bilinear", align_corners=False)
        refm = _nhwc(_basic(ref, self.conv_match_2, dtype))
        w_pat = extract_patches_same(refm, 3, 1).float()
        norm = torch.sqrt((w_pat * w_pat).sum(-1, keepdim=True))
        keys = (w_pat / torch.clamp(norm, min=1e-4)).to(dtype).contiguous()
        return match, keys, embed
