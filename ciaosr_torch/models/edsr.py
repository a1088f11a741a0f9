"""EDSR encoder trunk (no upsampler).

Counterpart of ciaosr_tpu/models/edsr.py: conv_first → N residual blocks
without batch norm (conv1, ReLU, conv2, · res_scale, + identity) →
conv_after_body → + conv_first. Every conv goes to cuDNN.

Modules hold f32 params; ``dtype`` is the compute dtype (bf16 casts the
activations and the weights per conv, as in ``models/rdn.py``). Public
tensors are NHWC, like the JAX package's.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ciaosr_torch.config.registry import BACKBONES
from ciaosr_torch.models.rdn import conv


class ResidualBlockNoBN(nn.Module):
    def __init__(self, mid_channels: int = 64, res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = nn.Conv2d(mid_channels, mid_channels, 3, padding=1)
        self.conv2 = nn.Conv2d(mid_channels, mid_channels, 3, padding=1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = conv(torch.relu(conv(x, self.conv1, dtype)), self.conv2, dtype)
        return x + y * self.res_scale


@BACKBONES.register(name="EDSR")
class EDSR(nn.Module):
    """EDSR trunk. Takes and returns NHWC; convs run NCHW."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 mid_channels: int = 64, num_blocks: int = 16,
                 res_scale: float = 1.0, upscale_factor: int = 4):
        # out_channels / upscale_factor are config parity: the trunk has no
        # head (ciaosr_tpu/models/edsr.py EDSREncoder)
        super().__init__()
        self.mid_channels = mid_channels
        self.conv_first = nn.Conv2d(in_channels, mid_channels, 3, padding=1)
        self.body = nn.ModuleList(
            ResidualBlockNoBN(mid_channels, res_scale)
            for _ in range(num_blocks))
        self.conv_after_body = nn.Conv2d(mid_channels, mid_channels, 3,
                                         padding=1)

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        x = conv(x.permute(0, 3, 1, 2), self.conv_first, dtype)
        res = x
        for blk in self.body:
            res = blk(res, dtype)
        res = conv(res, self.conv_after_body, dtype) + x
        return res.permute(0, 2, 3, 1).contiguous()
