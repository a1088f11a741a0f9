"""RDN encoder trunk (Residual Dense Network, no upsampler).

Counterpart of ciaosr_tpu/models/rdn.py in the reference's plain
dense-concat form: sfe1 → sfe2 → residual dense blocks (conv-relu layers
over the growing channel concat, 1×1 local fusion, local residual) →
global fusion (1×1 then 3×3 over all block outputs) → + sfe1. The JAX
package's slice-sum and layer pairing are TPU compute tricks over the same
parameters; here the convs go to cuDNN as they are.

Modules hold f32 params; ``dtype`` is the compute dtype (bf16 casts the
activations and the weights per conv, as the JAX ``dtype`` field does).
Public tensors are NHWC, like the JAX package's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ciaosr_torch.config.registry import BACKBONES


def conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype,
         **kw) -> torch.Tensor:
    """NCHW ``layer(x)`` computed in ``dtype``; ``kw`` overrides the
    layer's stride/padding."""
    return F.conv2d(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype),
                    stride=kw.get("stride", layer.stride),
                    padding=kw.get("padding", layer.padding))


class DenseLayer(nn.Module):
    def __init__(self, in_channels: int, growth: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, growth, 3, padding=1)


class ResidualDenseBlock(nn.Module):
    def __init__(self, mid_channels: int, growth: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            DenseLayer(mid_channels + i * growth, growth)
            for i in range(num_layers))
        self.lff = nn.Conv2d(mid_channels + num_layers * growth,
                             mid_channels, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        feats = x
        for layer in self.layers:
            feats = torch.cat(
                [feats, torch.relu(conv(feats, layer.conv, dtype))], dim=1)
        return x + conv(feats, self.lff, dtype)


@BACKBONES.register(name="RDN")
class RDN(nn.Module):
    """RDN trunk. Takes and returns NHWC; convs run NCHW."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 mid_channels: int = 64, num_blocks: int = 16,
                 num_layers: int = 8, channel_growth: int = 64,
                 upscale_factor: int = 4):
        # out_channels / upscale_factor are config parity: the trunk has no
        # head (ciaosr_tpu/models/rdn.py RDNEncoder)
        super().__init__()
        self.mid_channels = mid_channels
        self.sfe1 = nn.Conv2d(in_channels, mid_channels, 3, padding=1)
        self.sfe2 = nn.Conv2d(mid_channels, mid_channels, 3, padding=1)
        self.rdbs = nn.ModuleList(
            ResidualDenseBlock(mid_channels, channel_growth, num_layers)
            for _ in range(num_blocks))
        self.gff = nn.Sequential(
            nn.Conv2d(mid_channels * num_blocks, mid_channels, 1),
            nn.Conv2d(mid_channels, mid_channels, 3, padding=1))

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        sfe1 = conv(x, self.sfe1, dtype)
        feat = conv(sfe1, self.sfe2, dtype)
        locals_ = []
        for rdb in self.rdbs:
            feat = rdb(feat, dtype)
            locals_.append(feat)
        g = conv(torch.cat(locals_, dim=1), self.gff[0], dtype)
        g = conv(g, self.gff[1], dtype) + sfe1
        return g.permute(0, 2, 3, 1).contiguous()
