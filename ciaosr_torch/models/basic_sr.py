"""Fixed-scale SR generators: EDSRNet and RDNNet, the EDSR and RDN trunks
with a pixel-shuffle upsampler and an output conv.

Counterpart of ciaosr_tpu/models/basic_sr.py, the generators that
``BasicRestorer`` (models/restorers.py) wraps. Each net is its trunk
(models/edsr.py, models/rdn.py) with the head added, so the trunk's
parameters keep the port's encoder names. state_dict keys:

* EDSRNet: ``conv_first``, ``body.{i}.conv1`` / ``conv2``,
  ``conv_after_body``, then ``upsample.{j}`` and ``conv_last``;
* RDNNet: ``sfe1``, ``sfe2``, ``rdbs.{i}.layers.{k}.conv``,
  ``rdbs.{i}.lff``, ``gff.0`` / ``gff.1``, then ``upsample.{j}`` and
  ``conv_last``;

where ``upsample.{j}`` is the conv of the j-th upsampling step (JAX's
``upsample/up_j``). Public tensors are NHWC, convs run NCHW through
``models/rdn.conv`` in the compute ``dtype`` (f32 params); the pixel
shuffle is torch's (channel-major sub-pixel order). Both nets return f32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ciaosr_torch.config.registry import BACKBONES
from ciaosr_torch.core.device import resolve_dtype
from ciaosr_torch.models.edsr import EDSR
from ciaosr_torch.models.rdn import RDN, conv


# the fixed-scale generators of BACKBONES; its other entries (RDN, EDSR,
# SwinIR) are the CiaoSR generators' encoder trunks
FIXED_SCALE = ("EDSRNet", "RDNNet")


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC pixel shuffle with torch's channel order: input channel
    c·r² + dy·r + dx → output channel c at offset (dy, dx)."""
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


def upsample_steps(scale: int) -> list[int]:
    """The shuffle factors of an upsampler to ``scale``: a ×2 step while
    the scale is even, then one ×3 step (mmedit's ``UpsampleModule``)."""
    s, steps = scale, []
    while s % 2 == 0:
        steps.append(2)
        s //= 2
    if s == 3:
        steps.append(3)
    elif s != 1:
        raise ValueError(f"unsupported upscale factor {scale}")
    return steps


class PixelShuffleUpsample(nn.ModuleList):
    """conv (C → C·r²) + pixel shuffle per step of ``upsample_steps``;
    item j is step j's conv. Takes and returns NHWC."""

    def __init__(self, scale: int, mid_channels: int):
        factors = upsample_steps(scale)
        super().__init__(nn.Conv2d(mid_channels, mid_channels * r * r, 3,
                                   padding=1) for r in factors)
        self.factors = factors

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        for layer, r in zip(self, self.factors):
            x = pixel_shuffle(conv(x.permute(0, 3, 1, 2), layer, dtype)
                              .permute(0, 2, 3, 1), r)
        return x


def _head(net, feat: torch.Tensor) -> torch.Tensor:
    """The upsampler and conv_last on the trunk's NHWC features, f32."""
    up = net.upsample(feat, net.dtype)
    out = conv(up.permute(0, 3, 1, 2), net.conv_last, net.dtype)
    return out.permute(0, 2, 3, 1).float()


@BACKBONES.register(name="EDSRNet")
class EDSRNet(EDSR):
    """EDSR with its head: (x − rgb_mean) / rgb_std, the trunk, the
    upsampler and conv_last, then out · rgb_std + rgb_mean."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 mid_channels: int = 64, num_blocks: int = 16,
                 upscale_factor: int = 4, res_scale: float = 1.0,
                 rgb_mean=(0.4488, 0.4371, 0.4040), rgb_std=(1.0, 1.0, 1.0),
                 dtype=None):
        super().__init__(in_channels, out_channels, mid_channels,
                         num_blocks, res_scale)
        self.upscale_factor = upscale_factor
        self.dtype = resolve_dtype(dtype)
        self.upsample = PixelShuffleUpsample(upscale_factor, mid_channels)
        self.conv_last = nn.Conv2d(mid_channels, out_channels, 3, padding=1)
        self.register_buffer("rgb_mean", torch.tensor(rgb_mean), False)
        self.register_buffer("rgb_std", torch.tensor(rgb_std), False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) → (B, H·s, W·s, 3), f32."""
        feat = super().forward((x - self.rgb_mean) / self.rgb_std,
                               self.dtype)
        return _head(self, feat) * self.rgb_std + self.rgb_mean


@BACKBONES.register(name="RDNNet")
class RDNNet(RDN):
    """RDN with its head: the trunk, the upsampler and conv_last."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 mid_channels: int = 64, num_blocks: int = 16,
                 num_layers: int = 8, channel_growth: int = 64,
                 upscale_factor: int = 4, dtype=None):
        super().__init__(in_channels, out_channels, mid_channels,
                         num_blocks, num_layers, channel_growth)
        self.upscale_factor = upscale_factor
        self.dtype = resolve_dtype(dtype)
        self.upsample = PixelShuffleUpsample(upscale_factor, mid_channels)
        self.conv_last = nn.Conv2d(mid_channels, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) → (B, H·s, W·s, 3), f32."""
        return _head(self, super().forward(x, self.dtype))
