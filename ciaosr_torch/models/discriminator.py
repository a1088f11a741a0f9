"""U-Net discriminators with spectral normalization, NCHW, on cuDNN convs.

Counterpart of ciaosr_tpu/models/discriminator.py: three strided SN-conv
downs, three bilinear ×2 ups with SN convs and skip adds, two SN convs and
a plain 3×3 head, LeakyReLU(0.2) after every conv but the head
(``UNetDiscriminatorWithSpectralNorm``); the small variant has two downs
and two ups. ``conv_0`` and ``conv_9`` carry a bias, the SN convs none.
The ×2 ups are ``ops/sampling.py::upsample2x_bilinear``, the bilinear
resize of JAX's ``interpolate_bilinear`` in a form whose backward gives
the same bits on every run (a resumed GAN run then equals an
uninterrupted one).

The spectral norm is flax's ``nn.SpectralNorm`` (one power-iteration
step), not torch's: the HWIO-ordered kernel as a (kh·kw·in, out) matrix
W, v = l2n(u Wᵀ), u' = l2n(v W), σ = v W u'ᵀ and the conv runs with
W / σ, on EVERY call. ``update_stats=True`` stores u' and σ in the
``u`` (1, out) and ``sigma`` buffers (saved in checkpoints); False leaves
them as they are. u and v carry no gradient, σ does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ciaosr_torch.config.registry import COMPONENTS
from ciaosr_torch.ops.sampling import upsample2x_bilinear

SN_EPS = 1e-12


def _l2_normalize(x: torch.Tensor, eps: float = SN_EPS) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


class SNConv2d(nn.Conv2d):
    """A bias-free conv whose kernel is divided by its spectral norm's
    power-iteration estimate on every call."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, bias=False)
        self.register_buffer("u", torch.randn(1, out_channels))
        self.register_buffer("sigma", torch.ones(()))

    def normalized_weight(self, update_stats: bool) -> torch.Tensor:
        w = self.weight.permute(2, 3, 1, 0).reshape(-1, self.out_channels)
        with torch.no_grad():
            v = _l2_normalize(self.u @ w.t())
            u = _l2_normalize(v @ w)
        sigma = (v @ w @ u.t())[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return self.weight / torch.where(sigma != 0, sigma,
                                         torch.ones_like(sigma))

    def forward(self, x: torch.Tensor,
                update_stats: bool = False) -> torch.Tensor:
        return F.conv2d(x, self.normalized_weight(update_stats), None,
                        self.stride, self.padding)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class _UNetSN(nn.Module):
    """The shared parts: head conv, SN tail, plain output conv."""

    def _tail(self, m: int) -> None:
        self.conv_7 = SNConv2d(m, m, 3)
        self.conv_8 = SNConv2d(m, m, 3)
        self.conv_9 = nn.Conv2d(m, 1, 3, padding=1)

    def _out(self, x: torch.Tensor, update_stats: bool) -> torch.Tensor:
        x = _lrelu(self.conv_7(x, update_stats))
        x = _lrelu(self.conv_8(x, update_stats))
        return self.conv_9(x)

    @torch.no_grad()
    def init_stats_(self, seed: int) -> None:
        """Every SN conv's u drawn N(0, 1) from a generator seeded with
        ``seed``, σ = 1 (flax's init of the two)."""
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, SNConv2d):
                m.u.copy_(torch.randn(m.u.shape, generator=g))
                m.sigma.fill_(1.0)


@COMPONENTS.register(name="UNetDiscriminatorWithSpectralNorm")
class UNetDiscriminatorSN(_UNetSN):
    def __init__(self, in_channels: int = 3, mid_channels: int = 64,
                 skip_connection: bool = True):
        super().__init__()
        m = mid_channels
        self.skip_connection = skip_connection
        self.conv_0 = nn.Conv2d(in_channels, m, 3, padding=1)
        self.conv_1 = SNConv2d(m, m * 2, 4, 2)
        self.conv_2 = SNConv2d(m * 2, m * 4, 4, 2)
        self.conv_3 = SNConv2d(m * 4, m * 8, 4, 2)
        self.conv_4 = SNConv2d(m * 8, m * 4, 3)
        self.conv_5 = SNConv2d(m * 4, m * 2, 3)
        self.conv_6 = SNConv2d(m * 2, m, 3)
        self._tail(m)

    def forward(self, img: torch.Tensor,
                update_stats: bool = False) -> torch.Tensor:
        """img (B, C, H, W), H and W multiples of 8 → logits (B, 1, H, W)."""
        us = update_stats
        x0 = _lrelu(self.conv_0(img))
        x1 = _lrelu(self.conv_1(x0, us))
        x2 = _lrelu(self.conv_2(x1, us))
        x3 = _lrelu(self.conv_3(x2, us))
        x4 = _lrelu(self.conv_4(upsample2x_bilinear(x3), us))
        if self.skip_connection:
            x4 = x4 + x2
        x5 = _lrelu(self.conv_5(upsample2x_bilinear(x4), us))
        if self.skip_connection:
            x5 = x5 + x1
        x6 = _lrelu(self.conv_6(upsample2x_bilinear(x5), us))
        if self.skip_connection:
            x6 = x6 + x0
        return self._out(x6, us)


@COMPONENTS.register(name="SmallUNetDiscriminatorWithSpectralNorm")
class SmallUNetDiscriminatorSN(_UNetSN):
    """Two SN-conv downs, two bilinear ups with skip adds, the same
    tail."""

    def __init__(self, in_channels: int = 3, mid_channels: int = 64,
                 skip_connection: bool = True):
        super().__init__()
        m = mid_channels
        self.skip_connection = skip_connection
        self.conv_0 = nn.Conv2d(in_channels, m, 3, padding=1)
        self.conv_1 = SNConv2d(m, m, 4, 2)
        self.conv_2 = SNConv2d(m, m, 4, 2)
        self.conv_5 = SNConv2d(m, m, 3)
        self.conv_6 = SNConv2d(m, m, 3)
        self._tail(m)

    def forward(self, img: torch.Tensor,
                update_stats: bool = False) -> torch.Tensor:
        """img (B, C, H, W), H and W multiples of 4 → logits (B, 1, H, W)."""
        us = update_stats
        x0 = _lrelu(self.conv_0(img))
        x1 = _lrelu(self.conv_1(x0, us))
        x2 = _lrelu(self.conv_2(x1, us))
        x5 = _lrelu(self.conv_5(upsample2x_bilinear(x2), us))
        if self.skip_connection:
            x5 = x5 + x1
        x6 = _lrelu(self.conv_6(upsample2x_bilinear(x5), us))
        if self.skip_connection:
            x6 = x6 + x0
        return self._out(x6, us)
