"""SwinIR encoder trunk (window attention), eval and training.

Counterpart of ciaosr_tpu/models/swinir.py::SwinIREncoder: reflect-pad to
a window multiple → conv_first → patch-embed LayerNorm → residual Swin
groups (Swin blocks, 3×3 conv, residual) → LayerNorm → conv_after_body →
+ conv_first's output → crop back. The state_dict layout is the
reference's (``conv_first``, ``patch_embed.norm``,
``layers.{i}.residual_group.blocks.{j}.{norm1, attn.qkv, attn.proj,
attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}``,
``layers.{i}.conv``, ``norm``, ``conv_after_body``); the relative-position
index and the shift masks are recomputed, not stored.

Each block takes the route the JAX package's SwinBlock takes: with
``use_kernels`` and a map that tiles into its windows (H % ws == W % ws ==
0), the whole block runs as one kernel on the rolled map (row 11,
ops/kernels/swin_block.py), and under autograd as ``SwinBlockFunction``,
whose backward is row 12; otherwise the plain block below, which is the
JAX package's own XLA route, not a fallback. The residual stream between
blocks is f32 in both packages; the convs run in the compute dtype
through cuDNN, as XLA convs in JAX, except the square 3×3 convs of the
trunk (each RSTB's and conv_after_body) in an f32 model with
``use_kernels``: their forward is the f32 kernel of ops/kernels/conv3x3.py
(cuDNN's f32 heuristics take an FFT route there), their backward cuDNN's.
conv_first (3 → C) keeps cuDNN.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ciaosr_torch.config.registry import BACKBONES
from ciaosr_torch.core import trace
from ciaosr_torch.models.rdn import conv
from ciaosr_torch.ops import kernels
from ciaosr_torch.ops.kernels.conv3x3 import Conv3x3Function
from ciaosr_torch.ops.kernels.swin_block import (SwinBlockFunction,
                                                 attn_mask, gelu,
                                                 pack_swin_block,
                                                 relative_bias, swin_block,
                                                 window_partition,
                                                 window_reverse)


def _linear(x: torch.Tensor, layer: nn.Linear,
            dtype: torch.dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def trunk_conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype,
               use_kernels: bool) -> torch.Tensor:
    """A square 3×3 conv of the trunk on x, the NCHW view of an NHWC map:
    the f32 kernel's Function in an f32 model with ``use_kernels`` (its
    plain version, ``F.conv2d``, on the CPU), else ``conv``."""
    if use_kernels and dtype == torch.float32:
        return Conv3x3Function.apply(x, layer.weight, layer.bias)
    return conv(x, layer, dtype)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """f32 LayerNorm (eps 1e-5) of any-dtype x: f32 out, as flax's
    LayerNorm with f32 params returns."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.window_size, self.num_heads = window_size, num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))

    def forward(self, x: torch.Tensor, mask, dtype: torch.dtype):
        """Windows x (B·nW, N, C) → (B·nW, N, C) in ``dtype``."""
        bw, n, c = x.shape
        heads = self.num_heads
        ws = round(n ** 0.5)
        qkv = _linear(x, self.qkv, dtype).reshape(bw, n, 3, heads,
                                                  c // heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        q = q * (c // heads) ** -0.5
        attn = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float())
        attn = attn + relative_bias(self.relative_position_bias_table, ws,
                                    self.window_size)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(bw // nw, nw, heads, n, n) + torch.as_tensor(
                mask, device=x.device)[None, :, None]
            attn = attn.reshape(bw, heads, n, n)
        attn = torch.softmax(attn, -1)
        out = torch.einsum("bhnm,bhmd->bhnd", attn, v.float())
        out = out.transpose(1, 2).reshape(bw, n, c)
        return _linear(out, self.proj, dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift_size: int, mlp_ratio: float = 2.0,
                 qkv_bias: bool = True):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self._packed: dict = {}

    def geometry(self, h: int, w: int) -> tuple[int, int]:
        """(ws, shift) at an h × w map: the window shrinks to the map, and
        the shift is dropped when it does or when the map is one window."""
        ws = min(self.window_size, h, w)
        shift = self.shift_size if ws == self.window_size else 0
        if min(h, w) <= self.window_size:
            shift = 0
        return ws, shift

    def packed(self, ws: int, dtype: torch.dtype) -> dict:
        """``pack_swin_block`` of this block, kept until a parameter
        changes (keyed on the parameters' version counters)."""
        params = tuple(self.parameters())
        key = (ws, dtype, params[0].device)
        version = tuple((p.data_ptr(), p._version) for p in params)
        hit = self._packed.get(key)
        if hit is None or hit[0] != version:
            with trace.span("swin.pack"):
                hit = (version, pack_swin_block(self, ws, dtype))
            trace.count("swin.packs")
            self._packed[key] = hit
        else:
            trace.count("swin.pack_hits")
        return hit[1]

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                use_kernels: bool = False) -> torch.Tensor:
        """x: (B, H, W, C) f32 tokens → (B, H, W, C) f32."""
        with trace.span("swin.block", device=True):
            b, h, w, c = x.shape
            ws, shift = self.geometry(h, w)
            if use_kernels and h % ws == 0 and w % ws == 0:
                xi = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
                xi = xi.float().contiguous()
                # the packing in the route's dtype (bf16 on the card); x is
                # f32
                kdt = kernels.route_dtype(x.device, dtype)
                if torch.is_grad_enabled():   # training: rows 11 and 12
                    y = SwinBlockFunction.apply(xi, self, ws, shift, kdt,
                                                *self.parameters())
                else:
                    y = swin_block(xi, self.packed(ws, kdt), ws, shift)
                return torch.roll(y, (shift, shift), (1, 2)) if shift else y
            # the JAX package's XLA block (its route when the map does not
            # tile into windows, and whenever kernels are off)
            y = _layer_norm(x, self.norm1)
            if shift:
                y = torch.roll(y, (-shift, -shift), (1, 2))
            y = window_reverse(self.attn(window_partition(y, ws),
                                         attn_mask(h, w, ws, shift), dtype),
                               ws, h, w)
            if shift:
                y = torch.roll(y, (shift, shift), (1, 2))
            x = x + y
            y = gelu(_linear(_layer_norm(x, self.norm2), self.mlp.fc1,
                             dtype))
            return x + _linear(y, self.mlp.fc2, dtype)


class BasicLayer(nn.Module):
    def __init__(self, blocks: Sequence[SwinBlock]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class RSTB(nn.Module):
    """Residual Swin Transformer Block: Swin blocks, a 3×3 conv, the
    residual."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, mlp_ratio: float = 2.0,
                 qkv_bias: bool = True):
        super().__init__()
        self.residual_group = BasicLayer([
            SwinBlock(dim, num_heads, window_size,
                      0 if i % 2 == 0 else window_size // 2, mlp_ratio,
                      qkv_bias) for i in range(depth)])
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                use_kernels: bool) -> torch.Tensor:
        res = x
        for blk in self.residual_group.blocks:
            x = blk(x, dtype, use_kernels)
        img = trunk_conv(x.permute(0, 3, 1, 2), self.conv, dtype,
                         use_kernels)
        return img.permute(0, 2, 3, 1) + res


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch_norm: bool):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5) if patch_norm else None


@BACKBONES.register(name="SwinIR")
class SwinIR(nn.Module):
    """SwinIR trunk for CiaoSR; the upsampler head is never built (the
    reference builds then discards it). Head-only config keys are accepted
    and unused, as in the JAX package. Takes and returns NHWC."""

    def __init__(self, img_size: int = 48, in_chans: int = 3,
                 embed_dim: int = 180, depths: Sequence[int] = (6,) * 6,
                 num_heads: Sequence[int] = (6,) * 6, window_size: int = 8,
                 mlp_ratio: float = 2.0, qkv_bias: bool = True,
                 patch_norm: bool = True, img_range: float = 1.0,
                 upscale: int = 4, upsampler: str = "",
                 resi_connection: str = "1conv", compress_ratio: int = 3,
                 squeeze_factor: int = 30, conv_scale: float = 0.01,
                 overlap_ratio: float = 0.5, ape: bool = False):
        super().__init__()
        self.embed_dim, self.window_size = embed_dim, window_size
        self.mid_channels = embed_dim   # the decoder's feat_dim
        self.conv_first = nn.Conv2d(in_chans, embed_dim, 3, padding=1)
        self.patch_embed = PatchEmbed(embed_dim, patch_norm)
        self.layers = nn.ModuleList(
            RSTB(embed_dim, d, h, window_size, mlp_ratio, qkv_bias)
            for d, h in zip(depths, num_heads))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, padding=1)

    @torch.no_grad()
    def init_trunk_(self, g: torch.Generator) -> None:
        """The reference's trunk init, drawn from ``g``: Linear weights and
        relative-position tables trunc-normal(0.02) (cut at ±2), Linear
        biases 0, LayerNorms 1 / 0. The convs keep PyTorch's default."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, generator=g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, WindowAttention):
                nn.init.trunc_normal_(m.relative_position_bias_table,
                                      std=0.02, generator=g)

    def embed(self, x: torch.Tensor, dtype: torch.dtype):
        """x (B, H, W, 3) → the first group's tokens (B, H', W', C) f32 and
        conv_first's output (B, C, H', W') in ``dtype``, H' and W' padded
        (reflect) to window multiples."""
        _, h0, w0, _ = x.shape
        ws = self.window_size
        img = x.permute(0, 3, 1, 2)
        pad_h, pad_w = (ws - h0 % ws) % ws, (ws - w0 % ws) % ws
        if pad_h or pad_w:
            img = F.pad(img, (0, pad_w, 0, pad_h), mode="reflect")
        skip = conv(img, self.conv_first, dtype)
        feat = skip.permute(0, 2, 3, 1)
        if self.patch_embed.norm is not None:
            feat = _layer_norm(feat, self.patch_embed.norm)
        return feat, skip

    def head(self, feat: torch.Tensor, skip: torch.Tensor, h0: int, w0: int,
             dtype: torch.dtype, use_kernels: bool = False) -> torch.Tensor:
        """The last LayerNorm, conv_after_body and the skip, cropped back
        to h0 × w0: (B, h0, w0, C) in ``dtype``."""
        feat = _layer_norm(feat, self.norm).permute(0, 3, 1, 2)
        out = trunk_conv(feat, self.conv_after_body, dtype,
                         use_kernels) + skip
        return out[:, :, :h0, :w0].permute(0, 2, 3, 1).contiguous()

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                use_kernels: bool = False) -> torch.Tensor:
        """x (B, H, W, 3) → features (B, H, W, embed_dim) in ``dtype``."""
        feat, skip = self.embed(x, dtype)
        for layer in self.layers:
            feat = layer(feat, dtype, use_kernels)
        return self.head(feat, skip, x.shape[1], x.shape[2], dtype,
                         use_kernels)
