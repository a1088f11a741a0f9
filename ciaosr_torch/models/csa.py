"""Cross-Scale (non-local) Attention.

Counterpart of ciaosr_tpu/models/csa.py::CrossScaleAttention: reflect pad
to a multiple of s; 1×1 conv + PReLU embed/match maps; bilinear
downsample and L2-normalized 3×3 key patches (1e-4 floor); the middle;
the strided down conv, /6 and the crop. Public tensors are NHWC; the convs
run NCHW.

The middle. average=True: the plain route is the stencil form
(``_stencil_reconstruct``); the kernel route takes, at each geometry, the
kernel the JAX package picks there (``csa_route``), on the maps
zero-padded to the kernels' compiled widths (``csa_stencil.pad_maps``:
config 001 swinir's Cr = 90, C = 180 to 96, 192; the flagship's 32, 64 as
they are) and cropped back after it. average=False:
the hard-argmax bank route in plain PyTorch, which the JAX package also
runs without a kernel.
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ciaosr_torch.models.rdn import conv
from ciaosr_torch.ops import kernels
from ciaosr_torch.ops.kernels.csa_attention import csa_attention, csa_fused
from ciaosr_torch.ops.kernels.csa_stencil import (csa_stencil,
                                                  csa_stencil_fused,
                                                  csa_stencil_fused_plain,
                                                  pad_maps, row_blocks)
from ciaosr_torch.ops.neighborhood import extract_patches_same, overlap_add

# the JAX package's VMEM admission budget off a TPU (its vmem_budget()),
# overridden there and here by CIAOSR_CSA_VMEM_BUDGET (bytes)
_VMEM_BUDGET = 85 * 1024 * 1024


def aligned_channels(s: int, channels: int) -> int:
    """Smallest C' ≥ channels with s²·C' a multiple of 128."""
    per = 128 // math.gcd(s * s, 128)
    return -(-channels // per) * per


def csa_route(hp: int, wp: int, s: int, channels: int, cr: int, es: int,
              batch: int = 1) -> str:
    """The CSA middle the JAX package runs at this geometry: "stencil_fused"
    (K4), "stencil" (row 5), "resident" or "windowed" (row 6, one kernel
    here) or "streaming" (row 7 over explicit banks, then the overlap-add).

    A copy of ciaosr_tpu/models/csa.py::_fused_admission_impl, mode only:
    its VMEM footprints and 8-alignment gates are TPU decisions (v5e VMEM,
    Mosaic tiling), kept so that both packages take the same route at
    every geometry. Whether the H100 should route otherwise is open
    (PERF.md §7). ``es`` is the compute element size (2 for bf16, 4 for
    f32). The budget is the JAX package's off-TPU default; the
    CIAOSR_CSA_VMEM_BUDGET override is honoured only to mirror that
    package's route (one variable steers both in a test): no VMEM budget
    applies to the Hopper kernels."""
    env = os.environ.get("CIAOSR_CSA_VMEM_BUDGET")
    budget = int(env) if env else _VMEM_BUDGET
    rows = [r for r in range(1, 9) if hp % r == 0 and (r * wp) % 8 == 0]
    if not (rows and hp % s == 0 and wp % 8 == 0 and (wp // s) % 8 == 0):
        return "streaming"
    c_eff = aligned_channels(s, channels)

    wq = wp // s
    l_act = (hp // s) * wq
    tl = min(1024, -(-l_act // 128) * 128)
    l_pad = -(-l_act // tl) * tl
    sc2 = s * s * c_eff
    if l_pad // tl <= 128:                      # the one-kernel stencil
        hr = wp + 8
        hc = -(-(wq + 1) // 128) * 128
        tp_target = 1152 if sc2 <= 256 else 768
        for r in sorted(rows, key=lambda r: abs(r * wp - tp_target)):
            tp = r * wp
            tph = tp + 2 * hr
            vmem = (tph * (l_pad + 2 * hc) * 2
                    + tph * max(9 * cr, 128) * es
                    + 3 * tph * 128 * 4
                    + tp * sc2 * 4
                    + 3 * (tp + 2 * (hr + wp)) * max(cr, 128) * es * 2
                    + 2 * tl * max(9 * cr, 128) * es
                    + 2 * tl * sc2 * es
                    + tp * sc2 * 4)
            if vmem < budget:
                return "stencil_fused"

    tp = min(rows, key=lambda r: abs(r * wp - 1024)) * wp
    dv = 9 * sc2
    vmem = (tp * dv * 4
            + 2 * tl * dv * es
            + 3 * (l_pad + 2 * wq) * sc2 * es
            + 3 * (hp * wp + 2 * wp) * max(cr, 128) * es
            + l_pad * max(9 * cr, 128) * es
            + tp * tl * 4)
    if vmem < budget:
        return "resident"

    hr, hc = wp + 8, -(-(wq + 1) // 64) * 64    # the two-kernel stencil
    if l_pad // tl <= 127 and batch * hp * wp * l_pad * es <= 2 * 1024 ** 3:
        for r in sorted(rows, key=lambda r: abs(r * wp - 1024)):
            tps = r * wp
            vmem = max(
                l_pad * max(9 * cr, 128) * es + 2 * tps * 9 * cr * es
                + 2 * tps * tl * 4 + 2 * tps * 128 * 4,
                2 * (tps + 2 * hr) * (tl + 2 * hc) * es
                + 2 * tps * tl * 4 + 2 * tl * sc2 * es + 2 * tps * sc2 * 4)
            if vmem < budget:
                return "stencil"
    for tlw in (tl, 512, 256):
        if not 256 <= tlw <= tl:
            continue
        for r in sorted(rows, key=lambda r: abs(r * wp - 1024)):
            tpw = r * wp
            vmem = (tpw * dv * 4
                    + 2 * tlw * dv * es
                    + 3 * (tlw + 2 * wq) * sc2 * es * 2
                    + 3 * (tpw + 2 * wp) * max(cr, 128) * es * 2
                    + l_pad * max(9 * cr, 128) * es
                    + 2 * tpw * tlw * 4)
            if vmem < budget:
                return "windowed"
    return "streaming"


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
        cr = channels // reduction
        self.scales = tuple(scales)
        self.softmax_scale = softmax_scale
        self.average = average
        self.conv_match_1 = _block(channels, cr)
        self.conv_match_2 = _block(channels, cr)
        self.conv_assembly = _block(channels, channels)
        for s in self.scales:
            setattr(self, "down" if s == 2 else f"downx{s}",
                    nn.Conv2d(channels, channels, 3, stride=s, padding=1))

    def forward(self, x: torch.Tensor, use_kernel: bool = False,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """x: (B, H, W, C) → (B, H, W, C·len(scales)). ``use_kernel``
        routes an average=True middle through the kernel ``csa_route``
        picks (its plain version on CPU tensors); otherwise the plain
        version runs wherever x lies."""
        _, h, w, _ = x.shape
        outs = []
        for s in self.scales:
            match, keys, embed = self.stencil_inputs(x, s, dtype)
            y = self._middle(match, keys, embed, s, use_kernel, dtype)
            down = getattr(self, "down" if s == 2 else f"downx{s}")
            y = conv(y.permute(0, 3, 1, 2), down, dtype) / 6.0
            outs.append(y[:, :, :h, :w])
        return _nhwc(torch.cat(outs, dim=1))

    def _middle(self, match: torch.Tensor, keys: torch.Tensor,
                embed: torch.Tensor, s: int, use_kernel: bool,
                dtype: torch.dtype) -> torch.Tensor:
        """The pasted (B, s·Hp, s·Wp, C) f32 map, before the down conv."""
        scale = self.softmax_scale
        if not self.average:
            return self._argmax_middle(match, keys, embed, s, dtype)
        if not use_kernel:
            return csa_stencil_fused_plain(match, keys, embed, scale, s)
        b, hp, wp, c = embed.shape
        cr = match.shape[-1]
        # the route picks by the real widths and the model's element size,
        # as the JAX package does; the kernels take their inputs in the
        # route's dtype at a compiled (Cr, C), and the padded output
        # channels are cropped
        mode = csa_route(hp, wp, s, c, cr,
                         2 if dtype == torch.bfloat16 else 4, b)
        kdt = kernels.route_dtype(embed.device, dtype)
        match, keys, embed = pad_maps(*(t.to(kdt)
                                        for t in (match, keys, embed)))
        cp = embed.shape[-1]
        if mode == "stencil_fused":
            y = csa_stencil_fused(match, keys, embed, scale, s)
        elif mode == "stencil":
            y = csa_stencil(match, keys, embed, scale, s)
        elif mode in ("resident", "windowed"):
            y = csa_fused(match, keys, embed, scale, s)
        else:
            q = extract_patches_same(match, 3, 1)
            v = extract_patches_same(embed, 3 * s, s)
            y = overlap_add(csa_attention(q, keys, v, scale), hp, wp, s, cp)
        return y if cp == c else y[..., :c]

    def _argmax_middle(self, match, keys, embed, s, dtype) -> torch.Tensor:
        """average=False (ciaosr_tpu/models/csa.py:378-408): the one-hot
        of each softmax row's maximum, every tied maximum kept; cast to the
        compute dtype; the bank product summed in f32; the overlap-add."""
        _, hp, wp, c = embed.shape
        q = extract_patches_same(match, 3, 1).float()
        kt = keys.float().transpose(1, 2)
        v = extract_patches_same(embed, 3 * s, s).to(dtype).float()
        parts = []
        for i, j in row_blocks(q.shape[1], kt.shape[-1]):
            attn = torch.softmax(q[:, i:j] @ kt * self.softmax_scale, -1)
            hard = attn == attn.amax(-1, keepdim=True)
            parts.append(hard.to(dtype).float() @ v)
        return overlap_add(torch.cat(parts, 1), hp, wp, s, c)

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
