"""CiaoSR implicit attention-in-attention decoder (integer-scale grid).

Counterpart of ciaosr_tpu/models/ciaosr.py::CiaoSRNet for the dense-grid
eval path:
  * ``query_rgb_grid``: the plain dense-grid decode (JAX query_rgb_grid,
    the XLA path);
  * ``query_rgb_grid_kernels``: the kernel route (JAX
    query_rgb_grid_pallas) — CSA through K4, then K1 → K2 → K3, pixel
    shuffle and the f32 bilinear residual.
Per-query ``query_rgb`` and the rational-scale paths are not ported yet
(ROADMAP.md queue 1 items 4 and 7).

State-dict layout is the reference's: the encoder's modules sit at the
top level (``sfe1``, ``rdbs.*``, ``gff.*`` for RDN), then ``imnet_q/k/v``
and ``cs_attn``, with channel-major unfold blocks in the imnet first and
last layers. Public tensors are NHWC.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ciaosr_torch.models.csa import CrossScaleAttention
from ciaosr_torch.models.mlp import ImplicitMLP
from ciaosr_torch.ops.kernels import decoder as dk_ops
from ciaosr_torch.ops.neighborhood import (shift_edge, tap_major_perm,
                                           unfold_nhwc)
from ciaosr_torch.ops.sampling import interpolate_bilinear


def pixel_shuffle(phases: torch.Tensor, s: int) -> torch.Tensor:
    """(B, s², H, W, 3) phase images → (B, s·H, s·W, 3):
    out[s·m + a, s·n + b] = phase(a·s + b)[m, n]."""
    b, _, h, w, c = phases.shape
    return phases.reshape(b, s, s, h, w, c).permute(0, 3, 1, 4, 2, 5) \
        .reshape(b, s * h, s * w, c)


class CiaoSRNet(nn.Module):
    """Encoder + implicit decoder. ``dtype`` is the compute dtype (params
    stay f32); ``use_kernels`` selects the kernel route for eval."""

    def __init__(self, encoder: nn.Module, feat_dim: int = 64,
                 out_dim: int = 3, hidden_q: Sequence[int] = (256,) * 4,
                 hidden_k: Sequence[int] = (256,) * 4,
                 hidden_v: Sequence[int] = (256,) * 4, local_size: int = 2,
                 multi_scale: Sequence[int] = (2,),
                 softmax_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32,
                 use_kernels: bool = False):
        super().__init__()
        # the reference registers the encoder's trunk modules at the top
        # level of the generator, so its state_dict has no "encoder."
        # prefix; the encoder object is kept (unregistered) for its forward
        self.__dict__["encoder"] = encoder
        for name, mod in encoder.named_children():
            self.add_module(name, mod)
        base = feat_dim * 9
        nla = feat_dim * len(multi_scale)
        self.local_size = local_size
        self.softmax_scale = softmax_scale
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.imnet_q = ImplicitMLP(base + nla, out_dim, hidden_q)
        self.imnet_k = ImplicitMLP(base + 4, base, hidden_k)
        self.imnet_v = ImplicitMLP(base + nla + 4, base + nla, hidden_v)
        self.cs_attn = CrossScaleAttention(channels=feat_dim,
                                           scales=multi_scale)

    # ------------------------------------------------------------ features
    def gen_feature(self, x: torch.Tensor) -> torch.Tensor:
        """Encoder trunk features (B, H, W, C) in the compute dtype."""
        return self.encoder(x, self.dtype)

    def nl_feature(self, feature: torch.Tensor,
                   use_kernel: bool = False) -> torch.Tensor:
        """Cross-scale attention features (B, H, W, C·|scales|)."""
        return self.cs_attn(feature, use_kernel, self.dtype)

    # ---------------------------------------------------------- plain grid
    def query_rgb_grid(self, feature: torch.Tensor, x: torch.Tensor,
                       scale: int) -> torch.Tensor:
        """Plain dense-grid decode at integer ``scale``: (B, s·H, s·W, 3).

        Every decoder quantity of a uniform HR grid is periodic in the
        pixel phase, so the per-query gathers become s² dense passes over
        edge-clamped shifted maps (see the JAX docstring). The first layers'
        feature products are hoisted out of the phase loop."""
        s = int(scale)
        b, h, w, c = feature.shape
        dt = self.dtype
        dk = 9 * c
        perm = torch.as_tensor(tap_major_perm(c), device=feature.device)
        u_map = unfold_nhwc(feature).to(dt)
        csa = self.nl_feature(feature, use_kernel=False).to(dt)
        v_map = torch.cat([u_map, csa], -1)
        dv = v_map.shape[-1]
        # tap-major views of the channel-major unfold blocks
        vperm = torch.cat([perm, torch.arange(dk, dv, device=perm.device)])
        inv = torch.argsort(vperm)          # imnet_q reads channel-major
        lk0, lv0 = self.imnet_k.linears[0], self.imnet_v.linears[0]
        wk0, wv0 = lk0.weight.to(dt), lv0.weight.to(dt)
        g_k = u_map @ wk0[:, perm].t()
        g_v = v_map @ wv0[:, vperm].t()
        dys, dxs, rely, relx = dk_ops.phase_tables(
            s, h, w, dk_ops.shift_offsets(self.local_size))
        cell = 2.0 / s

        def rc_bias(wt0, b0, d, ry, rx):
            ry = torch.as_tensor(ry, device=wt0.device, dtype=dt)
            rx = torch.as_tensor(rx, device=wt0.device, dtype=dt)
            const = cell * (wt0[:, d + 2] + wt0[:, d + 3]) + b0.to(dt)
            return (ry[:, None, None] * wt0[:, d] + rx[None, :, None]
                    * wt0[:, d + 1] + const)

        phases = []
        for p in range(s * s):
            logits, preds = [], []
            for i in range(dys.shape[1]):
                dy, dx = int(dys[p, i]), int(dxs[p, i])
                hk = torch.relu(shift_edge(g_k, dy, dx)
                                + rc_bias(wk0, lk0.bias, dk, rely[p, i],
                                          relx[p, i]))
                hv = torch.relu(shift_edge(g_v, dy, dx)
                                + rc_bias(wv0, lv0.bias, dv, rely[p, i],
                                          relx[p, i]))
                wk = self.imnet_k.tail(hk, dt)[..., perm]
                wv = self.imnet_v.tail(hv, dt)[..., vperm]
                key = shift_edge(u_map, dy, dx)
                logits.append((u_map.float() * (key * wk).float()).sum(-1))
                preds.append(shift_edge(v_map, dy, dx) * wv)
            attn = torch.softmax(torch.stack(logits, -1)
                                 / self.softmax_scale, -1)
            outv = sum(attn[..., i:i + 1] * preds[i].float()
                       for i in range(len(preds)))
            phases.append(self.imnet_q(outv.to(dt)[..., inv], dt).float())
        img = pixel_shuffle(torch.stack(phases, 1), s)
        return img + interpolate_bilinear(x.float(), s * h, s * w)

    # --------------------------------------------------------- kernel grid
    def query_rgb_grid_kernels(self, feature: torch.Tensor, x: torch.Tensor,
                               scale: int) -> torch.Tensor:
        """Dense-grid decode through K4 and K1 → K2 → K3 (their plain
        versions on CPU tensors): (B, s·H, s·W, 3)."""
        s = int(scale)
        b, h, w, c = feature.shape
        dt = self.dtype
        feature = feature.to(dt).contiguous()
        csa = self.nl_feature(feature, use_kernel=True).to(dt).contiguous()
        pk = dk_ops.pack_decoder(self.imnet_k, self.imnet_v, self.imnet_q,
                                 c, s, dt)
        tabs = dk_ops.decoder_tables(s, h, w, self.local_size,
                                     feature.device)
        gk, gv = dk_ops.f3p_build(feature, csa, pk["wk0"], pk["wvu"],
                                  pk["wvc"])
        wt, ck = dk_ops.wt_hoist(feature, pk["wkout"], pk["bkout"])
        phases = dk_ops.grid_decode(feature, csa, gk, gv, wt, ck, pk, tabs,
                                    self.softmax_scale)
        img = pixel_shuffle(phases.float(), s)
        return img + interpolate_bilinear(x.float(), s * h, s * w)

    def decode_grid(self, x: torch.Tensor, scale: int) -> torch.Tensor:
        """Encoder + dense-grid decode of normalized LR x (B, H, W, 3),
        by the route ``use_kernels`` selects."""
        feature = self.gen_feature(x)
        if self.use_kernels:
            return self.query_rgb_grid_kernels(feature, x, scale)
        return self.query_rgb_grid(feature, x, scale)
