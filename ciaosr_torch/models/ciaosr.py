"""CiaoSR implicit attention-in-attention decoder.

Counterpart of ciaosr_tpu/models/ciaosr.py::CiaoSRNet:
  * ``forward``: the training forward, features then ``query_rgb``;
  * ``query_rgb``: the per-query decoder (the reference's own eval
    semantics), used for targets with too many phases for a dense decode;
  * ``query_rgb_grid``: the plain dense-grid decode at integer scale (JAX
    query_rgb_grid, the XLA path);
  * ``query_rgb_grid_kernels``: its kernel route (JAX
    query_rgb_grid_pallas) — CSA through the kernel its geometry routes
    to (models/csa.py), then K1 → K2 → K3, pixel shuffle and the f32
    bilinear residual;
  * ``query_rgb_grid_rational``: the plain dense decode at a rational
    scale py/qy × px/qx (JAX query_rgb_grid_rational);
  * ``query_rgb_grid_rational_kernels``: its kernel route (JAX
    query_rgb_grid_rational_pallas) — CSA as above, K1, K2, then K3 in
    its rational mode.

With ``non_local_attn=False`` (the 002 SwinIR-CiaoSR configs) there is no
CSA: the value features are the unfold alone and no CSA kernel runs.
With ``feat_unfold=False`` (LIIF's "-u" ablation) the keys, values and
queries are the feature pixel itself, not its 3×3 unfold: every map and
MLP block is C wide instead of 9C, and the decode kernels run their
one-tap instances.

State-dict layout is the reference's: the encoder's modules sit at the
top level (``sfe1``, ``rdbs.*``, ``gff.*`` for RDN; ``conv_first``,
``layers.*``, ... for SwinIR), then ``imnet_q/k/v`` and ``cs_attn``, with
channel-major unfold blocks in the imnet first and last layers. Public
tensors are NHWC.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from ciaosr_torch.core import trace
from ciaosr_torch.models.csa import CrossScaleAttention
from ciaosr_torch.models.mlp import ImplicitMLP
from ciaosr_torch.models.swinir import SwinIR
from ciaosr_torch.ops import kernels
from ciaosr_torch.ops.kernels import decoder as dk_ops
from ciaosr_torch.ops.kernels.decoder import (grid_axis_tables,
                                              shift_offsets, take2)
from ciaosr_torch.ops.neighborhood import (gather_patches, shift_edge,
                                           tap_major_perm)
from ciaosr_torch.ops.sampling import (grid_sample_bilinear_border,
                                       interpolate_bilinear, nearest_index)

__all__ = ["CiaoSRNet", "grid_axis_tables", "pixel_shuffle"]


def pixel_shuffle(phases: torch.Tensor, sy: int,
                  sx: int | None = None) -> torch.Tensor:
    """(B, sy·sx, H, W, 3) phase images → (B, sy·H, sx·W, 3):
    out[sy·m + a, sx·n + b] = phase(a·sx + b)[m, n]."""
    sx = sy if sx is None else sx
    b, _, h, w, c = phases.shape
    return phases.reshape(b, sy, sx, h, w, c).permute(0, 3, 1, 4, 2, 5) \
        .reshape(b, sy * h, sx * w, c)


def rational_cell(h: int, w: int, th: int, tw: int) -> tuple[float, float]:
    """cell·(H, W) of a th × tw target as the per-query path computes it
    (float32 2/target, times the LR size)."""
    return (float(np.float32(2.0) / np.float32(th)) * h,
            float(np.float32(2.0) / np.float32(tw)) * w)


class CiaoSRNet(nn.Module):
    """Encoder + implicit decoder. ``dtype`` is the compute dtype (params
    stay f32); ``use_kernels`` selects the kernel route for eval."""

    def __init__(self, encoder: nn.Module, feat_dim: int = 64,
                 out_dim: int = 3, hidden_q: Sequence[int] = (256,) * 4,
                 hidden_k: Sequence[int] = (256,) * 4,
                 hidden_v: Sequence[int] = (256,) * 4, local_size: int = 2,
                 feat_unfold: bool = True, non_local_attn: bool = True,
                 multi_scale: Sequence[int] = (2,),
                 softmax_scale: float = 1.0,
                 eval_bsize: int | None = 30000,
                 dtype: torch.dtype = torch.float32,
                 use_kernels: bool = False):
        super().__init__()
        # the reference registers the encoder's trunk modules at the top
        # level of the generator, so its state_dict has no "encoder."
        # prefix; the encoder object is kept (unregistered) for its forward
        self.__dict__["encoder"] = encoder
        for name, mod in encoder.named_children():
            self.add_module(name, mod)
        self.feat_unfold = feat_unfold
        base = feat_dim * self.taps
        nla = feat_dim * len(multi_scale) if non_local_attn else 0
        self.local_size = local_size
        self.non_local_attn = non_local_attn
        self.softmax_scale = softmax_scale
        self.eval_bsize = eval_bsize   # query chunk of the per-query path
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.imnet_q = ImplicitMLP(base + nla, out_dim, hidden_q)
        self.imnet_k = ImplicitMLP(base + 4, base, hidden_k)
        self.imnet_v = ImplicitMLP(base + nla + 4, base + nla, hidden_v)
        if non_local_attn:
            self.cs_attn = CrossScaleAttention(channels=feat_dim,
                                               scales=multi_scale)

    @property
    def taps(self) -> int:
        """The taps of the unfold a key carries: 9 (the 3×3
        neighbourhood) or, without the unfold, 1 (the pixel alone)."""
        return 9 if self.feat_unfold else 1

    # ------------------------------------------------------------ features
    def gen_feature(self, x: torch.Tensor) -> torch.Tensor:
        """Encoder trunk features (B, H, W, C) in the compute dtype; the
        SwinIR encoder's blocks take their kernel with ``use_kernels`` (the
        RDN has no kernel of its own: its convs go to cuDNN)."""
        with trace.span("generator.encoder", device=True):
            if isinstance(self.encoder, SwinIR):
                return self.encoder(x, self.dtype, self.use_kernels)
            return self.encoder(x, self.dtype)

    def forward(self, x: torch.Tensor, coord: torch.Tensor,
                cell: torch.Tensor) -> torch.Tensor:
        """The training forward (JAX ``__call__``): features of the
        normalized LR x (B, H, W, 3), then the per-query decoder at coord /
        cell (B, Q, 2): (B, Q, 3) f32. The Swin blocks take rows 11 and 12
        with ``use_kernels``; CSA runs its plain version, as JAX's
        ``query_rgb`` calls it (no CSA kernel has a backward)."""
        feature = self.gen_feature(x)
        return self.query_rgb(feature, x, coord, cell,
                              self.nl_feature(feature, use_kernel=False))

    def nl_feature(self, feature: torch.Tensor,
                   use_kernel: bool = False) -> torch.Tensor | None:
        """Cross-scale attention features (B, H, W, C·|scales|); None
        without non-local attention."""
        if not self.non_local_attn:
            return None
        with trace.span("generator.csa", device=True):
            return self.cs_attn(feature, use_kernel, self.dtype)

    # ----------------------------------------------------------- per query
    def query_rgb(self, feature: torch.Tensor, x: torch.Tensor,
                  coord: torch.Tensor, cell: torch.Tensor,
                  nl_feat: torch.Tensor | None = None) -> torch.Tensor:
        """Decode queries coord / cell (B, Q, 2) against the features:
        (B, Q, 3), the global bilinear residual included. ``nl_feat``
        supplies the CSA features computed once per image.

        The shift radius uses the first query's cell for the whole chunk,
        as the reference does (``ciaosr_net.py:162-163``)."""
        b, h, w, c = feature.shape
        dt = self.dtype
        if nl_feat is None:
            nl_feat = self.nl_feature(feature, use_kernel=self.use_kernels)
        ksize = 3 if self.feat_unfold else 1
        iy0 = nearest_index(coord[..., 0], h).clamp(0, h - 1)
        ix0 = nearest_index(coord[..., 1], w).clamp(0, w - 1)
        query = gather_patches(feature, iy0, ix0, ksize)

        rx = (1.0 - cell[:, 0, 0]) / (h - 1)
        ry = (1.0 - cell[:, 0, 1]) / (w - 1)
        shifted = []
        for vx, vy in shift_offsets(self.local_size):
            cy, cx = coord[..., 0], coord[..., 1]
            if vx:   # vx, vy ∈ {-1, 0, 1}
                cy = cy + vx * rx[:, None] + 1e-6
            if vy:
                cx = cx + vy * ry[:, None] + 1e-6
            shifted.append(torch.stack([cy, cx], -1))
        coord_s = torch.clamp(torch.stack(shifted, 1), -1 + 1e-6, 1 - 1e-6)
        n_s = coord_s.shape[1]

        iy = nearest_index(coord_s[..., 0], h).clamp(0, h - 1)
        ix = nearest_index(coord_s[..., 1], w).clamp(0, w - 1)
        key = gather_patches(feature, iy, ix, ksize)
        value = key
        if nl_feat is not None:
            idx = (iy * w + ix).reshape(b, -1).long()
            nl = torch.gather(
                nl_feat.reshape(b, h * w, -1), 1,
                idx[..., None].expand(-1, -1, nl_feat.shape[-1])).reshape(
                    *iy.shape, -1)
            value = torch.cat([key, nl.to(key.dtype)], -1)

        coord_k = torch.stack([-1.0 + (2.0 * iy.float() + 1.0) / h,
                               -1.0 + (2.0 * ix.float() + 1.0) / w], -1)
        hw = torch.tensor([h, w], dtype=torch.float32, device=coord.device)
        rel = ((coord[:, None] - coord_k) * hw).to(dt)
        cell_hw = (cell * hw)[:, None].expand(-1, n_s, -1, -1).to(dt)
        key, value, query = key.to(dt), value.to(dt), query.to(dt)
        pred_k = key * self.imnet_k(torch.cat([key, rel, cell_hw], -1), dt)
        pred_v = value * self.imnet_v(torch.cat([value, rel, cell_hw], -1),
                                      dt)
        attn = torch.einsum("bqc,bsqc->bqs", query.float(), pred_k.float())
        attn = torch.softmax(attn / self.softmax_scale, -1)
        out = torch.einsum("bqs,bsqc->bqc", attn, pred_v.float())
        rgb = self.imnet_q(out.to(dt), dt).float()
        return rgb + grid_sample_bilinear_border(x.float(), coord)

    # ---------------------------------------------------------- plain grid
    def _plain_maps(self, feature: torch.Tensor):
        """The plain dense decodes' per-image maps in the compute dtype:
        u (3×3 unfold, tap-major; the feature itself without the unfold),
        v = [u | CSA] (u alone without CSA), the hoisted first-layer
        products g_k = u@W_k0 and g_v = v@W_v0, and the permutations
        between the tap-major maps and the MLPs' channel-major blocks (perm
        for k, vperm for v; inv takes imnet_q's input back)."""
        dt = self.dtype
        dk = self.taps * feature.shape[-1]
        perm = torch.as_tensor(tap_major_perm(feature.shape[-1], self.taps),
                               device=feature.device)
        u_map = dk_ops.unfold_taps(feature, self.taps).to(dt)
        csa = self.nl_feature(feature, use_kernel=False)
        v_map = u_map if csa is None else torch.cat([u_map, csa.to(dt)], -1)
        vperm = torch.cat([perm, torch.arange(dk, v_map.shape[-1],
                                              device=perm.device)])
        g_k = u_map @ self.imnet_k.linears[0].weight.to(dt)[:, perm].t()
        g_v = v_map @ self.imnet_v.linears[0].weight.to(dt)[:, vperm].t()
        return u_map, v_map, g_k, g_v, perm, vperm, torch.argsort(vperm)

    def _blend(self, logits, preds, inv) -> torch.Tensor:
        """Softmax over the shifts, the value blend (f32), imnet_q."""
        dt = self.dtype
        attn = torch.softmax(torch.stack(logits, -1) / self.softmax_scale,
                             -1)
        outv = sum(attn[..., i:i + 1] * preds[i].float()
                   for i in range(len(preds)))
        return self.imnet_q(outv.to(dt)[..., inv], dt).float()

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
        u_map, v_map, g_k, g_v, perm, vperm, inv = self._plain_maps(feature)
        dk, dv = u_map.shape[-1], v_map.shape[-1]
        lk0, lv0 = self.imnet_k.linears[0], self.imnet_v.linears[0]
        wk0, wv0 = lk0.weight.to(dt), lv0.weight.to(dt)
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
            phases.append(self._blend(logits, preds, inv))
        img = pixel_shuffle(torch.stack(phases, 1), s)
        return img + interpolate_bilinear(x.float(), s * h, s * w)

    # --------------------------------------------------------- kernel grid
    def _kernel_maps(self, feature: torch.Tensor, cell):
        """The kernel routes' per-image inputs in the route's dtype
        (``kernels.route_dtype``: bf16 on the card, also for an f32 model):
        the feature and the CSA map (CSA through its routed kernel; None
        without CSA) zero-padded to the decode kernels' widths, the packed
        weights for ``cell`` (zero rows at the padded channels), g_k and
        g_v through K1, wt and ck through K2."""
        dt = kernels.route_dtype(feature.device, self.dtype)
        c = feature.shape[-1]
        feature = feature.to(self.dtype)   # CSA computes in the model dtype
        csa = self.nl_feature(feature.contiguous(), use_kernel=True)
        dc = 0 if csa is None else csa.shape[-1]
        cp, dcp = dk_ops.padded_widths(c, dc, self.taps)
        if csa is not None:
            csa = csa.to(dt)
            if dcp != dc:
                csa = torch.nn.functional.pad(csa, (0, dcp - dc))
            csa = csa.contiguous()
        feature = torch.nn.functional.pad(feature.to(dt),
                                          (0, cp - c)).contiguous()
        with trace.span("decoder.pack"):
            pk = dk_ops.pack_decoder(self.imnet_k, self.imnet_v,
                                     self.imnet_q, c, cell, dt, c_pad=cp,
                                     dc_pad=dcp)
        trace.count("decoder.packs")
        with trace.span("decoder.k1"):
            gk, gv = dk_ops.f3p_build(feature, csa, pk["wk0"], pk["wvu"],
                                      pk["wvc"])
        with trace.span("decoder.k2"):
            wt, ck = dk_ops.wt_hoist(feature, pk["wkout"], pk["bkout"])
        return feature, csa, gk, gv, wt, ck, pk

    def query_rgb_grid_kernels(self, feature: torch.Tensor, x: torch.Tensor,
                               scale: int) -> torch.Tensor:
        """Dense-grid decode through the CSA kernel and K1 → K2 → K3 (their
        plain versions on CPU tensors): (B, s·H, s·W, 3)."""
        s = int(scale)
        b, h, w, c = feature.shape
        with trace.span("decoder.tables"):
            tabs = dk_ops.decoder_tables(s, h, w, self.local_size,
                                         feature.device)
        trace.count("decoder.table_builds")
        maps = self._kernel_maps(feature, (2.0 / s, 2.0 / s))
        with trace.span("decoder.k3"):
            phases = dk_ops.grid_decode(*maps, tabs, self.softmax_scale)
        del maps    # K1's and K2's maps go before the shuffle allocates
        with trace.span("decoder.shuffle"):
            img = pixel_shuffle(phases.float(), s)
            return img + interpolate_bilinear(x.float(), s * h, s * w)

    # ------------------------------------------------------- rational grid
    def query_rgb_grid_rational(self, feature: torch.Tensor, x: torch.Tensor,
                                py: int, qy: int, px: int,
                                qx: int) -> torch.Tensor:
        """Plain dense decode at rational scale py/qy × px/qx (lowest
        terms, qy | H, qx | W): (B, H·py/qy, W·px/qx, 3).

        On a uniform HR grid every decoder quantity is periodic in the
        pixel phase (i mod py, j mod px); phase (a, b) reads LR rows and
        columns from ``rational_tables`` (the kernel route's own tables,
        built by ``grid_axis_tables``), which repeat the per-query
        path's float32 rounding (tie rows included). So the per-query
        gathers become py·px dense (H/qy) × (W/qx) passes with the
        first-layer feature products hoisted, assembled by pixel shuffle
        (JAX _decode_rational_phases)."""
        b, h, w, c = feature.shape
        th, tw = h * py // qy, w * px // qx
        dt = self.dtype
        tabs = dk_ops.rational_tables(h, w, py, qy, px, qx, self.local_size,
                                      feature.device)
        u_map, v_map, g_k, g_v, perm, vperm, inv = self._plain_maps(feature)
        dk, dv = u_map.shape[-1], v_map.shape[-1]
        lk0, lv0 = self.imnet_k.linears[0], self.imnet_v.linears[0]
        cell_y, cell_x = rational_cell(h, w, th, tw)

        def rc_bias(lin, d, ry, rx):   # in f32, then the compute dtype
            w0 = lin.weight
            const = cell_y * w0[:, d + 2] + cell_x * w0[:, d + 3] + lin.bias
            return (ry[:, None, None] * w0[:, d] + rx[None, :, None]
                    * w0[:, d + 1] + const).to(dt)

        phases = []
        for iqy, iqx, shifts in dk_ops.rational_phases(tabs):
            query = take2(u_map, iqy, iqx)
            logits, preds = [], []
            for my, mx, ry, rx in shifts:
                hk = torch.relu(take2(g_k, my, mx) + rc_bias(lk0, dk, ry, rx))
                hv = torch.relu(take2(g_v, my, mx) + rc_bias(lv0, dv, ry, rx))
                wk = self.imnet_k.tail(hk, dt)[..., perm]
                wv = self.imnet_v.tail(hv, dt)[..., vperm]
                key = take2(u_map, my, mx)
                logits.append((query.float() * (key * wk).float()).sum(-1))
                preds.append(take2(v_map, my, mx) * wv)
            phases.append(self._blend(logits, preds, inv))
        img = pixel_shuffle(torch.stack(phases, 1), py, px)
        return img + interpolate_bilinear(x.float(), th, tw)

    def query_rgb_grid_rational_kernels(self, feature: torch.Tensor,
                                        x: torch.Tensor, py: int, qy: int,
                                        px: int, qx: int) -> torch.Tensor:
        """Rational dense decode through the CSA kernel, K1, K2 and K3's
        rational mode (their plain versions on CPU tensors):
        (B, H·py/qy, W·px/qx, 3)."""
        b, h, w, c = feature.shape
        th, tw = h * py // qy, w * px // qx
        with trace.span("decoder.tables"):
            tabs = dk_ops.rational_tables(h, w, py, qy, px, qx,
                                          self.local_size, feature.device)
        trace.count("decoder.table_builds")
        maps = self._kernel_maps(feature, rational_cell(h, w, th, tw))
        with trace.span("decoder.k3"):
            phases = dk_ops.grid_decode_rational(*maps, tabs,
                                                 self.softmax_scale)
        del maps
        with trace.span("decoder.shuffle"):
            img = pixel_shuffle(phases.float(), py, px)
            return img + interpolate_bilinear(x.float(), th, tw)

    def decode_grid(self, x: torch.Tensor, sy, sx=None) -> torch.Tensor:
        """Encoder + dense-grid decode of normalized LR x (B, H, W, 3) at
        scale sy × sx (int or Fraction; sx defaults to sy), by the route
        ``use_kernels`` selects: the integer decode when sy = sx is an
        integer, the rational decode otherwise."""
        sy = Fraction(sy)
        sx = sy if sx is None else Fraction(sx)
        feature = self.gen_feature(x)
        if sy == sx and sy.denominator == 1:
            fn = self.query_rgb_grid_kernels if self.use_kernels \
                else self.query_rgb_grid
            return fn(feature, x, int(sy))
        fn = self.query_rgb_grid_rational_kernels if self.use_kernels \
            else self.query_rgb_grid_rational
        return fn(feature, x, sy.numerator, sy.denominator, sx.numerator,
                  sx.denominator)
