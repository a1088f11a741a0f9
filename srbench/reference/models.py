"""Plain PyTorch reference of the CiaoSR generator, in float32.

The published CiaoSR dataflow (arXiv:2212.04362): an RDN or SwinIR trunk,
cross-scale attention (CSA) on the trunk features, and the per-query
implicit decoder with the four-shift local ensemble; the bilinear residual
of the LR input is added to every query. Every query is decoded on its
own, from nearest-neighbour gathers of the 3×3 unfolded maps, exactly as
the published implementation does; nothing is hoisted or packed.

State-dict names are the published checkpoints': the trunk's modules sit
at the top level of the generator (``sfe1``, ``rdbs.*``, ``gff.*`` for
RDN; ``conv_first``, ``layers.*``, ``norm``, ``conv_after_body`` for
SwinIR), then ``imnet_q/k/v`` and ``cs_attn``.

``low_precision_`` turns a model into the benchmark's control: the inputs
and weights of every matrix product it names are rounded to float8 (e4m3,
one scale a tensor), the step below bfloat16.

This module imports nothing but torch.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude maps to 448), back in t's dtype; the gradient of
    the rounding is taken as 1."""
    amax = t.detach().abs().amax().float().clamp(min=1e-12)
    scale = FP8_MAX / amax
    q = (t.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    # the rounding passes gradients straight through, as a float8
    # training step would
    return t + (q.to(t.dtype) - t).detach()


def make_coord(h: int, w: int, device=None) -> torch.Tensor:
    """Pixel centres of an h × w grid in [-1, 1], (h, w, 2) in (y, x)."""
    ys = -1.0 + (2.0 * torch.arange(h, dtype=torch.float32,
                                    device=device) + 1.0) / h
    xs = -1.0 + (2.0 * torch.arange(w, dtype=torch.float32,
                                    device=device) + 1.0) / w
    return torch.stack(torch.meshgrid(ys, xs, indexing="ij"), -1)


class MLP(nn.Module):
    """Linear → ReLU per hidden width → Linear (``layers.{2i}``)."""

    def __init__(self, in_dim: int, out_dim: int, hidden):
        super().__init__()
        mods, d = [], in_dim
        for h in hidden:
            mods += [nn.Linear(d, h), nn.ReLU()]
            d = h
        mods.append(nn.Linear(d, out_dim))
        self.layers = nn.Sequential(*mods)

    def forward(self, x):
        shape = x.shape[:-1]
        return self.layers(x.reshape(-1, x.shape[-1])).reshape(*shape, -1)


# ------------------------------------------------------------------- CSA
class CSA(nn.Module):
    """Cross-scale attention: softmax over every (s·3)² patch of the
    embedded map, matched by L2-normalized 3×3 patches of the s-times
    downsampled map; conv_transpose paste, strided down conv, /6."""

    def __init__(self, channel: int = 64, reduction: int = 2, scales=(2,),
                 softmax_scale: float = 10.0):
        super().__init__()
        self.scales = list(scales)
        self.softmax_scale = softmax_scale
        self.lowp = False

        def block(cin, cout):
            return nn.Sequential(nn.Conv2d(cin, cout, 1), nn.PReLU())

        self.conv_match_1 = block(channel, channel // reduction)
        self.conv_match_2 = block(channel, channel // reduction)
        self.conv_assembly = block(channel, channel)
        for s in self.scales:
            setattr(self, "down" if s == 2 else f"downx{s}",
                    nn.Conv2d(channel, channel, 3, s, 1))

    @staticmethod
    def _same_pad(x, k, stride):
        h, w = x.shape[-2:]
        oh, ow = -(-h // stride), -(-w // stride)
        ph = max(0, (oh - 1) * stride + k - h)
        pw = max(0, (ow - 1) * stride + k - w)
        return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))

    def _q(self, t):
        return fp8_round(t) if self.lowp else t

    def forward(self, x):
        b, c, h, w = x.shape
        outs = []
        for s in self.scales:
            ph, pw = (s - h % s) % s, (s - w % s) % s
            xp = F.pad(x, (0, pw, 0, ph), "reflect") if (ph or pw) else x
            embed = self.conv_assembly(xp)
            match = self.conv_match_1(xp)
            ref = self.conv_match_2(F.interpolate(
                xp, size=(xp.shape[2] // s, xp.shape[3] // s),
                mode="bilinear", align_corners=False))
            k_rec = 3 * s
            raw = F.unfold(self._same_pad(embed, k_rec, s), k_rec, stride=s)
            raw = raw.view(b, c, k_rec, k_rec, -1).permute(0, 4, 1, 2, 3)
            cr = ref.shape[1]
            keys = F.unfold(self._same_pad(ref, 3, 1), 3)
            keys = keys.view(b, cr, 3, 3, -1).permute(0, 4, 1, 2, 3)
            down = getattr(self, "down" if s == 2 else f"downx{s}")
            ys = []
            for i in range(b):
                ki = keys[i]
                norm = torch.sqrt((ki * ki).sum(dim=(1, 2, 3), keepdim=True))
                ki = ki / torch.clamp(norm, min=1e-4)
                corr = F.conv2d(self._q(self._same_pad(match[i:i + 1], 3, 1)),
                                self._q(ki))
                attn = F.softmax(corr * self.softmax_scale, dim=1)
                rec = F.conv_transpose2d(self._q(attn), self._q(raw[i]),
                                         stride=s, padding=s)
                ys.append(down(rec) / 6.0)
            outs.append(torch.cat(ys, 0)[:, :, :h, :w])
        return torch.cat(outs, 1)


# ----------------------------------------------------------------- trunks
class DenseLayer(nn.Module):
    def __init__(self, cin, g):
        super().__init__()
        self.conv = nn.Conv2d(cin, g, 3, padding=1)

    def forward(self, z):
        return torch.cat([z, F.relu(self.conv(z))], 1)


class RDB(nn.Module):
    def __init__(self, mid, g, n):
        super().__init__()
        self.layers = nn.Sequential(*[DenseLayer(mid + i * g, g)
                                      for i in range(n)])
        self.lff = nn.Conv2d(mid + n * g, mid, 1)

    def forward(self, z):
        return z + self.lff(self.layers(z))


class RDN(nn.Module):
    """Residual dense network trunk (no upsampler); NCHW."""

    def __init__(self, in_channels=3, mid_channels=64, num_blocks=16,
                 num_layers=8, channel_growth=64, **_unused):
        super().__init__()
        self.mid_channels = mid_channels
        self.sfe1 = nn.Conv2d(in_channels, mid_channels, 3, padding=1)
        self.sfe2 = nn.Conv2d(mid_channels, mid_channels, 3, padding=1)
        self.rdbs = nn.ModuleList(RDB(mid_channels, channel_growth,
                                      num_layers) for _ in range(num_blocks))
        self.gff = nn.Sequential(
            nn.Conv2d(mid_channels * num_blocks, mid_channels, 1),
            nn.Conv2d(mid_channels, mid_channels, 3, padding=1))

    def forward(self, x):
        s1 = self.sfe1(x)
        z = self.sfe2(s1)
        feats = []
        for blk in self.rdbs:
            z = blk(z)
            feats.append(z)
        return self.gff(torch.cat(feats, 1)) + s1


def win_part(x, ws):
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def win_rev(x, ws, h, w):
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


class Attn(nn.Module):
    def __init__(self, dim, ws, heads):
        super().__init__()
        self.ws, self.heads = ws, heads
        self.scale = (dim // heads) ** -0.5
        self.lowp = False
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, heads))
        coords = torch.stack(torch.meshgrid(
            torch.arange(ws), torch.arange(ws), indexing="ij")).flatten(1)
        rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
        rel[:, :, 0] += ws - 1
        rel[:, :, 1] += ws - 1
        rel[:, :, 0] *= 2 * ws - 1
        self.register_buffer("relative_position_index", rel.sum(-1),
                             persistent=False)

    def forward(self, x, mask):
        q8 = fp8_round if self.lowp else (lambda t: t)
        bw, n, c = x.shape
        qkv = self.qkv(x).reshape(bw, n, 3, self.heads, c // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        attn = q8(q * self.scale) @ q8(k).transpose(-2, -1)
        bias = self.relative_position_bias_table[
            self.relative_position_index.view(-1)].view(n, n, -1)
        attn = attn + bias.permute(2, 0, 1).unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(bw // nw, nw, self.heads, n, n) \
                + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(bw, self.heads, n, n)
        attn = attn.softmax(dim=-1)
        x = (q8(attn) @ q8(v)).transpose(1, 2).reshape(bw, n, c)
        return self.proj(x)


class SwinBlock(nn.Module):
    def __init__(self, dim, heads, ws, shift, mlp_ratio=2.0):
        super().__init__()
        self.ws, self.shift = ws, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = Attn(dim, ws, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = nn.ModuleDict({
            "fc1": nn.Linear(dim, int(dim * mlp_ratio)),
            "fc2": nn.Linear(int(dim * mlp_ratio), dim)})

    def _mask(self, h, w, ws, shift, device):
        img = torch.zeros(1, h, w, 1, device=device)
        cnt = 0
        for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            for wsl in (slice(0, -ws), slice(-ws, -shift),
                        slice(-shift, None)):
                img[:, hs, wsl, :] = cnt
                cnt += 1
        win = win_part(img, ws).view(-1, ws * ws)
        diff = win.unsqueeze(1) - win.unsqueeze(2)
        return diff.masked_fill(diff != 0, -100.0).masked_fill(diff == 0,
                                                               0.0)

    def forward(self, x, x_size):
        h, w = x_size
        b, n, c = x.shape
        ws = min(self.ws, h, w)
        shift = self.shift if (ws == self.ws and min(h, w) > self.ws) else 0
        shortcut = x
        x = self.norm1(x).view(b, h, w, c)
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        mask = self._mask(h, w, ws, shift, x.device) if shift else None
        x = win_rev(self.attn(win_part(x, ws), mask), ws, h, w)
        if shift:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x.reshape(b, n, c)
        y = self.mlp["fc2"](F.gelu(self.mlp["fc1"](self.norm2(x))))
        return x + y


class RSTB(nn.Module):
    def __init__(self, dim, depth, heads, ws, mlp_ratio=2.0):
        super().__init__()
        self.residual_group = nn.ModuleDict({"blocks": nn.ModuleList(
            SwinBlock(dim, heads, ws, 0 if i % 2 == 0 else ws // 2,
                      mlp_ratio) for i in range(depth))})
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x, x_size):
        h, w = x_size
        res = x
        for blk in self.residual_group["blocks"]:
            x = blk(x, x_size)
        img = self.conv(x.transpose(1, 2).reshape(-1, x.shape[-1], h, w))
        return img.flatten(2).transpose(1, 2) + res


class SwinIR(nn.Module):
    """SwinIR trunk: reflect pad to the window, conv_first, LayerNorm,
    residual Swin groups, LayerNorm, conv_after_body + skip, crop; NCHW."""

    def __init__(self, in_chans=3, embed_dim=180, depths=(6,) * 6,
                 num_heads=(6,) * 6, window_size=8, mlp_ratio=2.0,
                 **_unused):
        super().__init__()
        self.mid_channels = embed_dim
        self.ws = window_size
        self.conv_first = nn.Conv2d(in_chans, embed_dim, 3, padding=1)
        self.patch_embed = nn.ModuleDict({"norm": nn.LayerNorm(embed_dim)})
        self.layers = nn.ModuleList(RSTB(embed_dim, d, h, window_size,
                                         mlp_ratio)
                                    for d, h in zip(depths, num_heads))
        self.norm = nn.LayerNorm(embed_dim)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, padding=1)

    def forward(self, img):
        _, _, h0, w0 = img.shape
        ph = (self.ws - h0 % self.ws) % self.ws
        pw = (self.ws - w0 % self.ws) % self.ws
        if ph or pw:
            img = F.pad(img, (0, pw, 0, ph), "reflect")
        x = self.conv_first(img)
        b, c, h, w = x.shape
        feat = self.patch_embed["norm"](x.flatten(2).transpose(1, 2))
        for layer in self.layers:
            feat = layer(feat, (h, w))
        feat = self.norm(feat).transpose(1, 2).reshape(b, c, h, w)
        return (self.conv_after_body(feat) + x)[:, :, :h0, :w0]


TRUNKS = {"RDN": RDN, "SwinIR": SwinIR}


# ----------------------------------------------------------- the decoder
class CiaoSR(nn.Module):
    """The generator: trunk → per-query decode with the local ensemble.
    ``chunk`` bounds the queries decoded at once (memory only)."""

    def __init__(self, cfg: dict, chunk: int = 65536):
        super().__init__()
        enc = dict(cfg["encoder"])
        kind = enc.pop("type")
        if kind == "SwinIR" and cfg.get("window_size") is not None:
            enc.setdefault("window_size", cfg["window_size"])
        trunk = TRUNKS[kind](**enc)
        self.__dict__["trunk"] = trunk
        for name, mod in trunk.named_children():
            self.add_module(name, mod)
        c = trunk.mid_channels
        self.feat_unfold = cfg.get("feat_unfold", True)
        self.non_local_attn = cfg.get("non_local_attn", True)
        self.local_size = cfg.get("local_size", 2)
        self.softmax_scale = cfg.get("softmax_scale", 1.0)
        scales = cfg.get("multi_scale", (2,))
        base = c * 9 if self.feat_unfold else c
        nla = c * len(scales) if self.non_local_attn else 0

        def hidden(key):
            return (cfg.get(key) or {}).get("hidden_list", (256,) * 4)

        self.imnet_q = MLP(base + nla, 3, hidden("imnet_q"))
        self.imnet_k = MLP(base + 4, base, hidden("imnet_k"))
        self.imnet_v = MLP(base + nla + 4, base + nla, hidden("imnet_v"))
        if self.non_local_attn:
            self.cs_attn = CSA(channel=c, scales=scales)
        self.chunk = chunk
        self.lowp = False

    @staticmethod
    def _nsample(feat, coord):
        return F.grid_sample(feat, coord.flip(-1).unsqueeze(1),
                             mode="nearest", align_corners=False)[
            :, :, 0, :].permute(0, 2, 1)

    def maps(self, x):
        """The trunk features of normalized x (B, 3, H, W) and the decoder's
        query, key and value maps."""
        feature = self.trunk(x)
        b, c, h, w = feature.shape
        if self.feat_unfold:
            unf = F.unfold(feature, 3, padding=1).view(b, c * 9, h, w)
        else:
            unf = feature
        val = torch.cat([unf, self.cs_attn(feature)], 1) \
            if self.non_local_attn else unf
        return unf, val

    def query_rgb(self, unf, val, coord, cell):
        """Decode queries coord / cell (B, Q, 2) against the maps."""
        b, _, h, w = unf.shape
        q8 = fp8_round if self.lowp else (lambda t: t)
        query = self._nsample(unf, coord)
        feat_coord = make_coord(h, w, unf.device).permute(2, 0, 1)[None] \
            .expand(b, 2, h, w)
        step = 4 - self.local_size
        shifts = [(0, 0)] if self.local_size == 1 else [
            (i, j) for i in range(-1, 2, step) for j in range(-1, 2, step)]
        preds_k, preds_v = [], []
        for vx, vy in shifts:
            tx = (h - 1) / (1 - cell[:, 0, 0])
            ty = (w - 1) / (1 - cell[:, 0, 1])
            cs = coord.clone()
            if vx != 0:
                cs[:, :, 0] += (vx / abs(vx)) * ((2 * abs(vx) - 1) / tx)[
                    :, None] + 1e-6
            if vy != 0:
                cs[:, :, 1] += (vy / abs(vy)) * ((2 * abs(vy) - 1) / ty)[
                    :, None] + 1e-6
            cs.clamp_(-1 + 1e-6, 1 - 1e-6)
            key = self._nsample(unf, cs)
            value = self._nsample(val, cs)
            coord_k = self._nsample(feat_coord, cs)
            rel = coord - coord_k
            rel = torch.stack([rel[..., 0] * h, rel[..., 1] * w], -1)
            cell_hw = torch.stack([cell[..., 0] * h, cell[..., 1] * w], -1)
            wk = self.imnet_k(torch.cat([key, rel, cell_hw], -1))
            wv = self.imnet_v(torch.cat([value, rel, cell_hw], -1))
            preds_k.append(key * wk)
            preds_v.append(value * wv)
        pk = torch.stack(preds_k, -1)
        pv = torch.stack(preds_v, -2)
        attn = q8(query.unsqueeze(2)) @ q8(pk)
        out = (F.softmax(attn / self.softmax_scale, -1) @ pv)[:, :, 0, :]
        return self.imnet_q(out)

    @staticmethod
    def residual(x, coord):
        return F.grid_sample(x, coord.flip(-1).unsqueeze(1), mode="bilinear",
                             padding_mode="border", align_corners=False)[
            :, :, 0, :].permute(0, 2, 1)

    def forward(self, x, coord, cell):
        """Training forward: x (B, 3, H, W) normalized, coord / cell
        (B, Q, 2) → (B, Q, 3)."""
        unf, val = self.maps(x)
        return self.query_rgb(unf, val, coord, cell) + self.residual(x, coord)

    @torch.no_grad()
    def upscale(self, x, s: int):
        """Every pixel of the s-times grid of x (B, 3, H, W), decoded in
        chunks of queries: (B, s·H, s·W, 3)."""
        b, _, h, w = x.shape
        th, tw = s * h, s * w
        coord = make_coord(th, tw, x.device).reshape(1, -1, 2).expand(
            b, -1, -1)
        cell = torch.tensor([2.0 / th, 2.0 / tw], device=x.device).expand(
            b, th * tw, 2)
        unf, val = self.maps(x)
        outs = []
        for i in range(0, th * tw, self.chunk):
            cq, ce = coord[:, i:i + self.chunk], cell[:, i:i + self.chunk]
            outs.append(self.query_rgb(unf, val, cq, ce)
                        + self.residual(x, cq))
        return torch.cat(outs, 1).reshape(b, th, tw, 3)


class _Float8(nn.Module):
    def forward(self, w):
        return fp8_round(w)


def low_precision_(model: nn.Module, where=None) -> nn.Module:
    """Make ``model`` the float8 control, in place: the weights (kept in
    float32, rounded at each use) and the inputs of every Conv2d and
    Linear under the modules ``where`` names (all of the model when None)
    rounded to float8, and the functional products of those modules too.
    Parameter names stay the state dict's (``unrounded_names``)."""
    from torch.nn.utils import parametrize

    roots = [model] if where is None else [model.get_submodule(n)
                                           for n in where]

    def pre(_mod, args):
        return (fp8_round(args[0]),) + tuple(args[1:])

    for root in roots:
        for m in root.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                parametrize.register_parametrization(m, "weight", _Float8())
                m.register_forward_pre_hook(pre)
            if hasattr(m, "lowp"):
                m.lowp = True
    return model


def unrounded_names(model: nn.Module) -> list[tuple[str, nn.Parameter]]:
    """named_parameters() under the state dict's names, also for a model
    that ``low_precision_`` changed."""
    tag = ".parametrizations.weight.original"
    return [(n.replace(tag, ".weight"), p)
            for n, p in model.named_parameters()]


def fan_in_bound(p: torch.Tensor) -> float:
    """PyTorch's default Linear / Conv2d init bound, 1/√fan_in."""
    return 1.0 / math.sqrt(p[0].numel())
