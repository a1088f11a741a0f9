"""The order of rounding of the Hopper decode kernel (K3,
csrc/grid_decode_sm90.cu, both its integer and its rational mode), on the
CPU: its arithmetic repeated in PyTorch (bf16 operands, f32 sums) with the
value blended 128 columns at a time straight into imnet_q's first layer,
held against ``grid_decode_plain`` (``grid_decode_rational_plain``) in f32
on the same packed weights.

With 4 shifts (one group) the chunked blend rounds exactly the values the
whole blend rounds (bf16 rounding is elementwise), so only the order of
the f32 sums of the first imnet_q product differs. With 9 shifts each
group of 4 is blended and rounded on its own, which departs from a single
rounding of the whole sum by the bf16 class (≤ 1e-2 like every other
case). Both value layouts: DV = 9C + DC with CSA columns (the flagship,
C = DC = 64) and without (C = 192, DC = 0, the padded SwinIR width); in
the rational mode also (192, 192) and one tap (DV = C + DC = 128).

Also the build's sources: every library a wrapper loads is built, and
every CUDA source is a library.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ciaosr_torch.models.ciaosr import rational_cell
from ciaosr_torch.models.mlp import ImplicitMLP
from ciaosr_torch.ops.kernels import _build
from ciaosr_torch.ops.kernels import decoder as dk
from ciaosr_torch.ops.neighborhood import shift_edge

REL_TOL = 1e-2
CHUNK, GROUP = 128, 4
bf = torch.bfloat16


def _mlps(c: int, dc: int, seed: int, taps: int = 9):
    """imnet_k, imnet_v, imnet_q of a decoder of width (C, DC), seeded
    with numpy (uniform ±1/√fan_in, as nn.Linear's default)."""
    rng = np.random.default_rng(seed)
    base = taps * c
    nets = (ImplicitMLP(base + 4, base, [256] * 4),
            ImplicitMLP(base + dc + 4, base + dc, [256] * 4),
            ImplicitMLP(base + dc, 3, [256] * 4))
    with torch.no_grad():
        for net in nets:
            for lin in net.linears:
                lim = 1.0 / np.sqrt(lin.in_features)
                for p in (lin.weight, lin.bias):
                    p.copy_(torch.from_numpy(rng.uniform(
                        -lim, lim, tuple(p.shape)).astype(np.float32)))
    return nets


def _inputs(c: int, dc: int, scale: int, seed: int, hw=(5, 6), taps=9,
            cell=None):
    """Packed bf16 weights and the decode's LR maps from K1 and K2's plain
    versions, for a 2-image batch; ``cell`` (default 2/scale a side)."""
    rng = np.random.default_rng(seed)
    k, v, q = _mlps(c, dc, seed, taps)
    pk = dk.pack_decoder(k, v, q, c, cell or (2.0 / scale, 2.0 / scale), bf)
    feat = torch.from_numpy(rng.standard_normal((2, *hw, c)).astype(
        np.float32) * 0.5).to(bf)
    csa = torch.from_numpy(rng.standard_normal((2, *hw, dc)).astype(
        np.float32) * 0.5).to(bf) if dc else None
    gk, gv = dk.f3p_build_plain(feat, csa, pk["wk0"], pk["wvu"], pk["wvc"])
    wt, ck = dk.wt_hoist_plain(feat, pk["wkout"], pk["bkout"])
    return feat, csa, gk, gv, wt, ck, pk


def _mm(a, w):
    """bf16 operands, f32 sum (a wgmma)."""
    return a.to(bf).float() @ w.to(bf).float()


def _phases(wt, ck, tabs):
    """Per phase, per shift: a function that reads an LR map at the key
    pixels, the rel terms, and the wt / ck rows of the plane
    d = key − query at the query pixel; from the integer tables (dys, ...)
    or the rational ones (yq, ...)."""
    if "dys" in tabs:
        rely, relx = tabs["rely"], tabs["relx"]
        for p, (dys, dxs) in enumerate(zip(tabs["dys"].tolist(),
                                           tabs["dxs"].tolist())):
            yield [(lambda t, dy=dy, dx=dx: shift_edge(t, dy, dx),
                    rely[p, i][None, :, None, None],
                    relx[p, i][None, None, :, None],
                    wt[dk.SHIFTS9.index((dy, dx))],
                    ck[dk.SHIFTS9.index((dy, dx))])
                   for i, (dy, dx) in enumerate(zip(dys, dxs))]
        return
    for yq, xq, shifts in dk.rational_phases(tabs):
        rows = []
        for ky, kx, ry, rx in shifts:
            plane = (ky - yq + 1)[:, None] * 3 + (kx - xq + 1)[None]
            rows.append((lambda t, ky=ky, kx=kx: dk.take2(t, ky, kx),
                         ry[None, :, None, None], rx[None, None, :, None],
                         wt[plane, :, yq[:, None], xq[None]].permute(
                             2, 0, 1, 3),
                         ck[plane, :, yq[:, None], xq[None]].permute(
                             2, 0, 1)))
        yield rows


def kernel_math(feature, csa, gk, gv, wt, ck, pk, tabs, softmax_scale,
                whole: bool = False):
    """K3 (or its rational mode, from rational tables) as the Hopper
    kernel rounds it: the blend rounded to bf16 per group of 4 shifts and
    chunk of columns (``whole``: once over every shift and column, as the
    TPU kernel rounds it). Returns the (B, P, H, W, 3) output (rational:
    (B, P, H/qy, W/qx, 3)), the number of rounded blends a phase, and
    imnet_q's first product (f32 sum) per phase."""
    u = dk.unfold_taps(feature, dk.taps_of(pk["wk0"].shape[0],
                                           feature.shape[-1], "kernel_math"))
    dv = pk["vout"].shape[1]
    f = {key: val.float() for key, val in pk.items()}
    out, pre_q = [], []
    for rows in _phases(wt, ck, tabs):
        logits, preds = [], []
        for take, ry, rx, wt_d, ck_d in rows:

            def first(g, rel, b0):
                return torch.relu(take(g).float() + ry * rel[0]
                                  + rx * rel[1] + b0).to(bf)

            def hidden(h, w, b, last_f32):
                for layer in range(3):
                    h = torch.relu(_mm(h, w[layer]) + b[layer])
                    if layer < 2 or not last_f32:
                        h = h.to(bf)
                return h

            hk = hidden(first(gk, f["krel"], f["kb0"]), pk["kw"], f["kb"],
                        True)
            logits.append((wt_d.float() * hk).sum(-1) + ck_d)
            hv = hidden(first(gv, f["vrel"], f["vb0"]), pk["vw"], f["vb"],
                        False)
            x = take(u)
            if csa is not None:
                x = torch.cat([x, take(csa)], -1)
            preds.append((x.float() * (_mm(hv, pk["vout"]) + f["vbout"]))
                         .to(bf).float())
        attn = torch.softmax(torch.stack(logits, -1) / softmax_scale, -1)
        groups = ([range(len(preds))] if whole else
                  [range(g0, min(g0 + GROUP, len(preds)))
                   for g0 in range(0, len(preds), GROUP)])
        qacc, n_blends = 0.0, 0
        for grp in groups:
            for n0 in (range(0, dv, dv) if whole else range(0, dv, CHUNK)):
                cols = slice(n0, dv if whole else min(n0 + CHUNK, dv))
                outv = 0.0
                for i in grp:   # shift by shift, in order
                    outv = outv + attn[..., i:i + 1] * preds[i][..., cols]
                qacc = qacc + _mm(outv, pk["qw0"][cols])
                n_blends += 1
        pre_q.append(qacc)
        hq = torch.relu(qacc + f["qb0"]).to(bf)
        for layer in range(3):
            hq = torch.relu(_mm(hq, pk["qw"][layer]) + f["qb"][layer]).to(bf)
        out.append(hq.float() @ f["qwout"].t() + f["qbout"])
    return torch.stack(out, 1), n_blends, torch.stack(pre_q)


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def _f32(x):
    if isinstance(x, dict):
        return {k: _f32(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_f32(v) for v in x)
    return x.float() if x is not None and x.is_floating_point() else x


@pytest.mark.parametrize("c,dc,scale", [(64, 64, 2), (64, 64, 3),
                                        (192, 0, 2)],
                         ids=["C64_csa_x2", "C64_csa_x3", "C192_x2"])
@torch.no_grad()
def test_chunked_blend_rounds_as_whole(c, dc, scale):
    """4 shifts: rounding chunk by chunk changes only the order of the f32
    sums of imnet_q's first product against one rounding of the whole
    blend; the output holds against the f32 plain version."""
    maps = _inputs(c, dc, scale, seed=c + scale)
    tabs = dk.decoder_tables(scale, *maps[0].shape[1:3], 2, "cpu")
    got, n_blends, pre_q = kernel_math(*maps, tabs, 1.0)
    _, _, pre_q_whole = kernel_math(*maps, tabs, 1.0, whole=True)
    assert n_blends == -(-(9 * c + dc) // CHUNK)
    assert _rel(pre_q, pre_q_whole) <= 1e-5
    ref = dk.grid_decode_plain(*_f32(maps[:6]), _f32(maps[6]), tabs, 1.0)
    assert got.shape == ref.shape == (2, scale * scale, 5, 6, 3)
    assert _rel(got, ref) <= REL_TOL


@pytest.mark.parametrize("softmax_scale", [1.0, 0.05],
                         ids=["scale1", "one_shift_dominates"])
@torch.no_grad()
def test_nine_shifts_round_per_group(softmax_scale):
    """9 shifts (local_size 3, the flagship width): groups of 4, 4 and 1,
    each blend rounded on its own, against the f32 plain version and
    against one rounding of the whole 9-shift blend (the TPU kernel's)."""
    maps = _inputs(64, 64, 2, seed=9)
    tabs = dk.decoder_tables(2, *maps[0].shape[1:3], 3, "cpu")
    got, n_blends, _ = kernel_math(*maps, tabs, softmax_scale)
    assert n_blends == 3 * 5   # 3 groups x 5 chunks
    once, _, _ = kernel_math(*maps, tabs, softmax_scale, whole=True)
    assert _rel(got, once) <= REL_TOL
    ref = dk.grid_decode_plain(*_f32(maps[:6]), _f32(maps[6]), tabs,
                               softmax_scale)
    assert _rel(got, ref) <= REL_TOL


# ×2.5 (a tie phase) at the flagship width with 4 and 9 shifts, ×7/3 at
# config 001 swinir's padded width (192, 192), ×2.5 at one tap (DV = 128,
# one chunk); phase images of 3 × 4 and 2 × 3
@pytest.mark.parametrize("c,dc,taps,p,q,hw,local_size", [
    (64, 64, 9, 5, 2, (6, 8), 2), (64, 64, 9, 5, 2, (6, 8), 3),
    (192, 192, 9, 7, 3, (6, 9), 2), (64, 64, 1, 5, 2, (6, 8), 2)],
    ids=["C64_x2.5", "C64_x2.5_9shifts", "C192_csa_x7/3", "C64_u1_x2.5"])
@torch.no_grad()
def test_rational_blend_rounds_per_group(c, dc, taps, p, q, hw, local_size):
    """The rational mode rounds as the integer mode does: 128-column
    chunks, each group of 4 shifts on its own; against
    ``grid_decode_rational_plain`` in f32, and (one group) against one
    rounding of the whole blend up to the order of the f32 sums."""
    h, w = hw
    maps = _inputs(c, dc, 0, seed=c + p + taps, hw=hw, taps=taps,
                   cell=rational_cell(h, w, h * p // q, w * p // q))
    tabs = dk.rational_tables(h, w, p, q, p, q, local_size, "cpu")
    n_shift = tabs["yk"].shape[1]
    got, n_blends, pre_q = kernel_math(*maps, tabs, 1.0)
    dv = taps * c + dc
    assert n_blends == -(-n_shift // GROUP) * -(-dv // CHUNK)
    once, _, pre_q_whole = kernel_math(*maps, tabs, 1.0, whole=True)
    if n_shift <= GROUP:
        assert _rel(pre_q, pre_q_whole) <= 1e-5
    assert _rel(got, once) <= REL_TOL
    ref = dk.grid_decode_rational_plain(*_f32(maps[:6]), _f32(maps[6]), tabs,
                                        1.0)
    assert got.shape == ref.shape == (2, p * p, h // q, w // q, 3)
    assert _rel(got, ref) <= REL_TOL


def test_build_sources_match_kernels():
    """Every ``_build.load(name)`` in the wrappers names a library of
    ``_build.KERNELS``; each library has its ``csrc/<name>.cu``, and every
    ``csrc/*.cu`` is a library (no source that nothing builds)."""
    loaded = set()
    for src in sorted(Path(_build.__file__).parent.glob("*.py")):
        text = src.read_text()
        loaded |= set(re.findall(r'_build\.load\("(\w+)"\)', text))
        # a launcher that takes the library as an argument: its default
        if "_build.load(lib)" in text:
            loaded |= set(re.findall(r'lib(?:: str)? *= *"(\w+)"', text))
    assert loaded and loaded <= set(_build.KERNELS)
    sources = {f.stem for f in _build.CSRC.glob("*.cu")}
    assert sources == set(_build.KERNELS)
