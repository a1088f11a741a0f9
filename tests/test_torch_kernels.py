"""The port's CUDA kernels (bf16) against their plain PyTorch versions
(f32, the same input values): max|Δ|/max|ref| ≤ 1e-2, the bf16 class the
JAX kernels hold. Config 001 swinir's instances (K4 and row 7 at (Cr, C)
= (96, 192), K1 and K3 at (C, DC) = (192, 192): its 90 and 180 channels
zero-padded) are held against the plain versions at the real widths,
beside a flagship case of each. K1 is held at patch-ragged shapes at
both widths; the decode kernel at integer scales and, in its rational
mode (an index mode of the same Hopper kernel), at ×2.5, ×7/3, ×1.5,
5/3 × 7/2, an odd width and on 3 images at 3/2 × 5/3 (output pixels off
the 32-pixel blocks and off the LR pixel count by a factor of 6), with
the same bits from call to call at (64, 64) and (192, 192); the CSA
kernels (K4, rows 5-8) at
ragged, non-square geometries, K4 and rows 5 and 6 (one kernel pair) also
on key grids smaller than or off its tiles and at spread logits, the same
bits from call to call and from every entry point, row 7 also on seeded
banks at the edges of its tiles and of its online softmax, row 8 (row 7's
kernel and the paste) the same bits twice, and the paste alone at ≤ 1e-6
of its plain version (and its refusal of a tensor off the current
device); the Swin block
(row 11), its backward (row 12: dx - dy ≤ 1e-2, each packed gradient
≤ 2e-2; its weight-gradient kernel alone ≤ 1e-3 against its plain
version, padded partials exactly 0), K1-K3 at SwinIR-CiaoSR's 180 channels without CSA, and the
one-tap instances of K1, K2, K3 (row 9) and row 10 (feat_unfold=False,
(C, DC) = (64, 64)) on an EDSR generator, every other one-tap width
raising. Needs a
CUDA card (marked ``cuda``; skips without one); on the card run
``python -m pytest --noconftest -q tests/test_torch_kernels.py`` (this file
imports no JAX). Shapes are flagship widths (C = 64, hidden 256) at small,
odd spatial sizes so the block tails and partial tiles are exercised
(C = 180, 6 heads, hidden 360 for SwinIR).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

REL_TOL = 1e-2
CFG = dict(
    type="LocalImplicitSRRDN",
    encoder=dict(type="RDN", in_channels=3, mid_channels=64, num_blocks=2,
                 num_layers=2, channel_growth=64),
    imnet_q=dict(type="MLPRefiner", out_dim=3, hidden_list=[256] * 4),
    imnet_k=dict(type="MLPRefiner", out_dim=64, hidden_list=[256] * 4),
    imnet_v=dict(type="MLPRefiner", out_dim=64, hidden_list=[256] * 4),
    dtype="bf16", use_kernels=True)


def _rel(got, ref):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    num = max(float((g.float() - r.float()).abs().max())
              for g, r in zip(got, ref))
    return num / max(float(r.float().abs().max()) for r in ref)


def _f32(x):
    if isinstance(x, dict):
        return {k: _f32(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_f32(v) for v in x)
    return x.float() if x is not None and x.is_floating_point() else x


@pytest.fixture(scope="module", autouse=True)
def needs_cuda():
    """Skip without a card, decided at set-up (not at import, so every
    test worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernels need a CUDA card")


@pytest.fixture(scope="module")
def case():
    from ciaosr_torch.models.builder import build_generator
    from ciaosr_torch.ops.kernels import decoder as dk
    net = build_generator(CFG, device="cuda", seed=1)
    lq = np.random.default_rng(0).random((2, 21, 37, 3), dtype=np.float32)
    with torch.inference_mode():
        feat = net.gen_feature(torch.as_tensor(lq, device="cuda") - 0.45)
        csa = net.nl_feature(feat, use_kernel=False).to(torch.bfloat16)
    return net, feat.contiguous(), csa.contiguous(), dk


def _bf16(rng, *shape, scale=1.0):
    """A seeded normal tensor on the card, in bf16."""
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                           * scale, device="cuda").to(torch.bfloat16)


# K1 on the network's own maps (21 × 37), then on seeded maps whose H and
# W are not multiples of the kernel's 8 × 16 pixel patch (nor B·H·W of its
# 128 rows), at both compiled (C, DC) pairs
@pytest.mark.parametrize("b,h,w,c,dc", [(2, 21, 37, 64, 64),
                                        (2, 13, 29, 64, 64),
                                        (1, 60, 47, 64, 64),
                                        (2, 13, 29, 192, 0),
                                        (1, 60, 47, 192, 0),
                                        (2, 13, 29, 192, 192),
                                        (1, 60, 47, 192, 192)],
                         ids=["net_21x37", "13x29", "60x47", "13x29_C192",
                              "60x47_C192", "13x29_C192_DC192",
                              "60x47_C192_DC192"])
@torch.inference_mode()
def test_f3p_build(case, b, h, w, c, dc):
    from ciaosr_torch.ops import kernels
    net, feat, csa, dk = case
    if feat.shape[1:3] == (h, w) and c == 64:
        pk = dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, 64,
                             (0.5, 0.5), torch.bfloat16)
        args = (feat, csa, pk["wk0"], pk["wvu"], pk["wvc"])
    else:
        rng = np.random.default_rng(h * w + c)
        args = (_bf16(rng, b, h, w, c), _bf16(rng, b, h, w, dc) if dc
                else None, _bf16(rng, 9 * c, 256, scale=0.05),
                _bf16(rng, 9 * c, 256, scale=0.05),
                _bf16(rng, dc, 256, scale=0.05))
    n0 = kernels.LAUNCHES["f3p_build"]
    got = dk.f3p_build(*args)
    assert kernels.LAUNCHES["f3p_build"] == n0 + 1
    assert got[0].shape == got[1].shape == (b, h, w, 256)
    assert _rel(got, dk.f3p_build_plain(*_f32(args))) <= REL_TOL


def _wt_inputs(rng, b, h, w, c, taps, real):
    """Seeded K2 inputs at width c (bf16 feature and W_kout, f32 b_kout
    of bf16 values), zero at the channels from ``real`` on, as the path's
    padding leaves them; and the same values at the ``real`` width (f32)."""
    feat = _bf16(rng, b, h, w, c)
    feat[..., real:] = 0
    wk = _bf16(rng, taps, c, 256, scale=0.05)
    wk[:, real:] = 0
    bk = _bf16(rng, taps, c).float()
    bk[:, real:] = 0
    return ((feat, wk.reshape(taps * c, 256), bk.reshape(-1)),
            (feat[..., :real].float(),
             wk[:, :real].reshape(taps * real, 256).float(),
             bk[:, :real].reshape(-1)))


# K2 at its three instances: (C, taps) = (64, 9), the flagship; (192, 9),
# SwinIR-CiaoSR's 180 channels zero-padded, held against the plain
# version at the 180 real channels; (64, 1), without the unfold. Shapes
# off the kernel's 16 x 8 patch grid (at (64, 9) and 21 x 37 the
# network's own maps), B = 2 and maps one pixel high or wide (both edge
# clamps of an axis at every pixel); wt and ck each ≤ 1e-2, the same bits
# from a second launch, one launch a call
@pytest.mark.parametrize("hw", [(2, 21, 37), (2, 13, 29), (1, 60, 47),
                                (1, 57, 57), (1, 72, 72), (2, 1, 40),
                                (1, 33, 1)],
                         ids=["21x37_B2", "13x29_B2", "60x47", "57x57",
                              "72x72", "1x40_B2", "33x1"])
@pytest.mark.parametrize("c,real,taps", [(64, 64, 9), (192, 180, 9),
                                         (64, 64, 1)],
                         ids=["C64", "C180pad192", "C64_1tap"])
@torch.inference_mode()
def test_wt_hoist(case, c, real, taps, hw):
    from ciaosr_torch.ops import kernels
    net, feat, _, dk = case
    b, h, w = hw
    if (c, taps) == (64, 9) and hw == feat.shape[:3]:   # the net's maps
        pk = dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, 64,
                             (0.5, 0.5), torch.bfloat16)
        args = (feat, pk["wkout"], pk["bkout"])
        plain = _f32(args)
    else:
        args, plain = _wt_inputs(np.random.default_rng(h * w + c + taps),
                                 b, h, w, c, taps, real)
    n0 = kernels.LAUNCHES["wt_hoist"]
    wt, ck = dk.wt_hoist(*args)
    assert kernels.LAUNCHES["wt_hoist"] == n0 + 1
    bsz, hh, ww = args[0].shape[:3]
    assert wt.shape == (9, bsz, hh, ww, 256) and wt.dtype == torch.bfloat16
    assert ck.shape == (9, bsz, hh, ww) and ck.dtype == torch.float32
    ref_wt, ref_ck = dk.wt_hoist_plain(*plain)
    assert _rel(wt, ref_wt) <= REL_TOL
    assert _rel(ck, ref_ck) <= REL_TOL
    wt2, ck2 = dk.wt_hoist(*args)
    assert kernels.LAUNCHES["wt_hoist"] == n0 + 2
    assert torch.equal(wt, wt2) and torch.equal(ck, ck2)


# K3 at s = 2, 3, 4 with 1, 4 and 9 shifts (9: two groups of 4 and one
# of 1, each blend rounded on its own), B = 2 and B·H·W off the kernel's
# 32-pixel blocks; 60 × 47 is row 9's odd width; a softmax scale of 0.02
# spreads the logits so that one shift takes almost all the weight
@pytest.mark.parametrize("scale,local_size,hw,softmax_scale", [
    (3, 2, (21, 37), 1.0), (4, 2, (21, 37), 1.0), (2, 1, (21, 37), 1.0),
    (2, 3, (21, 37), 1.0), (4, 2, (60, 47), 1.0), (4, 3, (60, 47), 1.0),
    (4, 2, (21, 37), 0.02), (3, 3, (13, 29), 0.02)],
    ids=["x3", "x4", "x2_1shift", "x2_9shifts", "60x47", "60x47_9shifts",
         "x4_spread", "x3_9shifts_spread"])
@torch.inference_mode()
def test_grid_decode(case, scale, local_size, hw, softmax_scale):
    from ciaosr_torch.ops import kernels
    net, feat, csa, dk = case
    if feat.shape[1:3] != hw:
        _, feat, csa = _features(net, hw, hw[0] * hw[1])
    pk = dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, 64,
                         (2.0 / scale, 2.0 / scale), torch.bfloat16)
    tabs = dk.decoder_tables(scale, *hw, local_size, feat.device)
    gk, gv = dk.f3p_build(feat, csa, pk["wk0"], pk["wvu"], pk["wvc"])
    wt, ck = dk.wt_hoist(feat, pk["wkout"], pk["bkout"])
    n0 = kernels.LAUNCHES["grid_decode"]
    got = dk.grid_decode(feat, csa, gk, gv, wt, ck, pk, tabs, softmax_scale)
    assert kernels.LAUNCHES["grid_decode"] == n0 + 1
    ref = dk.grid_decode_plain(*_f32((feat, csa, gk, gv, wt, ck)), _f32(pk),
                               tabs, softmax_scale)
    assert got.shape == (2, scale * scale, *hw, 3)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, ref) <= REL_TOL


def _features(net, hw, seed):
    """Encoder features (bf16) and plain CSA of a random 2-image batch."""
    lq = np.random.default_rng(seed).random((2, *hw, 3), dtype=np.float32)
    x = torch.as_tensor(lq, device="cuda") - 0.45
    feat = net.gen_feature(x).contiguous()
    csa = net.nl_feature(feat, use_kernel=False).to(torch.bfloat16)
    return x, feat, csa.contiguous()


@pytest.mark.parametrize("py,qy,px,qx,hw,local_size", [
    (5, 2, 5, 2, (20, 38), 2),    # ×2.5: a tie phase
    (7, 3, 7, 3, (21, 39), 2),    # ×7/3
    (3, 2, 3, 2, (22, 34), 2),    # ×1.5: exact ties
    (5, 3, 7, 2, (21, 36), 2),    # 5/3 × 7/2
    (5, 3, 5, 3, (18, 33), 2),    # ×5/3 at an odd width (phase width 11)
    (5, 2, 5, 2, (20, 38), 3),    # 9 shifts: a partial shift group
], ids=["x2.5", "x7/3", "x1.5", "5/3x7/2", "odd_width", "x2.5_9shifts"])
@torch.inference_mode()
def test_grid_decode_rational(case, py, qy, px, qx, hw, local_size):
    from ciaosr_torch.models.ciaosr import rational_cell
    from ciaosr_torch.ops import kernels
    net, _, _, dk = case
    _, feat, csa = _features(net, hw, py * qx)
    h, w = hw
    pk = dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, 64,
                         rational_cell(h, w, h * py // qy, w * px // qx),
                         torch.bfloat16)
    tabs = dk.rational_tables(h, w, py, qy, px, qx, local_size,
                              feat.device)
    gk, gv = dk.f3p_build(feat, csa, pk["wk0"], pk["wvu"], pk["wvc"])
    wt, ck = dk.wt_hoist(feat, pk["wkout"], pk["bkout"])
    n0 = kernels.LAUNCHES["grid_decode_rational"]
    got = dk.grid_decode_rational(feat, csa, gk, gv, wt, ck, pk, tabs, 1.0)
    assert kernels.LAUNCHES["grid_decode_rational"] == n0 + 1
    ref = dk.grid_decode_rational_plain(*_f32((feat, csa, gk, gv, wt, ck)),
                                        _f32(pk), tabs, 1.0)
    assert got.shape == (2, py * px, h // qy, w // qx, 3)
    assert _rel(got, ref) <= REL_TOL


def _rational_maps(net, feat, csa, py, qy, px, qx, local_size):
    """Packed weights, K1 / K2 maps and tables of a rational decode."""
    from ciaosr_torch.models.ciaosr import rational_cell
    from ciaosr_torch.ops.kernels import decoder as dk
    h, w = feat.shape[1:3]
    pk = dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q,
                         feat.shape[-1],
                         rational_cell(h, w, h * py // qy, w * px // qx),
                         torch.bfloat16)
    gk, gv = dk.f3p_build(feat, csa, pk["wk0"], pk["wvu"], pk["wvc"])
    wt, ck = dk.wt_hoist(feat, pk["wkout"], pk["bkout"])
    tabs = dk.rational_tables(h, w, py, qy, px, qx, local_size, feat.device)
    return (feat, csa, gk, gv, wt, ck, pk), tabs


@torch.inference_mode()
def test_grid_decode_rational_pixel_counts(case):
    """The output pixels a CTA walks (B·OH·OW) are not the LR pixels that
    index the wt / ck rows (B·H·W): 3 images of 22 × 33 at 3/2 × 5/3 give
    phase images of 11 × 11 (B·OH·OW = 363, not a multiple of 32;
    H·W / OH·OW = 6, not a square), with 9 shifts."""
    from ciaosr_torch.ops.kernels import decoder as dk
    net = case[0]
    lq = np.random.default_rng(33).random((3, 22, 33, 3), dtype=np.float32)
    feat = net.gen_feature(torch.as_tensor(lq, device="cuda") - 0.45)
    feat = feat.contiguous()
    csa = net.nl_feature(feat, use_kernel=False).to(torch.bfloat16)
    maps, tabs = _rational_maps(net, feat, csa.contiguous(), 3, 2, 5, 3, 3)
    got = dk.grid_decode_rational(*maps[:6], maps[6], tabs, 1.0)
    ref = dk.grid_decode_rational_plain(*_f32(maps[:6]), _f32(maps[6]), tabs,
                                        1.0)
    assert got.shape == ref.shape == (3, 15, 11, 11, 3)
    assert bool(torch.isfinite(got).all())
    for b in range(3):   # every image, not only the batch's largest values
        assert _rel(got[b], ref[b]) <= REL_TOL


@pytest.mark.parametrize("width", ["C64", "C180_csa"])
@torch.inference_mode()
def test_grid_decode_rational_same_bits(case, swin_csa_case, width):
    """Two launches of the rational mode give the same bits, at (64, 64, 9)
    with 9 shifts and at (192, 192, 9) with 4."""
    from ciaosr_torch.models.ciaosr import rational_cell
    from ciaosr_torch.ops.kernels import decoder as dk
    if width == "C64":
        _, feat, csa = _features(case[0], (20, 38), 7)
        maps, tabs = _rational_maps(case[0], feat, csa, 5, 2, 5, 2, 3)
    else:
        net = swin_csa_case
        _, feat, _ = _net_maps(net, (16, 32), 9)
        maps = net._kernel_maps(feat, rational_cell(16, 32, 40, 80))
        tabs = dk.rational_tables(16, 32, 5, 2, 5, 2, net.local_size,
                                  feat.device)
    first = dk.grid_decode_rational(*maps[:6], maps[6], tabs, 1.0)
    assert torch.equal(first,
                       dk.grid_decode_rational(*maps[:6], maps[6], tabs, 1.0))


@torch.inference_mode()
def test_rational_route_matches_plain_route(case):
    """×2.5 through K4, K1, K2 and rational K3 (bf16) against the plain
    rational decode in f32 on the same features."""
    net = case[0]
    x, feat, _ = _features(net, (20, 38), 3)
    got = net.query_rgb_grid_rational_kernels(feat, x, 5, 2, 5, 2)
    net.dtype = torch.float32
    try:
        ref = net.query_rgb_grid_rational(feat.float(), x, 5, 2, 5, 2)
    finally:
        net.dtype = torch.bfloat16
    assert got.shape == (2, 50, 95, 3)
    assert _rel(got, ref) <= REL_TOL


def _csa_inputs(case, hw):
    """match, keys, embed (bf16) of the CSA at an H × W feature map; odd
    sizes are reflect-padded to even ones."""
    net, feat, _, _ = case
    x = torch.nn.functional.interpolate(
        feat.permute(0, 3, 1, 2).float(), size=hw).permute(0, 2, 3, 1)
    return net.cs_attn.stencil_inputs(x.to(torch.bfloat16).contiguous(), 2,
                                      torch.bfloat16)


# (21, 37) pads to 22×38: P = 836 and L = 209 are not multiples of a tile
CSA_HW = [(21, 37), (16, 32), (9, 70)]


@pytest.mark.parametrize("name", ["csa_stencil_fused", "csa_stencil"])
@pytest.mark.parametrize("hw", CSA_HW)
@torch.inference_mode()
def test_csa_stencil_forms(case, hw, name):
    """K4 and row 5: the same function, on the same kernels
    (csrc/csa_stencil_sm90.cu), so the same bits."""
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.kernels import csa_stencil as st
    match, keys, embed = _csa_inputs(case, hw)
    n0 = kernels.LAUNCHES[name]
    got = getattr(st, name)(match, keys, embed, 10.0, 2)
    assert kernels.LAUNCHES[name] == n0 + 1
    ref = getattr(st, name + "_plain")(match.float(), keys.float(),
                                       embed.float(), 10.0, 2)
    assert got.shape == ref.shape
    assert _rel(got, ref) <= REL_TOL
    assert torch.equal(got, st.csa_stencil_fused(match, keys, embed, 10.0,
                                                 2))


@pytest.mark.parametrize("hw", CSA_HW)
@torch.inference_mode()
def test_csa_fused(case, hw):
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.kernels import csa_attention as ca
    match, keys, embed = _csa_inputs(case, hw)
    n0 = kernels.LAUNCHES["csa_fused"]
    got = ca.csa_fused(match, keys, embed, 10.0, 2)
    assert kernels.LAUNCHES["csa_fused"] == n0 + 1
    ref = ca.csa_fused_plain(match.float(), keys.float(), embed.float(),
                             10.0, 2)
    assert got.shape == ref.shape == (2, *(2 * n for n in match.shape[1:3]),
                                      64)
    assert _rel(got, ref) <= REL_TOL


# K4 and rows 5 and 6 launch one stencil-form kernel pair
# (csrc/csa_stencil_sm90.cu), whose tiles are 8 × 8 queries and 8 × 8
# keys: a key grid smaller than one key tile (8×8 → 4×4 keys, L = 16;
# 6×10 → 3×5), query and key grids off the tiles (20×44 → 10×22 keys),
# and spread logits (scale 100) on the 22×38 geometry. Each call counts
# one launch under its own key; two calls give the same bits, and so do
# the three entry points.
@pytest.mark.parametrize("hw,scale", [((8, 8), 10.0), ((6, 10), 10.0),
                                      ((20, 44), 10.0), ((21, 37), 100.0)],
                         ids=["L16", "L15", "off_tiles", "scale100"])
@torch.inference_mode()
def test_csa_stencil_kernel_edges(case, hw, scale):
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.kernels import csa_attention as ca
    from ciaosr_torch.ops.kernels import csa_stencil as st
    match, keys, embed = _csa_inputs(case, hw)
    maps32 = (match.float(), keys.float(), embed.float())
    n4, n6 = (kernels.LAUNCHES[k] for k in ("csa_stencil_fused",
                                            "csa_fused"))
    got4 = st.csa_stencil_fused(match, keys, embed, scale, 2)
    assert kernels.LAUNCHES["csa_stencil_fused"] == n4 + 1
    assert kernels.LAUNCHES["csa_fused"] == n6
    got6 = ca.csa_fused(match, keys, embed, scale, 2)
    assert kernels.LAUNCHES["csa_fused"] == n6 + 1
    assert kernels.LAUNCHES["csa_stencil_fused"] == n4 + 1
    again = st.csa_stencil_fused(match, keys, embed, scale, 2)
    assert torch.equal(got4, again)
    assert torch.equal(got4, got6)
    n5 = kernels.LAUNCHES["csa_stencil"]
    assert torch.equal(got4, st.csa_stencil(match, keys, embed, scale, 2))
    assert kernels.LAUNCHES["csa_stencil"] == n5 + 1
    assert _rel(got4, st.csa_stencil_fused_plain(*maps32, scale, 2)) \
        <= REL_TOL
    assert _rel(got6, ca.csa_fused_plain(*maps32, scale, 2)) <= REL_TOL


@pytest.mark.parametrize("hw", CSA_HW)
@torch.inference_mode()
def test_csa_attention_banks(case, hw):
    """Rows 7 (tap-major bank, k_maps out) and 8 (plane-major bank, pasted
    out) on the banks of extract_patches_same; the geometries are not
    square, so a swapped plane order would show. Row 8 (row 7's kernel and
    the paste) counts one launch a call under its own key only, and gives
    the same bits twice."""
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.kernels import csa_attention as ca
    from ciaosr_torch.ops.neighborhood import (extract_patches_same,
                                               plane_major_perm)
    match, keys, embed = _csa_inputs(case, hw)
    hp, wp = match.shape[1:3]
    q = extract_patches_same(match, 3, 1).contiguous()
    v = extract_patches_same(embed, 6, 2).contiguous()
    perm = torch.as_tensor(plane_major_perm(2, 64), device=v.device)
    v_pm = v[..., perm].contiguous()
    got7 = ca.csa_attention(q, keys, v, 10.0)
    ref7 = ca.csa_attention_plain(q.float(), keys.float(), v.float(), 10.0)
    assert got7.shape == ref7.shape == (2, hp * wp, 2304)
    assert _rel(got7, ref7) <= REL_TOL
    n0 = dict(kernels.LAUNCHES)
    got8 = ca.csa_attention_overlap_add(q, keys, v_pm, 10.0, hp, wp, 2)
    assert {k: v - n0[k] for k, v in kernels.LAUNCHES.items()
            if v != n0[k]} == {"csa_attention_overlap_add": 1}
    assert torch.equal(got8, ca.csa_attention_overlap_add(
        q, keys, v_pm, 10.0, hp, wp, 2))
    assert kernels.LAUNCHES["csa_attention_overlap_add"] == n0[
        "csa_attention_overlap_add"] + 2
    ref8 = ca.csa_attention_overlap_add_plain(q.float(), keys.float(),
                                              v_pm.float(), 10.0, hp, wp, 2)
    assert got8.shape == ref8.shape == (2, 2 * hp, 2 * wp, 64)
    assert _rel(got8, ref8) <= REL_TOL
    # the same function as row 6 on the maps the banks came from
    assert _rel(got8, ca.csa_fused_plain(match.float(), keys.float(),
                                         embed.float(), 10.0, 2)) <= REL_TOL


# row 8's paste (csrc/csa_paste.cu) alone on seeded f32 kernels, B = 2:
# maps one pixel high or wide (only the middle tap row or column lands),
# small odd maps, the Set5 tile's 72² and 48 × 64. It adds in the plain
# version's order, so the two agree to f32 rounding or better.
@pytest.mark.parametrize("hp,wp", [(1, 1), (1, 7), (5, 1), (3, 5), (13, 29),
                                   (72, 72), (48, 64)])
@torch.inference_mode()
def test_plane_overlap_add(hp, wp):
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.kernels import csa_attention as ca
    k_pm = torch.as_tensor(np.random.default_rng(hp * wp).standard_normal(
        (2, hp * wp, 2304), dtype=np.float32), device="cuda")
    n0 = kernels.LAUNCHES["plane_overlap_add"]
    got = ca.plane_overlap_add(k_pm, hp, wp, 2)
    assert kernels.LAUNCHES["plane_overlap_add"] == n0 + 1
    ref = ca.plane_overlap_add_plain(k_pm, hp, wp, 2)
    assert got.shape == ref.shape == (2, 2 * hp, 2 * wp, 64)
    assert _rel(got, ref) <= 1e-6
    assert torch.equal(got, ca.plane_overlap_add(k_pm, hp, wp, 2))
    with pytest.raises(ValueError, match="float32"):
        ca.plane_overlap_add(k_pm.to(torch.bfloat16), hp, wp, 2)


@torch.inference_mode()
def test_launch_refuses_a_tensor_off_the_current_device(monkeypatch):
    """The port runs one process per GPU (the kernels set their
    shared-memory attributes once per process): a wrapper launches on its
    tensors' device only when that is the current device, and otherwise
    raises and launches nothing."""
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.kernels import csa_attention as ca
    k_pm = torch.zeros((1, 15, 2304), device="cuda")
    n0 = kernels.LAUNCHES["plane_overlap_add"]
    ca.plane_overlap_add(k_pm, 3, 5, 2)
    assert kernels.LAUNCHES["plane_overlap_add"] == n0 + 1
    other = k_pm.device.index + 1
    monkeypatch.setattr(torch.cuda, "current_device", lambda: other)
    with pytest.raises(RuntimeError, match="one process per GPU"):
        ca.plane_overlap_add(k_pm, 3, 5, 2)
    assert kernels.LAUNCHES["plane_overlap_add"] == n0 + 1


# row 7 on seeded banks: fewer than 64 queries and 48 keys (the kernel's
# tiles), P and L off the tiles, B = 2, scores that rise along L (the
# running max rises on tile after tile, so every accumulator is rescaled),
# a large scale, and tiles met exactly
@pytest.mark.parametrize("b,p,l_,scale,rising", [
    (1, 40, 30, 10.0, False), (2, 100, 200, 10.0, False),
    (2, 130, 1000, 10.0, True), (1, 77, 500, 300.0, False),
    (2, 64, 48, 1.0, False)],
    ids=["P40_L30", "B2_P100_L200", "rising_L1000", "scale300", "tiles"])
@torch.inference_mode()
def test_csa_attention_edges(case, b, p, l_, scale, rising):
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.kernels import csa_attention as ca
    rng = np.random.default_rng(p + l_)
    q = (_bf16(rng, b, p, 288, scale=0.1).float() + 0.05).to(torch.bfloat16)
    k = _bf16(rng, b, l_, 288, scale=0.1)
    if rising:   # q · k_l grows by ~0.7 (7 logits at scale 10) along L
        ramp = torch.linspace(0, 0.05, l_, device="cuda")[None, :, None]
        k = (k.float() + ramp).to(torch.bfloat16)
    v = _bf16(rng, b, l_, 2304)
    n0 = kernels.LAUNCHES["csa_attention"]
    got = ca.csa_attention(q, k, v, scale)
    assert kernels.LAUNCHES["csa_attention"] == n0 + 1
    ref = ca.csa_attention_plain(q.float(), k.float(), v.float(), scale)
    assert got.shape == ref.shape == (b, p, 2304)
    assert _rel(got, ref) <= REL_TOL


@torch.inference_mode()
def test_kernel_route_matches_plain_route(case):
    net, feat, _, _ = case
    x = torch.rand(2, 21, 37, 3, device="cuda")
    got = net.query_rgb_grid_kernels(feat, x, 4)
    net.dtype = torch.float32  # the plain route in f32 on the same values
    try:
        ref = net.query_rgb_grid(feat.float(), x, 4)
    finally:
        net.dtype = torch.bfloat16
    assert _rel(got, ref) <= REL_TOL


def test_wrappers_reject_f32(case):
    from ciaosr_torch.ops.kernels import csa_stencil as st
    _, feat, csa, dk = case
    w = torch.zeros(576, 256, device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        dk.f3p_build(feat.float(), csa, w, w, w[:64])
    with pytest.raises(ValueError, match="s=2"):
        st.csa_stencil_fused(csa, csa, csa, 10.0, 3)


@pytest.mark.parametrize("name", ["csa_stencil_fused", "csa_stencil",
                                  "csa_fused"])
def test_csa_map_wrappers_reject(case, name):
    """f32 maps and non-flagship channels raise; nothing falls back."""
    from ciaosr_torch.ops.kernels import csa_attention as ca
    from ciaosr_torch.ops.kernels import csa_stencil as st
    fn = getattr(st, name, None) or getattr(ca, name)
    match, keys, embed = _csa_inputs(case, (16, 32))
    with pytest.raises(ValueError, match="bfloat16"):
        fn(match.float(), keys, embed, 10.0, 2)
    with pytest.raises(ValueError, match="C=64"):
        fn(match, keys, embed[..., :32].contiguous(), 10.0, 2)
    with pytest.raises(ValueError, match="Cr=32"):
        fn(match[..., :16].contiguous(), keys, embed, 10.0, 2)


def test_csa_bank_wrappers_reject(case):
    from ciaosr_torch.ops.kernels import csa_attention as ca
    q = torch.zeros(1, 40, 288, device="cuda", dtype=torch.bfloat16)
    k = torch.zeros(1, 10, 288, device="cuda", dtype=torch.bfloat16)
    v = torch.zeros(1, 10, 2304, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        ca.csa_attention(q.float(), k, v, 10.0)
    with pytest.raises(ValueError, match="Dv=2304"):
        ca.csa_attention(q, k, v[..., :576].contiguous(), 10.0)
    with pytest.raises(ValueError, match="Dk=288"):
        ca.csa_attention_overlap_add(q[..., :72].contiguous(), k, v, 10.0,
                                     4, 10, 2)
    with pytest.raises(ValueError, match="P = Hp"):
        ca.csa_attention_overlap_add(q, k, v, 10.0, 4, 8, 2)


# ---- the SwinIR-CiaoSR generator of the 002 configs: row 11 and K1-K3 at
# C = 180 (no CSA), at full width with the depth cut to one group of two
SWIN_CFG = dict(
    type="LocalImplicitSRSWINIR", window_size=8,
    encoder=dict(type="SwinIR", embed_dim=180, depths=[2], num_heads=[6]),
    imnet_q=dict(type="MLPRefiner", out_dim=3, hidden_list=[256] * 4),
    imnet_k=dict(type="MLPRefiner", out_dim=64, hidden_list=[256] * 4),
    imnet_v=dict(type="MLPRefiner", out_dim=64, hidden_list=[256] * 4),
    non_local_attn=False, dtype="bf16", use_kernels=True)


@pytest.fixture(scope="module")
def swin_case():
    from ciaosr_torch.models.builder import build_generator
    net = build_generator(SWIN_CFG, device="cuda", seed=2)
    lq = np.random.default_rng(1).random((2, 21, 37, 3), dtype=np.float32)
    x = torch.as_tensor(lq, device="cuda") - 0.45
    with torch.inference_mode():
        feat = net.gen_feature(x)
    return net, x, feat


# (24, 40) shifted and not; (16, 16) is two windows a side; (6, 6) shrinks
# the window to 6 (36 tokens, no shift)
@pytest.mark.parametrize("hw,block", [((24, 40), 0), ((24, 40), 1),
                                      ((16, 16), 1), ((6, 6), 1)],
                         ids=["24x40", "24x40_shifted", "16x16_shifted",
                              "6x6_window_6"])
@torch.inference_mode()
def test_swin_block(swin_case, hw, block):
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.kernels import swin_block as sb
    net = swin_case[0]
    blk = net.encoder.layers[0].residual_group.blocks[block]
    ws, shift = blk.geometry(*hw)
    x = torch.as_tensor(np.random.default_rng(hw[0]).standard_normal(
        (2, *hw, 180)).astype(np.float32), device="cuda")
    pk = blk.packed(ws, torch.bfloat16)
    n0 = kernels.LAUNCHES["swin_block"]
    got = sb.swin_block(x, pk, ws, shift)
    assert kernels.LAUNCHES["swin_block"] == n0 + 1
    ref = sb.swin_block_plain(x, _f32(pk), ws, shift)
    assert got.shape == x.shape
    assert _rel(got, ref) <= REL_TOL
    # the residual dominates y: hold the block's own increment too
    assert _rel(got - x, ref - x) <= REL_TOL


def _block(c, heads, window, shift, seed):
    """A Swin block of c channels with seeded weights on the card (std
    0.05 matrices, std 0.5 biases and LayerNorms around 1, std 1 bias
    table: logits and LayerNorm outputs well away from zero)."""
    from ciaosr_torch.models import swinir as ts
    torch.manual_seed(seed)
    blk = ts.SwinBlock(c, heads, window, shift).cuda()
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if name.startswith("norm") and name.endswith("weight"):
                p.copy_(1.0 + 0.2 * torch.randn_like(p))
            elif "relative_position" in name:
                p.normal_()
            else:
                p.normal_(std=0.05 if p.dim() == 2 else 0.5)
    return blk


# the 002 training batch's map (6 x 64 x 64) shifted and not; narrow
# blocks: C = 48 with 2 heads, an odd C = 45 with 3 heads of 15 in 4 x 4
# windows (16 tokens), 7 x 7 windows (49 tokens, an odd count); an odd
# number of windows (15: a CTA's second warpgroup has none)
@pytest.mark.parametrize("shape,c,heads,window,shifted", [
    ((6, 64, 64), 180, 6, 8, True), ((6, 64, 64), 180, 6, 8, False),
    ((2, 16, 24), 48, 2, 8, True), ((1, 12, 20), 45, 3, 4, True),
    ((1, 14, 21), 48, 2, 7, True), ((1, 24, 40), 180, 6, 8, False)],
    ids=["6x64x64_shifted", "6x64x64", "C48_2heads", "C45_3heads_ws4",
         "C48_ws7", "15_windows"])
def test_swin_block_shapes(shape, c, heads, window, shifted):
    """Row 11 at the training shape and off SwinIR's widths against its
    f32 plain version (y and the increment y - x), one launch a call, the
    same bits on a second call and from a grid capped at 3 CTAs (each
    walks over several window pairs)."""
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.kernels import swin_block as sb
    blk = _block(c, heads, window, window // 2 if shifted else 0, c + heads)
    ws, shift = blk.geometry(*shape[1:])
    assert shift == (window // 2 if shifted else 0)
    x = torch.as_tensor(np.random.default_rng(sum(shape)).standard_normal(
        (*shape, c)).astype(np.float32), device="cuda")
    pk = blk.packed(ws, torch.bfloat16)
    with torch.inference_mode():
        n0 = kernels.LAUNCHES["swin_block"]
        got = sb.swin_block(x, pk, ws, shift)
        assert kernels.LAUNCHES["swin_block"] == n0 + 1
        ref = sb.swin_block_plain(x, _f32(pk), ws, shift)
        assert got.shape == x.shape and got.dtype == torch.float32
        assert _rel(got, ref) <= REL_TOL
        assert _rel(got - x, ref - x) <= REL_TOL
        assert torch.equal(sb.swin_block(x, pk, ws, shift), got)
        assert torch.equal(sb.launch_swin_block(x, pk, ws, shift, 3), got)
        assert torch.equal(sb.launch_swin_block(x, pk, ws, shift, 0), got)


def test_swin_block_rejects(swin_case):
    from ciaosr_torch.ops.kernels import swin_block as sb
    blk = swin_case[0].encoder.layers[0].residual_group.blocks[0]
    x = torch.zeros(1, 16, 16, 180, device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        sb.swin_block(x, blk.packed(8, torch.float32), 8, 0)
    with pytest.raises(ValueError, match="window"):
        sb.swin_block(x[:, :12], blk.packed(8, torch.bfloat16), 8, 0)


# K1-K3 at C = 192: s = 2, 3, 4, 4 shifts (one group) and 1, row 9's odd
# width, and logits spread until one shift takes almost all the weight
@pytest.mark.parametrize("scale,local_size,hw,softmax_scale", [
    (4, 2, (21, 37), 1.0), (3, 2, (21, 37), 1.0), (2, 1, (21, 37), 1.0),
    (4, 2, (60, 47), 1.0), (4, 2, (21, 37), 0.02)],
    ids=["x4", "x3", "x2_1shift", "60x47", "x4_spread"])
@torch.inference_mode()
def test_decode_kernels_c180(swin_case, scale, local_size, hw,
                             softmax_scale):
    """K1, K2 and K3 on the 180-channel feature, zero-padded to 192, no
    CSA."""
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.kernels import decoder as dk
    net, _, feat = swin_case
    if feat.shape[1:3] != hw:
        feat = net.gen_feature(torch.as_tensor(np.random.default_rng(3).random(
            (2, *hw, 3), dtype=np.float32), device="cuda") - 0.45)
    feat_p = torch.nn.functional.pad(feat, (0, 12)).contiguous()
    pk = dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, 180,
                         (2.0 / scale, 2.0 / scale), torch.bfloat16,
                         c_pad=192)
    args = (feat_p, None, pk["wk0"], pk["wvu"], pk["wvc"])
    gk, gv = dk.f3p_build(*args)
    assert _rel((gk, gv), dk.f3p_build_plain(*_f32(args))) <= REL_TOL
    wt, ck = dk.wt_hoist(feat_p, pk["wkout"], pk["bkout"])
    assert _rel((wt, ck), dk.wt_hoist_plain(
        feat_p.float(), pk["wkout"].float(), pk["bkout"])) <= REL_TOL
    tabs = dk.decoder_tables(scale, *hw, local_size, feat.device)
    n0 = kernels.LAUNCHES["grid_decode"]
    got = dk.grid_decode(feat_p, None, gk, gv, wt, ck, pk, tabs,
                         softmax_scale)
    assert kernels.LAUNCHES["grid_decode"] == n0 + 1
    ref = dk.grid_decode_plain(*_f32((feat_p, None, gk, gv, wt, ck)),
                               _f32(pk), tabs, softmax_scale)
    assert got.shape == (2, scale * scale, *hw, 3)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, ref) <= REL_TOL


@pytest.mark.parametrize("py,qy,px,qx,hw", [(5, 2, 5, 2, (20, 38)),
                                            (7, 3, 7, 3, (21, 39))],
                         ids=["x2.5", "x7/3"])
@torch.inference_mode()
def test_grid_decode_rational_c180(swin_case, py, qy, px, qx, hw):
    from ciaosr_torch.models.ciaosr import rational_cell
    from ciaosr_torch.ops.kernels import decoder as dk
    net = swin_case[0]
    x = torch.as_tensor(np.random.default_rng(py).random(
        (2, *hw, 3), dtype=np.float32), device="cuda") - 0.45
    h, w = hw
    maps = net._kernel_maps(net.gen_feature(x), rational_cell(
        h, w, h * py // qy, w * px // qx))
    tabs = dk.rational_tables(h, w, py, qy, px, qx, 2, x.device)
    got = dk.grid_decode_rational(*maps, tabs, 1.0)
    ref = dk.grid_decode_rational_plain(*_f32(maps[:6]), _f32(maps[6]),
                                        tabs, 1.0)
    assert got.shape == (2, py * px, h // qy, w // qx, 3)
    assert _rel(got, ref) <= REL_TOL


def test_wide_decode_rejects_nine_shifts(swin_case):
    from ciaosr_torch.ops.kernels import decoder as dk
    net, _, feat = swin_case
    with torch.inference_mode():
        maps = net._kernel_maps(feat, (0.5, 0.5))
    tabs = dk.decoder_tables(4, *feat.shape[1:3], 3, feat.device)
    with pytest.raises(ValueError, match="shifts"):
        dk.grid_decode(*maps, tabs, 1.0)
    with pytest.raises(ValueError, match="compiled for"):
        dk.f3p_build(maps[0][..., :160].contiguous(), None, maps[6]["wk0"],
                     maps[6]["wvu"], maps[6]["wvc"])


@torch.inference_mode()
def test_swin_route_matches_plain_route(swin_case):
    """The whole SwinIR kernel route (Swin block kernels, K1-K3, bf16)
    against the plain f32 route of the same weights, ×4 on 21 × 37 (the
    encoder pads to 24 × 40)."""
    net, x, _ = swin_case
    got = net.decode_grid(x, 4)
    net.dtype, net.use_kernels = torch.float32, False
    try:
        ref = net.decode_grid(x, 4)
    finally:
        net.dtype, net.use_kernels = torch.bfloat16, True
    assert got.shape == ref.shape == (2, 84, 148, 3)
    assert _rel(got, ref) <= REL_TOL


@pytest.mark.parametrize("kind", ["flagship", "swinir"])
def test_f32_model_kernel_route(kind):
    """An f32 model (no dtype in its config, as every shipped config) with
    use_kernels: its kernel route hands the kernels bf16 (the wrappers
    take nothing else) and agrees with its plain f32 route, ×4 on 21 × 37,
    every kernel of the route launched."""
    from ciaosr_torch.models.builder import build_generator
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.sampling import interpolate_bilinear
    cfg = dict(CFG if kind == "flagship" else SWIN_CFG, dtype=None)
    net = build_generator(cfg, device="cuda", seed=3)
    assert net.dtype == torch.float32 and net.use_kernels
    x = torch.as_tensor(np.random.default_rng(7).random(
        (2, 21, 37, 3), dtype=np.float32), device="cuda") - 0.45
    kernels.reset_launches()
    with torch.no_grad():   # the eval route (under autograd: row 12 too)
        got = net.decode_grid(x, 4)
    ran = {k for k, v in kernels.LAUNCHES.items() if v}
    want = {"f3p_build", "wt_hoist", "grid_decode"}
    if kind == "swinir":
        want.add("swin_block")
        assert kernels.LAUNCHES["swin_block"] == 2
    else:
        want.add("csa_attention")   # 21 × 37 (22 × 38 in CSA): streaming
    assert ran == want
    net.use_kernels = False
    try:
        with torch.no_grad():
            ref = net.decode_grid(x, 4)
    finally:
        net.use_kernels = True
    base = interpolate_bilinear(x, 84, 148)   # the f32 residual of both
    assert got.shape == ref.shape == (2, 84, 148, 3)
    assert _rel(got, ref) <= REL_TOL
    assert _rel(got - base, ref - base) <= REL_TOL


BWD_KEYS = ("swin_block_bwd", "swin_block_wgrad", "swin_block_gsum")


# (2, 16, 24) shifted; the 002 training batch's token map (6, 64, 64),
# shifted and not; (1, 6, 6) shrinks the window to 6 (36 tokens)
@pytest.mark.parametrize("shape,block", [((2, 16, 24), 1), ((6, 64, 64), 1),
                                         ((6, 64, 64), 0), ((1, 6, 6), 1)],
                         ids=["2x16x24_shifted", "6x64x64_shifted",
                              "6x64x64", "1x6x6_window_6"])
def test_swin_block_bwd(swin_case, shape, block):
    """Row 12 against autograd through the f32 plain block on the same
    bf16 packed weights: dx - dy ≤ 1e-2 and each packed gradient ≤ 2e-2
    (the kernel rounds dq, dk, dv, dl, dz1 and dx1 to bf16 as the TPU
    kernel does); its sums are the same bits run to run."""
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.kernels import swin_block as sb
    blk = swin_case[0].encoder.layers[0].residual_group.blocks[block]
    b, h, w = shape
    ws, shift = blk.geometry(h, w)
    rng = np.random.default_rng(h + block)
    x, dy = (torch.as_tensor(rng.standard_normal((b, h, w, 180)).astype(
        np.float32), device="cuda") for _ in range(2))
    pk = blk.packed(ws, torch.bfloat16)
    n0 = {k: kernels.LAUNCHES[k] for k in BWD_KEYS}
    dx, g = sb.swin_block_bwd(x, dy, pk, ws, shift)
    assert {k: kernels.LAUNCHES[k] - n0[k] for k in BWD_KEYS} == dict.fromkeys(
        BWD_KEYS, 1)
    rdx, rg = sb.swin_block_bwd_plain(x, dy, _f32(pk), ws, shift)
    assert dx.shape == x.shape
    assert _rel(dx - dy, rdx - dy) <= 1e-2
    for k, ref in rg.items():
        assert g[k].shape == ref.shape and g[k].dtype == torch.float32
        assert _rel(g[k], ref) <= 2e-2, k
    dx2, g2 = sb.swin_block_bwd(x, dy, pk, ws, shift)
    assert torch.equal(dx, dx2) and all(torch.equal(g[k], g2[k]) for k in g)


# narrow blocks on a (2, 16, 16) map, shifted: 3 heads of 32 (C = 96), 30
# (C = 90) and 15 (C = 45, an odd C: unaligned f32 rows) leave head slots
# 3-5 empty, channels past C and hidden columns past 2C padded, and
# (below 32) columns of each slot past head_dim
@pytest.mark.parametrize("c", [96, 90, 45],
                         ids=["C96_3heads", "C90_3heads", "C45_3heads"])
def test_swin_block_bwd_narrow(c):
    """Row 12 on a block narrower than the packed layout: within the same
    limits of its f32 plain version, the same bits twice, and every
    gradient of a padded channel, an empty or padded head-slot column and a
    padded hidden column exactly 0."""
    from ciaosr_torch.ops.kernels import swin_block as sb
    blk = _block(c, 3, 8, 4, c)
    ws, shift = blk.geometry(16, 16)
    assert (ws, shift) == (8, 4)
    rng = np.random.default_rng(c)
    x, dy = (torch.as_tensor(rng.standard_normal((2, 16, 16, c)).astype(
        np.float32), device="cuda") for _ in range(2))
    pk = blk.packed(ws, torch.bfloat16)
    dx, g = sb.swin_block_bwd(x, dy, pk, ws, shift)
    rdx, rg = sb.swin_block_bwd_plain(x, dy, _f32(pk), ws, shift)
    assert _rel(dx - dy, rdx - dy) <= 1e-2
    for k, ref in rg.items():
        assert _rel(g[k], ref) <= 2e-2, k
    dx2, g2 = sb.swin_block_bwd(x, dy, pk, ws, shift)
    assert torch.equal(dx, dx2) and all(torch.equal(g[k], g2[k]) for k in g)
    hd, hid = c // 3, 2 * c
    live = torch.zeros(3 * sb.CP, dtype=torch.bool, device="cuda")
    for p in range(3):   # the q, k, v columns of the 3 heads' real dims
        for h in range(3):
            at = p * sb.CP + sb.HD * h
            live[at:at + hd] = True
    slot_rows = live[:sb.CP]   # wp's rows follow the same slots
    zero = {"g1": g["g1"][c:], "b1": g["b1"][c:], "bp": g["bp"][c:],
            "g2": g["g2"][c:], "b2": g["b2"][c:], "b2m": g["b2m"][c:],
            "b1m": g["b1m"][hid:], "bqkv": g["bqkv"][~live],
            "wqkv rows": g["wqkv"][c:], "wqkv cols": g["wqkv"][:, ~live],
            "wp rows": g["wp"][~slot_rows], "wp cols": g["wp"][:, c:],
            "w1 rows": g["w1"][c:], "w1 cols": g["w1"][:, hid:],
            "w2 rows": g["w2"][hid:], "w2 cols": g["w2"][:, c:]}
    for k, v in zero.items():
        assert v.numel() and not v.any(), k
    assert g["bqkv"][live].any() and g["wqkv"][:c, live].any()


def test_swin_block_bwd_rejects(swin_case):
    from ciaosr_torch.ops.kernels import swin_block as sb
    blk = swin_case[0].encoder.layers[0].residual_group.blocks[0]
    x = torch.zeros(1, 16, 16, 180, device="cuda")
    pk = blk.packed(8, torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):   # f32 weights
        sb.swin_block_bwd(x, x, blk.packed(8, torch.float32), 8, 0)
    with pytest.raises(ValueError, match="float32"):    # a bf16 dy
        sb.swin_block_bwd(x, x.bfloat16(), pk, 8, 0)
    five = dict(pk, bias=pk["bias"][:5].contiguous())   # head_dim 36 > 32
    with pytest.raises(ValueError, match="head_dim"):
        sb.swin_block_bwd(x, x, five, 8, 0)
    x9 = torch.zeros(1, 18, 18, 180, device="cuda")     # ws² = 81 > 64
    with pytest.raises(ValueError, match="window"):
        sb.swin_block_bwd(x9, x9, pk, 9, 0)


def _wgrad_pairs(t, n, seed):
    """Seeded bf16 pairs of t tokens on the card, NT rows a window of
    which the first n are tokens (the rest zero)."""
    from ciaosr_torch.ops.kernels import swin_block as sb
    rng = np.random.default_rng(seed)
    live = (np.arange(t) % sb.NT < n)[:, None]
    return [torch.as_tensor(np.where(live, rng.standard_normal(
        (t, width)), 0.0).astype(np.float32), device="cuda").to(
        torch.bfloat16) for _, width in sb._PAIRS]


# T = 64 (one window of 36 tokens: one chunk holds every token), 512 and
# the 002 training batch's 24576 (384 windows)
@pytest.mark.parametrize("t,n", [(64, 36), (512, 64), (24576, 64)],
                         ids=["T64_window_6", "T512", "T24576"])
def test_swin_block_wgrad(t, n):
    """Row 12's weight-gradient kernel against its plain version on the
    same bf16 pairs, summed over the chunks: both sum bf16 products in f32,
    in another order, so max|Δ|/max|ref| ≤ 1e-3; the same bits twice; one
    launch a call; chunks past the last token are 0."""
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.kernels import swin_block as sb
    pairs = _wgrad_pairs(t, n, t + n)
    n0 = kernels.LAUNCHES["swin_block_wgrad"]
    part = sb.swin_block_wgrad(pairs)
    assert kernels.LAUNCHES["swin_block_wgrad"] - n0 == 1
    ld = sum(r * c for _, (r, c) in sb._MATRICES)
    assert part.shape == (sb.WGRAD_SPLITS, ld) and part.dtype == torch.float32
    ref = sb.swin_block_wgrad_plain(pairs)
    assert _rel(part.sum(0), ref) <= 1e-3
    assert torch.equal(part, sb.swin_block_wgrad(pairs))
    chunk = -(-t // sb.WGRAD_SPLITS // sb.NT) * sb.NT
    assert not part[-(-t // chunk):].any()


@pytest.mark.parametrize("nwin,lw,ns,ld", [(1, 5, 1, 3), (384, 24960, 8,
                                                         259200)],
                         ids=["tiny", "train_batch"])
def test_swin_block_gsum(nwin, lw, ns, ld):
    """Row 12's sum kernel alone on seeded partials (one row each, and the
    002 training batch's sizes): the column sums within f32 rounding of
    ``Tensor.sum``, the same bits twice, one launch a call."""
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.kernels import swin_block as sb
    rng = np.random.default_rng(nwin)
    part, wpart = (torch.as_tensor(rng.standard_normal(
        shape, dtype=np.float32), device="cuda") for shape in ((nwin, lw),
                                                               (ns, ld)))
    n0 = kernels.LAUNCHES["swin_block_gsum"]
    got = sb.swin_block_gsum(part, wpart)
    assert kernels.LAUNCHES["swin_block_gsum"] == n0 + 1
    assert got.shape == (lw + ld,)
    assert _rel(got, torch.cat([part.sum(0), wpart.sum(0)])) <= 1e-5
    assert torch.equal(got, sb.swin_block_gsum(part, wpart))


def _padded_partials(part, c, heads, hid):
    """The entries of each chunk's partial row that must be 0 for a block
    of c channels, heads heads and hid hidden columns: padded channels,
    empty or padded head-slot columns, padded hidden columns."""
    from ciaosr_torch.ops.kernels import swin_block as sb
    hd = c // heads
    live = torch.zeros(3 * sb.CP, dtype=torch.bool, device=part.device)
    for p in range(3):
        for h in range(heads):
            at = p * sb.CP + sb.HD * h
            live[at:at + hd] = True
    mats, at = {}, 0
    for k, (r, cl) in sb._MATRICES:
        mats[k] = part[:, at:at + r * cl].view(-1, r, cl)
        at += r * cl
    return {"wqkv rows": mats["wqkv"][:, c:],
            "wqkv cols": mats["wqkv"][:, :, ~live],
            "wp rows": mats["wp"][:, ~live[:sb.CP]],
            "wp cols": mats["wp"][:, :, c:],
            "w1 rows": mats["w1"][:, c:], "w1 cols": mats["w1"][:, :, hid:],
            "w2 rows": mats["w2"][:, hid:], "w2 cols": mats["w2"][:, :, c:]}


@pytest.mark.parametrize("source", ["window_kernel", "pairs_plain"])
def test_swin_block_wgrad_padded_zero(source):
    """On the pairs of a narrow shifted block (C = 90, 3 heads of 30,
    hidden 180 on a 2 × 16 × 16 map) that the window kernel wrote, or that
    swin_block_pairs_plain gives (rounded to bf16), every chunk's partial of
    a padded channel, an empty or padded head-slot column or a padded
    hidden column is exactly 0, and the live entries are not all 0."""
    from ciaosr_torch.ops.kernels import swin_block as sb
    c = 90
    blk = _block(c, 3, 8, 4, c)
    ws, shift = blk.geometry(16, 16)
    rng = np.random.default_rng(c + 1)
    x, dy = (torch.as_tensor(rng.standard_normal((2, 16, 16, c)).astype(
        np.float32), device="cuda") for _ in range(2))
    pk = blk.packed(ws, torch.bfloat16)
    if source == "window_kernel":
        pairs = sb.launch_swin_bwd_window(x, dy, pk, ws, shift)[1]
    else:
        pairs = [p.to(torch.bfloat16) for p in sb.swin_block_pairs_plain(
            x, dy, pk, ws, shift)]
    part = sb.swin_block_wgrad(pairs)
    for k, v in _padded_partials(part, c, 3, 2 * c).items():
        assert v.numel() and not v.any(), k
    assert part[:, :c * 3 * sb.CP].any()


def test_swin_training_step_runs_row_12(swin_case):
    """A backward through the generator with kernels on launches row 12
    once per Swin block (forward: row 11 once per block)."""
    from ciaosr_torch.ops import kernels
    net, x, _ = swin_case
    n_blocks = sum(len(l.residual_group.blocks) for l in net.encoder.layers)
    n0 = dict(kernels.LAUNCHES)
    feat = net.gen_feature(x)
    feat.float().square().mean().backward()
    got = {k: kernels.LAUNCHES[k] - n0[k] for k in ("swin_block", *BWD_KEYS)}
    assert got == dict.fromkeys(got, n_blocks)
    net.zero_grad(set_to_none=True)


# ---- config 001 swinir: SwinIR-CiaoSR with CSA at 180 channels
SWIN_CSA_CFG = dict(SWIN_CFG, non_local_attn=True)


@pytest.fixture(scope="module")
def swin_csa_case():
    from ciaosr_torch.models.builder import build_generator
    return build_generator(SWIN_CSA_CFG, device="cuda", seed=4)


def _net_maps(net, hw, seed):
    """The encoder's features (bf16) of a seeded 1-image batch and their
    CSA maps (match, keys, embed) at the real widths."""
    lq = np.random.default_rng(seed).random((1, *hw, 3), dtype=np.float32)
    x = torch.as_tensor(lq, device="cuda") - 0.45
    feat = net.gen_feature(x).contiguous()
    return x, feat, net.cs_attn.stencil_inputs(feat, 2, torch.bfloat16)


def _width_maps(case, swin_csa_case, width, hw, seed):
    net = case[0] if width == "flagship" else swin_csa_case
    return (net, *_net_maps(net, hw, seed))


# K4 at both compiled pairs: 16 × 16 (L = 64), 22 × 38 (P, L off every
# tile, L odd) and 24 × 48 (Wq = 12, off the 8-key tiles)
@pytest.mark.parametrize("width,hw", [
    ("flagship", (16, 16)), ("wide", (16, 16)), ("wide", (21, 37)),
    ("wide", (24, 48))],
    ids=["flagship_16x16", "C180_16x16", "C180_21x37", "C180_24x48"])
@torch.inference_mode()
def test_csa_stencil_fused_widths(case, swin_csa_case, width, hw):
    """K4 on the padded maps against its plain version at the real widths;
    the padded output channels are zero; the same bits call after call."""
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.kernels import csa_stencil as st
    _, _, _, maps = _width_maps(case, swin_csa_case, width, hw, 5)
    c = maps[2].shape[-1]
    padded = st.pad_maps(*maps)
    n0 = kernels.LAUNCHES["csa_stencil_fused"]
    got = st.csa_stencil_fused(*padded, 10.0, 2)
    assert kernels.LAUNCHES["csa_stencil_fused"] == n0 + 1
    assert torch.equal(got, st.csa_stencil_fused(*padded, 10.0, 2))
    ref = st.csa_stencil_fused_plain(*(t.float() for t in maps), 10.0, 2)
    assert got.shape[-1] == padded[2].shape[-1]
    assert not got[..., c:].any()
    assert _rel(got[..., :c], ref) <= REL_TOL


# row 7 at both pairs on the banks of the maps (72 × 72 is the Set5
# bird's tile; 21 × 37 pads to 22 × 38), and at the wide pair on seeded
# banks off its tiles and with rising scores
@pytest.mark.parametrize("width,hw", [
    ("flagship", (21, 37)), ("wide", (21, 37)), ("wide", (72, 72))],
    ids=["flagship_21x37", "C180_21x37", "C180_72x72"])
@torch.inference_mode()
def test_csa_attention_widths(case, swin_csa_case, width, hw):
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.kernels import csa_attention as ca
    from ciaosr_torch.ops.kernels import csa_stencil as st
    from ciaosr_torch.ops.neighborhood import extract_patches_same
    _, _, _, maps = _width_maps(case, swin_csa_case, width, hw, 6)
    match, keys, embed = st.pad_maps(*maps)
    c, cp = maps[2].shape[-1], embed.shape[-1]
    q = extract_patches_same(match, 3, 1).contiguous()
    v = extract_patches_same(embed, 6, 2).contiguous()
    n0 = kernels.LAUNCHES["csa_attention"]
    got = ca.csa_attention(q, keys, v, 10.0)
    assert kernels.LAUNCHES["csa_attention"] == n0 + 1
    assert got.shape == (1, q.shape[1], 36 * cp)
    ref = ca.csa_attention_plain(
        extract_patches_same(maps[0].float(), 3, 1), maps[1].float(),
        extract_patches_same(maps[2].float(), 6, 2), 10.0)
    got = got.reshape(1, -1, 36, cp)
    assert not got[..., c:].any()
    assert _rel(got[..., :c].reshape(ref.shape), ref) <= REL_TOL


@pytest.mark.parametrize("b,p,l_,rising", [
    (1, 40, 30, False), (2, 100, 200, False), (2, 130, 1000, True)],
    ids=["P40_L30", "B2_P100_L200", "rising_L1000"])
@torch.inference_mode()
def test_csa_attention_wide_edges(b, p, l_, rising):
    from ciaosr_torch.ops.kernels import csa_attention as ca
    rng = np.random.default_rng(p + l_ + 1)
    q = (_bf16(rng, b, p, 864, scale=0.06).float() + 0.03).to(torch.bfloat16)
    k = _bf16(rng, b, l_, 864, scale=0.06)
    if rising:
        ramp = torch.linspace(0, 0.03, l_, device="cuda")[None, :, None]
        k = (k.float() + ramp).to(torch.bfloat16)
    v = _bf16(rng, b, l_, 6912)
    got = ca.csa_attention(q, k, v, 10.0)
    ref = ca.csa_attention_plain(q.float(), k.float(), v.float(), 10.0)
    assert got.shape == ref.shape == (b, p, 6912)
    assert _rel(got, ref) <= REL_TOL
    assert torch.equal(got, ca.csa_attention(q, k, v, 10.0))


# K1 and K3 at both pairs on the model's own maps (21 × 37: K3 at the odd
# width, row 9; 16 × 32: W % 8 = 0), each against the plain chain at the
# real widths (unpadded packing); ×4, 4 shifts
@pytest.mark.parametrize("width,hw", [
    ("flagship", (16, 32)), ("wide", (21, 37)), ("wide", (16, 32))],
    ids=["flagship_16x32", "C180_21x37", "C180_16x32"])
@torch.inference_mode()
def test_decode_kernels_widths(case, swin_csa_case, width, hw):
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.kernels import decoder as dk
    net, _, feat, _ = _width_maps(case, swin_csa_case, width, hw, 7)
    c = feat.shape[-1]
    feat_p, csa_p, gk, gv, wt, ck, pk = net._kernel_maps(feat, (0.5, 0.5))
    want = (64, 64) if width == "flagship" else (192, 192)
    assert dk.widths(feat_p, csa_p) == want
    feat_r, csa_r = feat_p[..., :c].float(), csa_p[..., :c].float()
    # the kernels' bf16 weights, packed at the real widths
    pk_r = _f32(dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, c,
                                (0.5, 0.5), torch.bfloat16))
    n0 = kernels.LAUNCHES["f3p_build"]
    got_g = dk.f3p_build(feat_p, csa_p, pk["wk0"], pk["wvu"], pk["wvc"])
    assert kernels.LAUNCHES["f3p_build"] == n0 + 1
    assert _rel(got_g, dk.f3p_build_plain(
        feat_r, csa_r, pk_r["wk0"], pk_r["wvu"], pk_r["wvc"])) <= REL_TOL
    tabs = dk.decoder_tables(4, *hw, net.local_size, feat.device)
    n0 = kernels.LAUNCHES["grid_decode"]
    got = dk.grid_decode(feat_p, csa_p, gk, gv, wt, ck, pk, tabs,
                         net.softmax_scale)
    assert kernels.LAUNCHES["grid_decode"] == n0 + 1
    assert torch.equal(got, dk.grid_decode(feat_p, csa_p, gk, gv, wt, ck,
                                           pk, tabs, net.softmax_scale))
    ref = dk.grid_decode_plain(feat_r, csa_r, gk.float(), gv.float(),
                               wt.float(), ck, pk_r, tabs,
                               net.softmax_scale)
    assert got.shape == ref.shape == (1, 16, *hw, 3)
    assert _rel(got, ref) <= REL_TOL


@torch.inference_mode()
def test_wide_rational_and_csa_forms_raise(swin_csa_case):
    """At the wide pairs K3's rational mode and rows 5 and 6 launch their
    kernels: rows 5 and 6 K4's wide pair (the same bits as K4), the
    rational mode its (192, 192) instance (×2.5, within 1e-2 of its plain
    version); every other width still raises before any launch."""
    from ciaosr_torch.models.ciaosr import rational_cell
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.kernels import csa_attention as ca
    from ciaosr_torch.ops.kernels import csa_stencil as st
    from ciaosr_torch.ops.kernels import decoder as dk
    net = swin_csa_case
    _, feat, maps = _net_maps(net, (16, 32), 8)
    padded = st.pad_maps(*maps)
    n0 = dict(kernels.LAUNCHES)
    want = st.csa_stencil_fused(*padded, 10.0, 2)
    for fn in (st.csa_stencil, ca.csa_fused):
        assert torch.equal(fn(*padded, 10.0, 2), want)
    mp = net._kernel_maps(feat, rational_cell(16, 32, 40, 80))
    tabs = dk.rational_tables(16, 32, 5, 2, 5, 2, 2, feat.device)
    got = dk.grid_decode_rational(*mp, tabs, 1.0)
    assert _rel(got, dk.grid_decode_rational_plain(
        *_f32(mp[:6]), _f32(mp[6]), tabs, 1.0)) <= REL_TOL
    assert {k: v - n0[k] for k, v in kernels.LAUNCHES.items() if v != n0[k]
            } == {"csa_stencil_fused": 2, "csa_stencil": 1, "csa_fused": 1,
                  "f3p_build": 1, "wt_hoist": 1, "grid_decode_rational": 1}
    with pytest.raises(ValueError, match="compiled for"):
        dk.grid_decode_rational(mp[0][..., :96].contiguous(), None, *mp[2:],
                                tabs, 1.0)
    assert kernels.LAUNCHES["grid_decode_rational"] == n0[
        "grid_decode_rational"] + 1


# rows 5 and 6 at (96, 192) on a 40 × 48 map (scores 92 KB a row of
# queries) with the scores budget forced down: 5 blocks of 8-row query
# tiles, and 28 blocks of 1-3 rows off the tiles
@pytest.mark.parametrize("name", ["csa_stencil", "csa_fused"])
@pytest.mark.parametrize("budget,n_blocks", [(1_100_000, 5), (420_000, 28)],
                         ids=["tiles", "rows"])
@torch.inference_mode()
def test_wide_csa_forms_blocked(swin_csa_case, name, budget, n_blocks):
    """The wide pair over blocks of output rows gives the same bits as one
    launch over the whole map, one launch a block counted under the
    wrapper's name, and holds the plain version at the real widths."""
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.kernels import csa_attention as ca
    from ciaosr_torch.ops.kernels import csa_stencil as st
    _, _, maps = _net_maps(swin_csa_case, (40, 48), 12)
    c = maps[2].shape[-1]
    padded = st.pad_maps(*maps)
    assert st.wide_blocks(1, 40, 48) == [(0, 40)]
    assert len(st.wide_blocks(1, 40, 48, budget)) == n_blocks
    whole = (st.csa_stencil if name == "csa_stencil" else ca.csa_fused)(
        *padded, 10.0, 2)
    n0 = kernels.LAUNCHES[name]
    got = st.launch_stencil_sm90(name, *padded, 10.0, 2, budget=budget)
    assert kernels.LAUNCHES[name] == n0 + n_blocks
    assert torch.equal(got, whole)
    ref = st.csa_stencil_plain(*(t.float() for t in maps), 10.0, 2)
    assert not got[..., c:].any()
    assert _rel(got[..., :c], ref) <= REL_TOL


# row 10 at (192, 192) on the model's own maps, against its plain version
# at the real widths (unpacked at 180 channels)
@pytest.mark.parametrize("py,qy,hw", [(5, 2, (16, 32)), (7, 3, (21, 39))],
                         ids=["x2.5", "x7/3"])
@torch.inference_mode()
def test_grid_decode_rational_c180_csa(swin_csa_case, py, qy, hw):
    from ciaosr_torch.models.ciaosr import rational_cell
    from ciaosr_torch.ops.kernels import decoder as dk
    net = swin_csa_case
    _, feat, _ = _net_maps(net, hw, py)
    c = feat.shape[-1]
    cell = rational_cell(*hw, hw[0] * py // qy, hw[1] * py // qy)
    feat_p, csa_p, gk, gv, wt, ck, pk = net._kernel_maps(feat, cell)
    assert dk.widths(feat_p, csa_p) == (192, 192)
    pk_r = _f32(dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, c,
                                cell, torch.bfloat16))
    tabs = dk.rational_tables(*hw, py, qy, py, qy, net.local_size,
                              feat.device)
    got = dk.grid_decode_rational(feat_p, csa_p, gk, gv, wt, ck, pk, tabs,
                                  net.softmax_scale)
    assert torch.equal(got, dk.grid_decode_rational(
        feat_p, csa_p, gk, gv, wt, ck, pk, tabs, net.softmax_scale))
    ref = dk.grid_decode_rational_plain(
        feat_p[..., :c].float(), csa_p[..., :c].float(), gk.float(),
        gv.float(), wt.float(), ck, pk_r, tabs, net.softmax_scale)
    assert got.shape == ref.shape == (1, py * py, hw[0] // qy, hw[1] // qy,
                                      3)
    assert _rel(got, ref) <= REL_TOL


@pytest.mark.parametrize("hw,middle", [((16, 32), "csa_stencil_fused"),
                                       ((21, 37), "csa_attention")],
                         ids=["stencil_fused", "streaming"])
@torch.inference_mode()
def test_swin_csa_route_matches_plain_route(swin_csa_case, hw, middle):
    """Config 001 swinir's kernel route (Swin block kernels, the CSA
    kernel at (96, 192), K1-K3 at (192, 192), bf16) against the plain f32
    route of the same weights, ×4; every kernel of the route launched."""
    from ciaosr_torch.ops import kernels
    net = swin_csa_case
    x = torch.as_tensor(np.random.default_rng(9).random(
        (1, *hw, 3), dtype=np.float32), device="cuda") - 0.45
    kernels.reset_launches()
    got = net.decode_grid(x, 4)
    assert {k for k, v in kernels.LAUNCHES.items() if v} == {
        "swin_block", middle, "f3p_build", "wt_hoist", "grid_decode"}
    net.dtype, net.use_kernels = torch.float32, False
    try:
        ref = net.decode_grid(x, 4)
    finally:
        net.dtype, net.use_kernels = torch.bfloat16, True
    assert got.shape == ref.shape == (1, 4 * hw[0], 4 * hw[1], 3)
    assert _rel(got, ref) <= REL_TOL


# ---- the one-tap instances (feat_unfold=False): K1, K2, K3 (row 9 at the
# odd width) and row 10 at (C, DC) = (64, 64), DK = 64, on an EDSR
# generator's own maps

@pytest.fixture(scope="module")
def u1_case():
    from ciaosr_torch.models.builder import build_generator
    cfg = dict(type="LocalImplicitSREDSR",
               encoder=dict(type="EDSR", in_channels=3, mid_channels=64,
                            num_blocks=2),
               imnet_q=dict(type="MLPRefiner", out_dim=3,
                            hidden_list=[256] * 4),
               imnet_k=dict(type="MLPRefiner", out_dim=64,
                            hidden_list=[256] * 4),
               imnet_v=dict(type="MLPRefiner", out_dim=64,
                            hidden_list=[256] * 4),
               feat_unfold=False, dtype="bf16", use_kernels=True)
    return build_generator(cfg, device="cuda", seed=5)


@pytest.mark.parametrize("hw,scale,local_size", [
    ((21, 37), 4, 2), ((13, 29), 3, 3), ((60, 47), 4, 2), ((20, 38), 2, 1)],
    ids=["x4", "x3_9shifts", "60x47", "x2_1shift"])
@torch.inference_mode()
def test_one_tap_decode_kernels(u1_case, hw, scale, local_size):
    """K1, K2 and K3 at one tap, each against its plain version on the
    same inputs; 60 × 47 is row 9's odd width."""
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.kernels import decoder as dk
    net = u1_case
    _, feat, csa = _features(net, hw, hw[0] + scale)
    pk = dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, 64,
                         (2.0 / scale, 2.0 / scale), torch.bfloat16)
    assert pk["wk0"].shape == (64, 256) and pk["vout"].shape == (256, 128)
    n0 = dict(kernels.LAUNCHES)
    gk, gv = dk.f3p_build(feat, csa, pk["wk0"], pk["wvu"], pk["wvc"])
    assert _rel((gk, gv), dk.f3p_build_plain(*_f32((
        feat, csa, pk["wk0"], pk["wvu"], pk["wvc"])))) <= REL_TOL
    wt, ck = dk.wt_hoist(feat, pk["wkout"], pk["bkout"])
    assert _rel((wt, ck), dk.wt_hoist_plain(
        feat.float(), pk["wkout"].float(), pk["bkout"])) <= REL_TOL
    tabs = dk.decoder_tables(scale, *hw, local_size, feat.device)
    got = dk.grid_decode(feat, csa, gk, gv, wt, ck, pk, tabs, 1.0)
    ref = dk.grid_decode_plain(*_f32((feat, csa, gk, gv, wt, ck)), _f32(pk),
                               tabs, 1.0)
    assert {k: v - n0[k] for k, v in kernels.LAUNCHES.items()
            if v != n0[k]} == {"f3p_build": 1, "wt_hoist": 1,
                               "grid_decode": 1}
    assert got.shape == (2, scale * scale, *hw, 3)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, ref) <= REL_TOL


@pytest.mark.parametrize("py,qy,hw,local_size", [
    (5, 2, (20, 38), 2), (7, 3, (21, 39), 2), (5, 2, (20, 38), 3)],
    ids=["x2.5", "x7/3", "x2.5_9shifts"])
@torch.inference_mode()
def test_one_tap_rational(u1_case, py, qy, hw, local_size):
    """Row 10 at one tap (DV = 128: one partial value chunk) against its
    plain version, and the whole one-tap rational route against the plain
    f32 route of the same features."""
    from ciaosr_torch.models.ciaosr import rational_cell
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.kernels import decoder as dk
    net = u1_case
    x, feat, csa = _features(net, hw, py + local_size)
    h, w = hw
    pk = dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, 64,
                         rational_cell(h, w, h * py // qy, w * py // qy),
                         torch.bfloat16)
    tabs = dk.rational_tables(h, w, py, qy, py, qy, local_size, feat.device)
    gk, gv = dk.f3p_build(feat, csa, pk["wk0"], pk["wvu"], pk["wvc"])
    wt, ck = dk.wt_hoist(feat, pk["wkout"], pk["bkout"])
    n0 = kernels.LAUNCHES["grid_decode_rational"]
    got = dk.grid_decode_rational(feat, csa, gk, gv, wt, ck, pk, tabs, 1.0)
    assert kernels.LAUNCHES["grid_decode_rational"] == n0 + 1
    ref = dk.grid_decode_rational_plain(*_f32((feat, csa, gk, gv, wt, ck)),
                                        _f32(pk), tabs, 1.0)
    assert got.shape == (2, py * py, h // qy, w // qy, 3)
    assert _rel(got, ref) <= REL_TOL
    got = net.query_rgb_grid_rational_kernels(feat, x, py, qy, py, qy)
    net.dtype = torch.float32
    try:
        ref = net.query_rgb_grid_rational(feat.float(), x, py, qy, py, qy)
    finally:
        net.dtype = torch.bfloat16
    assert _rel(got, ref) <= REL_TOL


@torch.inference_mode()
def test_one_tap_route_matches_plain_route(u1_case):
    """The one-tap kernel route (K4, K1-K3, bf16) ×4 against the plain f32
    route of the same weights, through the encoder."""
    net = u1_case
    x = torch.as_tensor(np.random.default_rng(8).random(
        (1, 32, 40, 3), dtype=np.float32), device="cuda") - 0.45
    got = net.decode_grid(x, 4)
    net.dtype, net.use_kernels = torch.float32, False
    try:
        ref = net.decode_grid(x, 4)
    finally:
        net.dtype, net.use_kernels = torch.bfloat16, True
    assert got.shape == ref.shape == (1, 128, 160, 3)
    assert _rel(got, ref) <= REL_TOL


@torch.inference_mode()
def test_one_tap_other_widths_raise(u1_case):
    """A one-tap decode at (C, DC) = (192, 192) or (192, 0) has no instance:
    every wrapper raises before a launch, naming its ROADMAP.md item."""
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.kernels import decoder as dk
    rng = np.random.default_rng(2)
    n0 = dict(kernels.LAUNCHES)
    for dc in (192, 0):
        feat = _bf16(rng, 1, 8, 16, 192)
        csa = _bf16(rng, 1, 8, 16, dc) if dc else None
        w0 = _bf16(rng, 192, 256)
        with pytest.raises(ValueError, match="queue 2 item 3"):
            dk.f3p_build(feat, csa, w0, w0, _bf16(rng, dc, 256))
        with pytest.raises(ValueError, match="queue 2 item 3"):
            dk.wt_hoist(feat, w0, torch.zeros(192, device="cuda"))
        tabs = dk.decoder_tables(2, 8, 16, 2, feat.device)
        with pytest.raises(ValueError, match="queue 2 item 3"):
            dk.grid_decode(feat, csa, None, None, None, None, {"wk0": w0},
                           tabs, 1.0)
    assert kernels.LAUNCHES == n0
