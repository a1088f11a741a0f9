"""Config 001 swinir's kernel route at its own 180 channels on the CPU:
the padding that takes its widths to the compiled kernels (the CSA maps
from Cr = 90, C = 180 to 96, 192; the decoder's feature and CSA map from
180 to 192), against the JAX package, f32, the same weights through
state_dict_from_jax(encoder="swinir", non_local_attn=True), with the 001
generator dict cut to one Swin block (as tests/test_torch_swinir_csa.py's
``embed180`` case).

- The padded CSA kernel route (``nl_feature(use_kernel=True)``) against
  JAX's ``nl_feature`` on a streaming and on a stencil_fused geometry.
- The dense ×4 grid decode through the kernel route
  (``query_rgb_grid_kernels``) against JAX's per-query ``query_rgb`` over
  the whole HR grid, at an even and an odd LR width.
- ``pack_decoder(c_pad=192, dc_pad=192)``: the plain K1 → K2 → K3 chain
  on the padded maps equals the unpadded chain; the flagship widths pack
  as they did.
- The rational dense decode through the kernel route (K1 → K2 → K3's
  rational mode at (192, 192)) against JAX's per-query ``query_rgb`` over
  the HR grid, at ×2.5 and ×7/3; the padded rational chain equals the
  unpadded one.
- The config's ``val_scale > 4`` protocol: ``forward_test`` at ×6 with a
  test_cfg without ``tile`` (a full-image ``predict``) against JAX.
- ``csa_stencil.wide_blocks``, the wide CSA pair's plan of row blocks:
  every output row in one block, each block's scores within its budget.
- With the card's dtype rule in place, what each wrapper receives at 180
  channels, and the rational wrapper's rejection of an uncompiled width
  on tensors of the ``meta`` device.

Tolerances: f32 against JAX ≤ 1e-5 abs; the padded chains ≤ 1e-6 abs
(only zero terms differ); the bf16-fed route ≤ 1e-2 of max|ref| (the class
the card holds).
"""

from fractions import Fraction


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ciaosr_torch.convert.from_jax import state_dict_from_jax
from ciaosr_torch.core.coords import make_coord_cell
from ciaosr_torch.models import csa as mcsa
from ciaosr_torch.models.builder import build_generator
from ciaosr_torch.models.ciaosr import rational_cell
from ciaosr_torch.models.csa import csa_route
from ciaosr_torch.models.restorers import CiaoSRRestorer
from ciaosr_torch.ops import kernels
from ciaosr_torch.ops.kernels import csa_stencil as st
from ciaosr_torch.ops.kernels import decoder as dk
from tests.test_torch_swinir_csa import _cut
from tests.test_torch_weights import generator_params, jax_query_rgb

TOL = 1e-5
REL_TOL = 1e-2
BF, F32 = torch.bfloat16, torch.float32
CFG = _cut(180, (1,), (6,), [256] * 4)
C, CR = 180, 90
# LR sizes: 10 × 9 reflect-pads to 10 × 10 in the CSA (streaming: row 7
# on the banks) and decodes at the odd width 9 (row 9 on the card);
# 16 × 16 takes the stencil form (K4) and decodes at W % 8 = 0
STREAMING, STENCIL = (10, 9), (16, 16)
MEAN = np.asarray((0.4488, 0.4371, 0.4040), np.float32)


@pytest.fixture(scope="module")
def nets():
    jnet, params = generator_params(CFG, seed=C)
    pnet = build_generator(CFG, device="cpu")
    pnet.load_state_dict(state_dict_from_jax(
        params, feat_dim=C, n_hidden=4, encoder="swinir",
        non_local_attn=True), strict=True)
    feat_fn = jax.jit(lambda p, x: jnet.apply(p, x, method="gen_feature"))
    nl_fn = jax.jit(lambda p, f: jnet.apply(p, f, method="nl_feature"))
    return jnet, params, pnet, feat_fn, nl_fn


def _lr(hw, seed):
    return np.random.default_rng(seed).random((1, *hw, 3), dtype=np.float32)


def test_padded_widths():
    assert st.padded_widths(CR, C) == (96, 192)
    assert st.padded_widths(32, 64) == (32, 64)
    assert dk.padded_widths(C, C) == (192, 192)
    assert dk.padded_widths(C, 0) == (192, 0)
    assert dk.padded_widths(64, 64) == (64, 64)
    for hw, mode in ((STREAMING, "streaming"), (STENCIL, "stencil_fused")):
        hp, wp = (-(-n // 2) * 2 for n in hw)
        assert csa_route(hp, wp, 2, C, CR, 4) == mode


@pytest.mark.parametrize("hw", [STREAMING, STENCIL],
                         ids=["streaming", "stencil_fused"])
def test_padded_csa_kernel_route_matches_jax(nets, hw):
    """The kernel route pads match, keys and embed and crops the output;
    on CPU tensors each kernel's plain version computes at the padded
    widths."""
    _, params, pnet, _, nl_fn = nets
    feat = np.random.default_rng(hw[1]).standard_normal(
        (1, *hw, C)).astype(np.float32)
    ref = np.asarray(nl_fn(params, jnp.asarray(feat)))
    seen = {}

    def spy(name):
        fn = getattr(mcsa, name)

        def wrapped(*a):
            seen[name] = tuple(t.shape[-1] for t in a[:3])
            return fn(*a)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        for name in ("csa_stencil_fused", "csa_attention"):
            mp.setattr(mcsa, name, spy(name))
        with torch.no_grad():
            got = pnet.nl_feature(torch.from_numpy(feat), True).numpy()
    want = ({"csa_attention": (9 * 96, 9 * 96, 36 * 192)}
            if hw == STREAMING else {"csa_stencil_fused": (96, 9 * 96, 192)})
    assert seen == want
    assert got.shape == ref.shape == (1, *hw, C)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("hw", [STREAMING, STENCIL],
                         ids=["odd_width", "even_width"])
def test_grid_decode_kernel_route_matches_jax_gather(nets, hw):
    """×4 through the CSA kernel route and K1 → K2 → K3 (plain versions on
    CPU tensors, at (C, DC) = (192, 192)) against JAX's per-query decoder
    over every HR pixel, with JAX's own CSA."""
    jnet, params, pnet, feat_fn, nl_fn = nets
    x = _lr(hw, 3)
    feat = feat_fn(params, jnp.asarray(x))
    th, tw = 4 * hw[0], 4 * hw[1]
    co, ce = (t.numpy()[None] for t in make_coord_cell((th, tw)))
    ref = jax_query_rgb(jnet, params, feat, x, co, ce,
                        nl_fn(params, feat)).reshape(1, th, tw, 3)
    widths = []
    k1 = dk.f3p_build

    def spy(feature, csa, *rest):
        widths.append(dk.widths(feature, csa))
        return k1(feature, csa, *rest)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dk, "f3p_build", spy)
        with torch.no_grad():
            got = pnet.query_rgb_grid_kernels(
                torch.from_numpy(np.array(feat)), torch.from_numpy(x),
                4).numpy()
    assert widths == [(192, 192)]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_pack_decoder_dc_pad_changes_nothing(nets):
    """The plain K1 → K2 → K3 chain on the maps zero-padded to (192, 192)
    with the padded packing equals the chain at 180 channels; the padded
    rows and columns are zero."""
    _, _, pnet, _, _ = nets
    rng = np.random.default_rng(5)
    feat = torch.as_tensor(rng.standard_normal((1, 6, 7, C)), dtype=F32)
    csa = torch.as_tensor(rng.standard_normal((1, 6, 7, C)), dtype=F32)
    tabs = dk.decoder_tables(4, 6, 7, pnet.local_size, "cpu")
    mlps = (pnet.imnet_k, pnet.imnet_v, pnet.imnet_q)

    def chain(f, m, pk):
        gk, gv = dk.f3p_build_plain(f, m, pk["wk0"], pk["wvu"], pk["wvc"])
        wt, ck = dk.wt_hoist_plain(f, pk["wkout"], pk["bkout"])
        return dk.grid_decode_plain(f, m, gk, gv, wt, ck, pk, tabs,
                                    pnet.softmax_scale)

    with torch.no_grad():
        pk = dk.pack_decoder(*mlps, C, (0.5, 0.5), F32)
        pkp = dk.pack_decoder(*mlps, C, (0.5, 0.5), F32, c_pad=192,
                              dc_pad=192)
        ref = chain(feat, csa, pk)
        got = chain(F.pad(feat, (0, 12)), F.pad(csa, (0, 12)), pkp)
    assert pkp["wvc"].shape == (192, 256) and pkp["vout"].shape[1] == 1920
    assert pkp["qw0"].shape[0] == 1920 and pkp["vbout"].shape == (1920,)
    for key, rows in (("wvc", slice(C, 192)), ("qw0", slice(1728 + C, None)),
                      ("vbout", slice(1728 + C, None))):
        assert not pkp[key][rows].any(), key
    assert not pkp["vout"][:, 1728 + C:].any()
    torch.testing.assert_close(pkp["wvc"][:C], pk["wvc"], rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6, rtol=0)


def test_pack_decoder_flagship_widths_unpadded():
    """At (C, DC) = (64, 64) the padding arguments give the same tensors
    as none."""
    from tests.test_torch_weights import FLAGSHIP
    net = build_generator(FLAGSHIP, device="cpu", seed=3)
    mlps = (net.imnet_k, net.imnet_v, net.imnet_q)
    pk = dk.pack_decoder(*mlps, 64, (0.5, 0.5), BF)
    pkp = dk.pack_decoder(*mlps, 64, (0.5, 0.5), BF, c_pad=64, dc_pad=64)
    assert pk.keys() == pkp.keys()
    for k in pk:
        assert torch.equal(pk[k], pkp[k]), k


class _Recorder:
    """Wraps wrappers the models call: each call records the trailing
    widths and dtypes of its tensor arguments under the wrapper's name."""

    def __init__(self, mp):
        self.mp, self.calls = mp, {}

    def wrap(self, mod, name, n_args):
        fn = getattr(mod, name)

        def rec(*a, **k):
            self.calls.setdefault(name, []).append(tuple(
                None if t is None else (t.shape[-1], t.dtype)
                for t in a[:n_args]))
            return fn(*a, **k)
        self.mp.setattr(mod, name, rec)


@pytest.mark.parametrize("hw,middle,csa_in", [
    (STENCIL, "csa_stencil_fused", (96, 864, 192)),
    (STREAMING, "csa_attention", (864, 864, 6912))],
    ids=["stencil_fused", "streaming"])
def test_card_rule_hands_the_wide_kernels_bf16(monkeypatch, hw, middle,
                                               csa_in):
    """With the card's rule (bf16 whatever the model dtype) an f32 model of
    config 001 swinir hands the CSA wrapper bf16 maps at the padded
    widths and K1-K3 bf16 maps at (C, DC) = (192, 192); its output stays
    within the bf16 class of the f32 plain route."""
    monkeypatch.setattr(kernels, "route_dtype", lambda device, dtype: BF)
    net = build_generator(dict(CFG, use_kernels=True), device="cpu",
                          seed=17)
    assert net.dtype == F32
    rec = _Recorder(monkeypatch)
    rec.wrap(mcsa, middle, 3)
    for name in ("f3p_build", "grid_decode"):
        rec.wrap(dk, name, 2)
    rec.wrap(dk, "wt_hoist", 1)
    x = torch.as_tensor(_lr(hw, 9)) - 0.45
    with torch.no_grad():
        got = net.decode_grid(x, 4)
        net.use_kernels = False
        try:
            ref = net.decode_grid(x, 4)
        finally:
            net.use_kernels = True
    assert rec.calls == {
        middle: [tuple((w, BF) for w in csa_in)],
        "f3p_build": [((192, BF), (192, BF))],
        "wt_hoist": [((192, BF),)],
        "grid_decode": [((192, BF), (192, BF))]}
    assert got.shape == ref.shape == (1, 4 * hw[0], 4 * hw[1], 3)
    assert float((got - ref).abs().max() / ref.abs().max()) <= REL_TOL


def _meta(*shape, dtype=BF):
    return torch.empty(*shape, device="meta", dtype=dtype)


def test_rational_decode_rejects_uncompiled_widths():
    """K3's rational mode takes every compiled (C, DC) pair; at another
    its wrapper raises, naming the compiled pairs, before any launch."""
    b, h, w, n = 1, 4, 6, 4
    maps = (_meta(b, h, w, 96), None, _meta(b, h, w, 256),
            _meta(b, h, w, 256), _meta(9, b, h, w, 256),
            _meta(9, b, h, w, dtype=F32))
    tabs = {"yk": _meta(5, n, 2, dtype=torch.int32),
            "xk": _meta(5, n, 3, dtype=torch.int32)}
    n0 = kernels.LAUNCHES["grid_decode_rational"]
    with pytest.raises(ValueError, match="compiled for"):
        dk.grid_decode_rational(*maps, {}, tabs, 1.0)
    assert kernels.LAUNCHES["grid_decode_rational"] == n0


def _jax_grid(nets, x, th, tw):
    """JAX's per-query decode of x (B, h, w, 3) over the th × tw HR grid,
    with JAX's own features and CSA: (B, th, tw, 3), and the features."""
    jnet, params, _, feat_fn, nl_fn = nets
    feat = feat_fn(params, jnp.asarray(x))
    co, ce = (t.numpy()[None] for t in make_coord_cell((th, tw)))
    ref = jax_query_rgb(jnet, params, feat, x, co, ce, nl_fn(params, feat))
    return ref.reshape(x.shape[0], th, tw, 3), feat


# (py, qy, LR H × W): 7/3 needs 3 | H and 3 | W, so 18 × 30 there
@pytest.mark.parametrize("py,qy,hw", [(5, 2, (16, 32)), (7, 3, (18, 30))],
                         ids=["x2.5", "x7/3"])
def test_rational_kernel_route_matches_jax_gather(nets, py, qy, hw):
    """The rational dense decode through the CSA kernel route and K1 → K2
    → K3's rational mode (plain versions on CPU tensors, the decoder maps
    padded to (192, 192)) against JAX's per-query decoder over every HR
    pixel, with JAX's own CSA."""
    pnet = nets[2]
    x = _lr(hw, py)
    th, tw = hw[0] * py // qy, hw[1] * py // qy
    ref, feat = _jax_grid(nets, x, th, tw)
    widths = []
    k3 = dk.grid_decode_rational

    def spy(feature, csa, *rest):
        widths.append(dk.widths(feature, csa))
        return k3(feature, csa, *rest)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dk, "grid_decode_rational", spy)
        with torch.no_grad():
            got = pnet.query_rgb_grid_rational_kernels(
                torch.from_numpy(np.array(feat)), torch.from_numpy(x), py,
                qy, py, qy).numpy()
    assert widths == [(192, 192)]
    assert got.shape == ref.shape == (1, th, tw, 3)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_padded_rational_decode_changes_nothing(nets):
    """K3's rational plain version on the maps zero-padded to (192, 192)
    with the padded packing equals it at 180 channels (×2.5)."""
    pnet = nets[2]
    rng = np.random.default_rng(6)
    h, w = 6, 8
    feat = torch.as_tensor(rng.standard_normal((1, h, w, C)), dtype=F32)
    csa = torch.as_tensor(rng.standard_normal((1, h, w, C)), dtype=F32)
    tabs = dk.rational_tables(h, w, 5, 2, 5, 2, pnet.local_size, "cpu")
    cell = rational_cell(h, w, h * 5 // 2, w * 5 // 2)
    mlps = (pnet.imnet_k, pnet.imnet_v, pnet.imnet_q)

    def chain(f, m, pk):
        gk, gv = dk.f3p_build_plain(f, m, pk["wk0"], pk["wvu"], pk["wvc"])
        wt, ck = dk.wt_hoist_plain(f, pk["wkout"], pk["bkout"])
        return dk.grid_decode_rational_plain(f, m, gk, gv, wt, ck, pk, tabs,
                                             pnet.softmax_scale)

    with torch.no_grad():
        ref = chain(feat, csa, dk.pack_decoder(*mlps, C, cell, F32))
        got = chain(F.pad(feat, (0, 12)), F.pad(csa, (0, 12)),
                    dk.pack_decoder(*mlps, C, cell, F32, c_pad=192,
                                    dc_pad=192))
    assert got.shape == ref.shape == (1, 25, h // 2, w // 2, 3)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6, rtol=0)


def test_full_image_forward_test_x6_matches_jax(nets):
    """The config's protocol for val_scale > 4: its test_cfg has no tile,
    so ``forward_test`` at ×6 is a full-image ``predict``, here through
    the kernel route (the integer decode at 36 phases, K3 at (192, 192))
    against JAX's per-query decoder, denormalized and clamped."""
    pnet = nets[2]
    restorer = CiaoSRRestorer(
        dict(CFG, use_kernels=True), rgb_mean=tuple(MEAN),
        test_cfg=dict(metrics=["PSNR", "SSIM"], crop_border=6, scale=6,
                      convert_to="y"), device="cpu")
    restorer.generator.load_state_dict(pnet.state_dict(), strict=True)
    lq = _lr((8, 10), 11)[0]
    ref, _ = _jax_grid(nets, lq[None] - MEAN, 48, 60)
    got = restorer.forward_test(lq)
    assert got.shape == (48, 60, 3)
    np.testing.assert_allclose(got, np.clip(ref[0] + MEAN, 0, 1), atol=TOL,
                               rtol=0)


# (B, Hp, Wp, budget in bytes): one block where the map fits, blocks of
# 8-row query tiles, single rows where a tile's band does not fit, a
# budget below one row's band, B > 1; ldS = ⌈L/4⌉·4 (L = Hp·Wp/4)
@pytest.mark.parametrize("b,hp,wp,budget", [
    (1, 192, 192, 2 << 30),     # a 192² tile: 1.27 GiB, one block
    (1, 192, 512, 2 << 30),     # 9.0 GiB: five blocks of 40 rows or less
    (1, 192, 512, 1 << 30),
    (1, 48, 1024, 2 << 30),     # 2.25 GiB: two blocks
    (1, 536, 304, 2 << 30),
    (2, 40, 24, 40_000),        # under one tile's band: single rows
    (1, 6, 18, 1_000),          # under one row's band: one row a block
    (3, 34, 22, 400_000),
], ids=["192x192", "192x512", "192x512_1GiB", "48x1024", "536x304",
        "B2_rows", "under_a_row", "B3_34x22"])
def test_wide_blocks_cover_rows_within_budget(b, hp, wp, budget):
    blocks = st.wide_blocks(b, hp, wp, budget)
    row_bytes = 4 * b * st.scores_stride(hp, wp)
    assert row_bytes == 4 * b * (-(-(hp // 2) * (wp // 2) // 4) * 4)
    # every output row in exactly one block, in order, none empty
    assert blocks[0][0] == 0 and blocks[-1][1] == hp
    assert all(y1 > y0 for y0, y1 in blocks)
    assert all(a[1] == c[0] for a, c in zip(blocks, blocks[1:]))
    for y0, y1 in blocks:
        q0, q1 = st.wide_band(hp, wp, y0, y1)
        # the band holds the attention rows y0 - 1 .. y1 of the stencil
        assert q0 <= max(y0 - 1, 0) * wp and q0 % st.SCORES_CTA == 0
        assert q1 == min(y1 + 1, hp) * wp
        if y1 - y0 > 1:
            assert (q1 - q0) * row_bytes <= budget
    whole = st.wide_band(hp, wp, 0, hp)
    if (whole[1] - whole[0]) * row_bytes <= budget:
        assert blocks == [(0, hp)]
    else:
        assert len(blocks) > 1
        tile_band = st.wide_band(hp, wp, st.TILE, 2 * st.TILE)
        if 2 * st.TILE <= hp and (tile_band[1] - tile_band[0]) * row_bytes \
                <= budget:
            # tile rows: every block but the last starts a query tile
            assert all(y0 % st.TILE == 0 for y0, _ in blocks)
            assert all((y1 - y0) % st.TILE == 0 for y0, y1 in blocks[:-1])


@pytest.mark.parametrize("hw,n", [((192, 512), 5), ((48, 1024), 2),
                                  ((192, 192), 1)],
                         ids=["192x512", "48x1024", "192x192"])
def test_wide_blocks_at_the_path_geometries(hw, n):
    """The blocks of chip_smoke.py's geometries at the default 2 GiB: the
    192×512 (row 6) and 48×1024 (row 5) full images and the 192² tile
    (K4, one launch, as before blocking)."""
    assert len(st.wide_blocks(1, *hw)) == n
