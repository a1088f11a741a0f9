"""SwinIR-CiaoSR without the unfold (``feat_unfold=False``, LIIF's "-u"
ablation) at its real 180 channels on the CPU, against the JAX package,
f32, one weight set through state_dict_from_jax(encoder="swinir",
feat_unfold=False): the 002 generator (no CSA) and config 001 swinir's
(CSA at Cr = 90), each cut to one Swin block.

- The ×4 integer grid and the ×2.5 rational grid, on the plain route and
  on the kernel route (the plain one-tap K1 → K2 → K3 or its rational
  mode, on CPU tensors, the decoder maps zero-padded to (C, DC) =
  (192, 0) or (192, 192)), against JAX's per-query ``query_rgb`` over
  every HR pixel.
- The padded one-tap chain (``pack_decoder(c_pad=192, dc_pad=...)`` on
  maps padded to 192) equals the chain at 180 channels.
- ``forward_test`` (tiled, ×4 and ×2.5) on the kernel route against
  JAX's.

Tolerances: ≤ 1e-5 abs against JAX; ≤ 1e-6 abs between the padded and
unpadded chains (only zero terms differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ciaosr_torch.convert.from_jax import state_dict_from_jax
from ciaosr_torch.core.coords import make_coord_cell
from ciaosr_torch.models.builder import build_generator
from ciaosr_torch.models.ciaosr import rational_cell
from ciaosr_torch.models.restorers import CiaoSRRestorer
from ciaosr_torch.ops.kernels import decoder as dk
from ciaosr_tpu.models.restorers import CiaoSRRestorer as JaxRestorer
from tests.test_torch_nla import SWIN_002
from tests.test_torch_swinir_csa import _cut
from tests.test_torch_weights import generator_params, jax_query_rgb

TOL = 1e-5
F32 = torch.float32
C = 180
# each generator dict as its config writes it, cut to one Swin block of
# the real 180 channels (tuples: flax modules are hashed as static
# arguments), without the unfold
GENERATORS = {
    "002": dict(SWIN_002, encoder=dict(SWIN_002["encoder"], depths=(1,),
                                       num_heads=(6,)), feat_unfold=False),
    "001_csa": dict(_cut(C, (1,), (6,), [256] * 4), feat_unfold=False),
}
MEAN = np.asarray((0.4488, 0.4371, 0.4040), np.float32)


@pytest.fixture(scope="module", params=list(GENERATORS))
def nets(request):
    """(name, JAX net, params, plain port generator, kernel-route port
    generator, jitted gen_feature, jitted nl_feature or None)."""
    cfg = GENERATORS[request.param]
    csa = cfg.get("non_local_attn", True)
    jnet, params = generator_params(cfg, seed=C + csa)
    sd = state_dict_from_jax(params, feat_dim=C, n_hidden=4, encoder="swinir",
                             non_local_attn=csa, feat_unfold=False)
    plain = build_generator(cfg, device="cpu")
    routed = build_generator(dict(cfg, use_kernels=True), device="cpu")
    for net in (plain, routed):
        net.load_state_dict(sd, strict=True)
        assert net.taps == 1
    feat_fn = jax.jit(lambda p, x: jnet.apply(p, x, method="gen_feature"))
    nl_fn = jax.jit(lambda p, f: jnet.apply(p, f, method="nl_feature")) \
        if csa else None
    return request.param, jnet, params, plain, routed, feat_fn, nl_fn


def _lr(hw, seed):
    return np.random.default_rng(seed).random((1, *hw, 3), dtype=np.float32)


def _jax_grid(nets, x, th, tw):
    """JAX's per-query decode of x over the th × tw HR grid (before the
    denorm), and JAX's features."""
    _, jnet, params, _, _, feat_fn, nl_fn = nets
    feat = feat_fn(params, jnp.asarray(x))
    co, ce = (t.numpy()[None] for t in make_coord_cell((th, tw)))
    nl = nl_fn(params, feat) if nl_fn else None
    ref = jax_query_rgb(jnet, params, feat, x, co, ce, nl)
    return ref.reshape(1, th, tw, 3), feat


def test_one_tap_widths_pad_to_192():
    assert dk.padded_widths(C, 0, 1) == (192, 0)
    assert dk.padded_widths(C, C, 1) == (192, 192)
    assert (192, 0, 1) in dk.INSTANCES and (192, 192, 1) in dk.INSTANCES


# (scale, LR H × W): ×4 at an even and an odd LR width (row 9 on the
# card), ×2.5 (row 10) on 16 × 16 (2 | H, W)
@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("scale,hw", [(4, (12, 16)), (4, (10, 9)),
                                      ("5/2", (16, 16))],
                         ids=["x4", "x4_odd_width", "x2.5"])
def test_grid_matches_jax_gather(nets, route, scale, hw):
    """The dense decode (integer or rational) on the plain route, or on
    the kernel route through the plain one-tap K1 → K2 → K3 at the padded
    widths, against JAX's per-query decoder with JAX's own features and
    CSA."""
    name, _, _, plain, routed, _, _ = nets
    x = _lr(hw, len(name) + hw[1])
    rational = scale == "5/2"
    th, tw = ((hw[0] * 5 // 2, hw[1] * 5 // 2) if rational
              else (4 * hw[0], 4 * hw[1]))
    ref, feat = _jax_grid(nets, x, th, tw)
    ft, xt = torch.from_numpy(np.array(feat)), torch.from_numpy(x)
    widths, packed = [], []
    k1 = dk.f3p_build

    def spy(feature, csa, wk0, *rest):
        widths.append(dk.widths(feature, csa))
        packed.append(tuple(wk0.shape))
        return k1(feature, csa, wk0, *rest)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dk, "f3p_build", spy)
        with torch.no_grad():
            if route == "plain" and rational:
                got = plain.query_rgb_grid_rational(ft, xt, 5, 2, 5, 2)
            elif route == "plain":
                got = plain.query_rgb_grid(ft, xt, 4)
            elif rational:
                got = routed.query_rgb_grid_rational_kernels(ft, xt, 5, 2, 5,
                                                             2)
            else:
                got = routed.query_rgb_grid_kernels(ft, xt, 4)
    want = [] if route == "plain" else [(192, 192 if "csa" in name else 0)]
    assert widths == want
    assert packed == [(192, 256)] * len(want)
    assert got.shape == ref.shape == (1, th, tw, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("rational", [False, True], ids=["x4", "x2.5"])
def test_padded_one_tap_chain_changes_nothing(nets, rational):
    """The plain one-tap K1 → K2 → K3 (or its rational mode) on maps
    zero-padded to 192 channels with the padded packing equals the chain
    at 180; the padded rows and columns are zero."""
    name, _, _, plain, _, _, _ = nets
    rng = np.random.default_rng(5 + rational)
    h, w = 6, 8
    feat = torch.as_tensor(rng.standard_normal((1, h, w, C)), dtype=F32)
    csa = torch.as_tensor(rng.standard_normal((1, h, w, C)), dtype=F32) \
        if "csa" in name else None
    dc, dcp = (C, 192) if csa is not None else (0, 0)
    if rational:
        tabs = dk.rational_tables(h, w, 5, 2, 5, 2, plain.local_size, "cpu")
        cell = rational_cell(h, w, h * 5 // 2, w * 5 // 2)
        decode = dk.grid_decode_rational_plain
    else:
        tabs = dk.decoder_tables(4, h, w, plain.local_size, "cpu")
        cell = (0.5, 0.5)
        decode = dk.grid_decode_plain
    mlps = (plain.imnet_k, plain.imnet_v, plain.imnet_q)

    def chain(f, m, pk):
        gk, gv = dk.f3p_build_plain(f, m, pk["wk0"], pk["wvu"], pk["wvc"])
        wt, ck = dk.wt_hoist_plain(f, pk["wkout"], pk["bkout"])
        return decode(f, m, gk, gv, wt, ck, pk, tabs, plain.softmax_scale)

    def pad(t):
        return None if t is None else F.pad(t, (0, 12))

    with torch.no_grad():
        pk = dk.pack_decoder(*mlps, C, cell, F32)
        pkp = dk.pack_decoder(*mlps, C, cell, F32, c_pad=192, dc_pad=dcp)
        ref = chain(feat, csa, pk)
        got = chain(pad(feat), pad(csa), pkp)
    dv = 192 + dcp
    assert pkp["wk0"].shape == pkp["wkout"].shape == (192, 256)
    assert pkp["vout"].shape == (256, dv) and pkp["qw0"].shape == (dv, 256)
    for key in ("wk0", "wvu", "wkout", "qw0"):
        assert not pkp[key][C:192].any(), key
    assert not pkp["vout"][:, C:192].any() and not pkp["bkout"][C:].any()
    if dc:
        assert not pkp["wvc"][C:].any() and not pkp["qw0"][192 + C:].any()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("scale", [4, 2.5], ids=["x4", "x2.5"])
def test_forward_test_matches_jax(nets, scale):
    """``forward_test`` with tiles of 16 (overlap 4) over a 24 × 20 image,
    through the kernel route (the plain one-tap versions on CPU tensors),
    against JAX's ``forward_test`` of the same test_cfg."""
    name, _, params, _, routed, _, _ = nets
    cfg = GENERATORS[name]
    test_cfg = dict(metrics=[], crop_border=4, scale=4, tile=16,
                    tile_overlap=4)
    restorer = CiaoSRRestorer(dict(cfg, use_kernels=True),
                              rgb_mean=tuple(MEAN), test_cfg=test_cfg,
                              device="cpu")
    restorer.generator.load_state_dict(routed.state_dict(), strict=True)
    jres = JaxRestorer(cfg, rgb_mean=tuple(MEAN), test_cfg=test_cfg)
    lq = _lr((24, 20), 7)[0]
    ref = np.asarray(jres.forward_test(params, lq, scale=scale))
    got = restorer.forward_test(lq, scale=scale)
    assert got.shape == ref.shape == (round(24 * scale), round(20 * scale), 3)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
