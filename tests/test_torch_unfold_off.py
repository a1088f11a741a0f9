"""The decode without the unfold (``feat_unfold=False``: keys, values and
queries are the feature pixel, C wide) in the port against the JAX
package, f32, the same weights, on config 001 edsr's generator at test
dims (16 channels, CSA on).

No JAX test covers this mode; JAX's per-query ``query_rgb`` is the
oracle (ROADMAP rule 3), its XLA dense decodes agree with it. Held at
≤ 1e-5 abs: ``query_rgb`` (random queries and a grid); the plain integer
grid at ×2 and ×3 and the rational grid at ×5/2, each also on the kernel
route on CPU tensors (the plain one-tap versions of K1, K2, K3 and its
rational mode), against the per-query decode of the same HR grid; K1's
and K2's plain one-tap versions against the same products computed with
jnp from the JAX params; the training forward and the L1 loss. The slow
lane holds the kernel route against JAX's Pallas decodes in interpret
mode (bf16 inside: the bf16 class) and the rational grid against JAX's
own ``query_rgb_grid_rational``. The one-tap widths without an instance
raise before any launch."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciaosr_torch.convert.from_jax import state_dict_from_jax
from ciaosr_torch.core.coords import make_coord_cell
from ciaosr_torch.models.restorers import CiaoSRRestorer
from ciaosr_torch.ops import kernels
from ciaosr_torch.ops.kernels import decoder as dk
from ciaosr_tpu.models.restorers import CiaoSRRestorer as JaxRestorer
from tests.test_torch_edsr import EDSR_SMALL
from tests.test_torch_weights import generator_params, jax_query_rgb

U1 = dict(EDSR_SMALL, feat_unfold=False)
C = 16


@pytest.fixture(scope="module")
def nets():
    """(JAX net, params, plain port restorer, kernel-route port restorer)
    with one weight set."""
    jnet, params = generator_params(U1, seed=11)
    sd = state_dict_from_jax(params, feat_dim=C, n_hidden=2, encoder="edsr",
                             feat_unfold=False)
    plain = CiaoSRRestorer(U1, device="cpu")
    routed = CiaoSRRestorer(dict(U1, use_kernels=True), device="cpu")
    for r in (plain, routed):
        r.generator.load_state_dict(sd, strict=True)
        assert r.generator.taps == 1
    return jnet, params, plain, routed


_feat = jax.jit(lambda net, p, x: net.apply(p, x, method="gen_feature"),
                static_argnums=0)
_nl = jax.jit(lambda net, p, f: net.apply(p, f, method="nl_feature"),
              static_argnums=0)


def _jax_grid(nets, x, th, tw):
    """JAX's per-query decode of x (B, h, w, 3) over the th × tw HR grid:
    (B, th, tw, 3) before denorm, and JAX's features."""
    jnet, params = nets[:2]
    feat = _feat(jnet, params, jnp.asarray(x))
    co, ce = (t.numpy() for t in make_coord_cell((th, tw)))
    b = x.shape[0]
    coord = np.broadcast_to(co, (b, th * tw, 2)).copy()
    cell = np.broadcast_to(ce, (b, th * tw, 2)).copy()
    out = jax_query_rgb(jnet, params, feat, x, coord, cell,
                        _nl(jnet, params, feat))
    return out.reshape(b, th, tw, 3), feat


@pytest.mark.parametrize("kind", ["random", "grid_17x13"])
def test_query_rgb_matches_jax(nets, kind):
    jnet, params, plain, _ = nets
    x = np.random.default_rng(4).random((2, 9, 8, 3), dtype=np.float32)
    rng = np.random.default_rng(6)
    if kind == "random":
        coord = rng.uniform(-1, 1, (2, 64, 2)).astype(np.float32)
        cell = np.stack([np.full((64, 2), 0.11, np.float32),
                         np.full((64, 2), 0.07, np.float32)])
    else:
        co, ce = make_coord_cell((17, 13))
        coord = np.broadcast_to(co.numpy(), (2, 17 * 13, 2)).copy()
        cell = np.broadcast_to(ce.numpy(), (2, 17 * 13, 2)).copy()
    feat = _feat(jnet, params, jnp.asarray(x))
    ref = jax_query_rgb(jnet, params, feat, x, coord, cell,
                        _nl(jnet, params, feat))
    with torch.no_grad():
        got = plain.generator.query_rgb(
            torch.from_numpy(np.array(feat)), torch.from_numpy(x),
            torch.from_numpy(coord), torch.from_numpy(cell)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("scale", [2, 3])
def test_integer_grid_matches_jax_gather(nets, scale):
    """The plain dense decode and the kernel route's plain one-tap K1 →
    K2 → K3 at an odd width (W = 9, K3's row-9 geometry)."""
    _, _, plain, routed = nets
    x = np.random.default_rng(scale).random((1, 10, 9, 3), dtype=np.float32)
    ref, feat = _jax_grid(nets, x, 10 * scale, 9 * scale)
    ft, xt = torch.from_numpy(np.array(feat)), torch.from_numpy(x)
    with torch.no_grad():
        got = plain.generator.query_rgb_grid(ft, xt, scale).numpy()
        n0 = dict(kernels.LAUNCHES)
        got_k = routed.generator.query_rgb_grid_kernels(ft, xt,
                                                        scale).numpy()
    assert kernels.LAUNCHES == n0   # CPU tensors: the plain versions
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_k, ref, atol=1e-5, rtol=0)


def test_rational_grid_matches_jax_gather(nets):
    """×5/2 on 10 × 8 (25 phases of 5 × 4; ×2.5 has tie rows): the plain
    rational decode and the kernel route (one-tap row 10's plain
    version)."""
    _, _, plain, routed = nets
    x = np.random.default_rng(7).random((1, 10, 8, 3), dtype=np.float32)
    ref, feat = _jax_grid(nets, x, 25, 20)
    ft, xt = torch.from_numpy(np.array(feat)), torch.from_numpy(x)
    with torch.no_grad():
        got = plain.generator.query_rgb_grid_rational(ft, xt, 5, 2, 5,
                                                      2).numpy()
        got_k = routed.generator.query_rgb_grid_rational_kernels(
            ft, xt, 5, 2, 5, 2).numpy()
        got_d = routed.generator.decode_grid(xt, Fraction(5, 2)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_k, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_d, ref, atol=1e-5, rtol=0)


def test_plain_one_tap_kernels_match_jax(nets):
    """K1 (g_k = f@W_k0, g_v = f@W_vu + csa@W_vc) and K2 (wt_d, ck_d of
    f ⊙ f[clamp(p + d)] for the nine shifts) at one tap, the packed port
    weights against the JAX params' own matrices (no permutation without
    the unfold); the rel and cell rows of the first layers stay out of
    the packed products."""
    jnet, params, plain, _ = nets
    x = np.random.default_rng(9).random((1, 7, 11, 3), dtype=np.float32)
    feat = _feat(jnet, params, jnp.asarray(x))
    csa = _nl(jnet, params, feat)
    p = params["params"]
    k0, v0 = p["imnet_k"]["layers_0"], p["imnet_v"]["layers_0"]
    kout = p["imnet_k"]["out"]
    ref_gk = feat @ k0["kernel"][:C]
    ref_gv = jnp.concatenate([feat, csa], -1) @ v0["kernel"][:2 * C]
    f = jnp.pad(feat, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    h, w = feat.shape[1:3]
    ref_wt, ref_ck = [], []
    for dy, dx in dk.SHIFTS9:
        qk = feat * f[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        ref_wt.append(qk @ kout["kernel"].T)
        ref_ck.append(qk @ kout["bias"])
    net = plain.generator
    pk = dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, C,
                         (0.5, 0.5), torch.float32)
    assert pk["wk0"].shape == (C, 32) and pk["vout"].shape[1] == 2 * C
    ft = torch.from_numpy(np.array(feat))
    with torch.no_grad():
        gk, gv = dk.f3p_build(ft, torch.from_numpy(np.array(csa)), pk["wk0"],
                              pk["wvu"], pk["wvc"])
        wt, ck = dk.wt_hoist(ft, pk["wkout"], pk["bkout"])
    for got, ref in ((gk, ref_gk), (gv, ref_gv), (wt, jnp.stack(ref_wt)),
                     (ck, jnp.stack(ref_ck))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)


def test_train_forward_matches_jax(nets):
    """The training decoder (per query, plain CSA) and the normalized L1
    objective on a batch of 2 × 9 × 8 LR with random HR queries."""
    jnet, params, plain, _ = nets
    rng = np.random.default_rng(13)
    lq = rng.random((2, 9, 8, 3), dtype=np.float32)
    gt = rng.random((2, 48, 3), dtype=np.float32)
    coord = rng.uniform(-1, 1, (2, 48, 2)).astype(np.float32)
    cell = np.full((2, 48, 2), 2 / 27, np.float32)
    loss_ref, pred_ref = jax.jit(JaxRestorer(U1).train_forward)(
        params, *(jnp.asarray(a) for a in (lq, gt, coord, cell)))
    loss, pred = plain.train_forward(*(torch.from_numpy(a)
                                       for a in (lq, gt, coord, cell)))
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(pred_ref),
                               atol=1e-5, rtol=0)
    assert abs(float(loss.detach()) - float(loss_ref)) <= 1e-5
    loss.backward()
    assert all(q.grad is not None for q in plain.generator.parameters())
    plain.generator.zero_grad(set_to_none=True)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, device="meta", dtype=dtype)


def test_one_tap_widths_without_instance_raise():
    """The one-tap instance is (C, DC) = (64, 64); every other one-tap
    width raises before any launch, naming its ROADMAP.md item."""
    assert dk.padded_widths(C, C, 1) == (64, 64)
    assert dk.padded_widths(64, 64, 1) == (64, 64)
    assert dk.padded_widths(180, 180, 1) == (180, 180)
    assert dk.padded_widths(180, 180) == (192, 192)
    n0 = dict(kernels.LAUNCHES)
    for c, dc in ((192, 192), (192, 0)):
        csa = _meta(1, 4, 6, dc) if dc else None
        with pytest.raises(ValueError, match="queue 2 item 3"):
            dk.f3p_build(_meta(1, 4, 6, c), csa, _meta(c, 256),
                         _meta(c, 256), _meta(dc, 256))
        with pytest.raises(ValueError, match="queue 2 item 3"):
            dk.wt_hoist(_meta(1, 4, 6, c), _meta(c, 256),
                        _meta(c, dtype=torch.float32))
        pk = {"wk0": _meta(c, 256)}
        maps = (_meta(1, 4, 6, c), csa) + (None,) * 4
        for fn in (dk.grid_decode, dk.grid_decode_rational):
            with pytest.raises(ValueError, match="queue 2 item 3"):
                fn(*maps, pk, {"dys": _meta(16, 4, dtype=torch.int32),
                               "yk": _meta(5, 4, 2, dtype=torch.int32),
                               "xk": _meta(5, 4, 3, dtype=torch.int32)},
                   1.0)
    with pytest.raises(ValueError, match="want 9C or C"):
        dk.f3p_build(_meta(1, 4, 6, 64), _meta(1, 4, 6, 64),
                     _meta(3 * 64, 256), _meta(3 * 64, 256),
                     _meta(64, 256))
    assert kernels.LAUNCHES == n0


@pytest.mark.slow
def test_kernel_route_matches_jax_pallas_interpret(nets):
    """The kernel route (the plain one-tap versions, f32) against JAX's
    ``query_rgb_grid_pallas`` at ×2 and ``query_rgb_grid_rational_pallas``
    at ×5/2 (u_map = feature; Pallas in interpret mode, bf16 inside even
    for an f32 model: max|Δ| ≤ 1e-2·max|ref|), and the plain rational
    grid against JAX's own ``query_rgb_grid_rational`` (≤ 1e-5)."""
    jnet, params, plain, routed = nets
    # the rational halo kernel needs W % 8 == 0 and (W / qx) % 8 == 0
    x = np.random.default_rng(17).random((1, 10, 16, 3), dtype=np.float32)
    feat = _feat(jnet, params, jnp.asarray(x))
    xj = jnp.asarray(x)
    ft, xt = torch.from_numpy(np.array(feat)), torch.from_numpy(x)
    ref2 = np.asarray(jnet.apply(params, feat, xj, 2,
                                 method="query_rgb_grid_pallas"))
    ref25 = np.asarray(jnet.apply(params, feat, xj, 5, 2, 5, 2,
                                  method="query_rgb_grid_rational_pallas"))
    ref25_xla = np.asarray(jnet.apply(params, feat, xj, 5, 2, 5, 2,
                                      method="query_rgb_grid_rational"))
    with torch.no_grad():
        got2 = routed.generator.query_rgb_grid_kernels(ft, xt, 2).numpy()
        got25 = routed.generator.query_rgb_grid_rational_kernels(
            ft, xt, 5, 2, 5, 2).numpy()
        plain25 = plain.generator.query_rgb_grid_rational(
            ft, xt, 5, 2, 5, 2).numpy()
    for got, ref in ((got2, ref2), (got25, ref25)):
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()
    np.testing.assert_allclose(plain25, ref25_xla, atol=1e-5, rtol=0)
