"""Port rational-scale eval vs the JAX package, f32, same weights.

The host tables are held bit-equal to ``_grid_axis_tables``; the dense
decodes (plain ``query_rgb_grid_rational`` and the kernel route on CPU
tensors, i.e. the plain versions of K4, K1, K2 and K3's rational mode),
the rational ``predict`` and the rational ``predict_tiled`` are held
against JAX's per-query gather on the same target grid, within 3e-5 (the
bound JAX's own dense-vs-gather test holds). JAX's own dense rational
decode compiles for about a minute per geometry on the CPU, so the
gather is the oracle here; their equality is tested in the JAX package.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciaosr_torch.convert.from_jax import state_dict_from_jax
from ciaosr_torch.core.coords import make_coord_cell
from ciaosr_torch.models.builder import build_generator
from ciaosr_torch.models.ciaosr import grid_axis_tables
from ciaosr_torch.models.restorers import CiaoSRRestorer
from ciaosr_torch.ops.kernels import decoder as dk
from ciaosr_tpu.models.ciaosr import _grid_axis_tables
from tests.test_torch_weights import SMALL, generator_params, jax_query_rgb

MEAN = np.asarray((0.4488, 0.4371, 0.4040), np.float32)
TOL = 3e-5


@pytest.mark.parametrize("local_size", [1, 2, 3])
@pytest.mark.parametrize("n,tn,p", [
    (8, 12, 3),      # ×1.5: exact nearest-neighbour ties
    (8, 20, 5),      # ×2.5
    (9, 21, 7),      # ×7/3
    (9, 15, 5),      # 5/3 (the y axis of 5/3 × 7/2)
    (8, 28, 7),      # 7/2 (its x axis)
    (192, 480, 5),   # a flagship tile at ×2.5
])
def test_grid_axis_tables_bit_equal(n, tn, p, local_size):
    got = grid_axis_tables(n, tn, p, local_size)
    ref = _grid_axis_tables(n, tn, p, local_size)
    assert sorted(got, key=str) == sorted(ref, key=str)
    for a, b in zip(got["q"], ref["q"]):
        np.testing.assert_array_equal(a, b)
    for sign in ref:
        if sign == "q":
            continue
        for part in (0, 1):
            for a, b in zip(got[sign][part], ref[sign][part]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_rational_tables_layout():
    tabs = dk.rational_tables(8, 9, 5, 2, 7, 3, 2, "cpu")
    assert tabs["yq"].shape == (5, 4) and tabs["yk"].shape == (5, 4, 4)
    assert tabs["xq"].shape == (7, 3) and tabs["xk"].shape == (7, 4, 3)
    assert tabs["yrel"].dtype == torch.float32
    assert tabs["yq"].dtype == tabs["xk"].dtype == torch.int32
    for ax in "yx":
        d = tabs[ax + "k"] - tabs[ax + "q"][:, None]
        assert int(d.abs().max()) <= 1
    # shift i = (vy, vx) of shift_offsets(2) reads y sign vy, x sign vx
    ref = grid_axis_tables(8, 20, 5, 2)
    np.testing.assert_array_equal(tabs["yk"][2, 0].numpy(), ref[-1][0][2])
    np.testing.assert_array_equal(tabs["yk"][2, 3].numpy(), ref[1][0][2])
    with pytest.raises(ValueError, match="qy | H"):
        dk.rational_tables(9, 9, 5, 2, 5, 2, 2, "cpu")


def test_pack_decoder_cell_terms():
    """Equal cells keep the integer route's sum, bit for bit; unequal
    cells weigh each axis's column by its own cell."""
    net = build_generator(SMALL, device="cpu")
    lk = net.imnet_k.linears[0]
    w = lk.weight.detach()
    dk_ = 9 * 16
    pk = dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, 16,
                         (2.0 / 3, 2.0 / 3), torch.float32)
    torch.testing.assert_close(
        pk["kb0"], lk.bias + 2.0 / 3 * (w[:, dk_ + 2] + w[:, dk_ + 3]),
        rtol=0, atol=0)
    pk = dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, 16,
                         (0.8, 0.5), torch.float32)
    torch.testing.assert_close(
        pk["kb0"], lk.bias + (0.8 * w[:, dk_ + 2] + 0.5 * w[:, dk_ + 3]),
        rtol=0, atol=0)


@pytest.fixture(scope="module")
def models():
    jnet, params = generator_params(SMALL, seed=12)
    sd = state_dict_from_jax(params, feat_dim=16, n_hidden=2)
    plain = CiaoSRRestorer(SMALL, device="cpu")
    routed = CiaoSRRestorer(dict(SMALL, use_kernels=True), device="cpu")
    for r in (plain, routed):
        r.generator.load_state_dict(sd, strict=True)
    feat_fn = jax.jit(lambda p, x: jnet.apply(p, x, method="gen_feature"))
    nl_fn = jax.jit(lambda p, f: jnet.apply(p, f, method="nl_feature"))
    return jnet, params, plain, routed, feat_fn, nl_fn


def _gather_ref(models, x, th, tw):
    """JAX per-query decode of x (B, h, w, 3) on the th × tw grid:
    (B, th, tw, 3) before denorm."""
    jnet, params, _, _, feat_fn, nl_fn = models
    feat = feat_fn(params, jnp.asarray(x))
    co, ce = (t.numpy() for t in make_coord_cell((th, tw)))
    b = x.shape[0]
    coord = np.broadcast_to(co, (b, th * tw, 2)).copy()
    cell = np.broadcast_to(ce, (b, th * tw, 2)).copy()
    out = jax_query_rgb(jnet, params, feat, x, coord, cell,
                        nl_fn(params, feat))
    return out.reshape(b, th, tw, 3)


@pytest.mark.parametrize("py,qy,px,qx,hw", [
    (5, 2, 5, 2, (8, 6)),      # ×2.5 (a tie phase)
    (7, 3, 7, 3, (9, 6)),      # ×7/3
    (3, 2, 3, 2, (8, 6)),      # ×1.5 (exact ties)
    (5, 3, 7, 2, (9, 8)),      # 5/3 × 7/2
], ids=["x2.5", "x7/3", "x1.5", "5/3x7/2"])
def test_rational_grid_matches_jax_gather(models, py, qy, px, qx, hw):
    _, _, plain, routed, _, _ = models
    x = np.random.default_rng(py * qx).random((2, *hw, 3), dtype=np.float32)
    th, tw = hw[0] * py // qy, hw[1] * px // qx
    ref = _gather_ref(models, x, th, tw)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        for net, fn in ((plain.generator, "query_rgb_grid_rational"),
                        (routed.generator,
                         "query_rgb_grid_rational_kernels")):
            feat = net.gen_feature(xt)
            got = getattr(net, fn)(feat, xt, py, qy, px, qx).numpy()
            assert got.shape == (2, th, tw, 3)
            np.testing.assert_allclose(got, ref, atol=TOL, rtol=0,
                                       err_msg=fn)


@pytest.mark.parametrize("local_size", [1, 3])
def test_rational_grid_local_sizes(local_size):
    """1 and 9 local-ensemble shifts (the flagship has 4) at ×5/3, both
    routes against the gather, which is query_rgb at those sizes too."""
    cfg = dict(SMALL, local_size=local_size)
    jnet, params = generator_params(cfg, seed=20 + local_size)
    sd = state_dict_from_jax(params, feat_dim=16, n_hidden=2)
    x = np.random.default_rng(local_size).random((1, 9, 6, 3),
                                                 dtype=np.float32)
    feat = jax.jit(lambda p, x: jnet.apply(p, x, method="gen_feature"))(
        params, jnp.asarray(x))
    nl = jax.jit(lambda p, f: jnet.apply(p, f, method="nl_feature"))(
        params, feat)
    co, ce = (t.numpy()[None] for t in make_coord_cell((15, 10)))
    ref = jax_query_rgb(jnet, params, feat, x, co, ce, nl).reshape(
        1, 15, 10, 3)
    xt = torch.from_numpy(x)
    for use_kernels in (False, True):
        net = build_generator(dict(cfg, use_kernels=use_kernels),
                              device="cpu")
        net.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got = net.decode_grid(xt, Fraction(5, 3)).numpy()
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_decode_grid_dispatch(models):
    """Integer sy = sx takes the integer decode; q = 1 with sy ≠ sx, and
    every q > 1, the rational one, which at q = 1 agrees with the
    integer decode to float noise."""
    _, _, plain, _, _, _ = models
    net = plain.generator
    x = torch.from_numpy(np.random.default_rng(2).random(
        (1, 6, 5, 3), dtype=np.float32))
    with torch.no_grad():
        feat = net.gen_feature(x)
        integer = net.query_rgb_grid(feat, x, 3)
        rational = net.query_rgb_grid_rational(feat, x, 3, 1, 3, 1)
        torch.testing.assert_close(net.decode_grid(x, 3), integer,
                                   rtol=0, atol=0)
        assert net.decode_grid(x, 2, 3).shape == (1, 12, 15, 3)
    torch.testing.assert_close(rational, integer, rtol=0, atol=1e-6)


@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_predict_rational_matches_jax_gather(models, route):
    """Full-image ×2.5 (20×15 from 8×6) takes the dense rational decode."""
    restorer = models[2] if route == "plain" else models[3]
    lq = np.random.default_rng(5).random((8, 6, 3), dtype=np.float32)
    ref = np.clip(_gather_ref(models, lq[None] - MEAN, 20, 15)[0] + MEAN,
                  0, 1)
    got = restorer.predict(lq, (20, 15))
    assert got.shape == (20, 15, 3)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("scale,hw,tile,overlap", [
    (2.5, (9, 14), 8, 4),        # reflect-pad 9 → 10, crop to 22 × 35
    ("7/3", (10, 11), 9, 3),     # reflect-pad to 12 × 12, crop 23 × 26
], ids=["x2.5", "x7/3"])
def test_predict_tiled_rational_matches_jax_composition(models, scale, hw,
                                                        tile, overlap):
    """The port's rational predict_tiled against a composition of JAX
    per-tile decodes: reflect-pad to a q multiple, q-snapped tile size
    and starts, HR positions hi·p/q, overlap average, one clamp, crop."""
    _, _, plain, routed, _, _ = models
    f = Fraction(scale)
    p, q = f.numerator, f.denominator
    lq = np.random.default_rng(p).random((*hw, 3), dtype=np.float32)
    h, w = hw
    th, tw = round(h * p / q), round(w * p / q)
    hp, wp = -(-h // q) * q, -(-w // q) * q
    padded = np.pad(lq, ((0, hp - h), (0, wp - w), (0, 0)), mode="reflect")
    t = min(tile, hp, wp) // q * q
    stride = max(t - overlap, q) // q * q

    def starts(n):
        return sorted(set(list(range(0, n - t, stride)) + [n - t]))

    acc = np.zeros((hp * p // q, wp * p // q, 3), np.float64)
    cnt = np.zeros((hp * p // q, wp * p // q, 1), np.float64)
    ot = t * p // q
    for hi in starts(hp):
        for wi in starts(wp):
            tile_lq = padded[None, hi:hi + t, wi:wi + t] - MEAN
            out = _gather_ref(models, tile_lq, ot, ot)[0] + MEAN
            y0, x0 = hi * p // q, wi * p // q
            acc[y0:y0 + ot, x0:x0 + ot] += out
            cnt[y0:y0 + ot, x0:x0 + ot] += 1
    ref = np.clip(acc / cnt, 0, 1)[:th, :tw]
    for restorer in (plain, routed):
        got = restorer.predict_tiled(lq, scale, tile=tile,
                                     tile_overlap=overlap)
        assert got.shape == (th, tw, 3)
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_forward_test_rational_scales(models):
    """forward_test passes int, float, str and Fraction scales through,
    tiled and full-image, without flooring them."""
    plain = models[2]
    lq = np.random.default_rng(1).random((8, 8, 3), dtype=np.float32)
    full = plain.forward_test(lq, scale=Fraction(5, 2))
    assert full.shape == (20, 20, 3)
    plain.test_cfg = dict(tile=8, tile_overlap=4)
    try:
        tiled = plain.forward_test(lq, scale="5/2")
        np.testing.assert_array_equal(tiled, plain.forward_test(
            lq, scale=2.5))
    finally:
        plain.test_cfg = {}
    # one tile covers the image: tiled == full-image
    np.testing.assert_allclose(tiled, full, atol=1e-6, rtol=0)
