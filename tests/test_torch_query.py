"""Port per-query decoder and its ops vs the JAX package, f32, same
weights: coordinates, bilinear-border sampling and patch gathers (exact
or ≤1e-6), ``query_rgb`` (≤1e-5), the chunked per-query ``predict``
fallback (≤1e-5) and ``as_scale_fraction``."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciaosr_torch.convert.from_jax import state_dict_from_jax
from ciaosr_torch.core import coords as tc
from ciaosr_torch.models.builder import build_generator
from ciaosr_torch.models.restorers import CiaoSRRestorer, as_scale_fraction
from ciaosr_torch.ops import neighborhood as tn
from ciaosr_torch.ops import sampling as ts
from ciaosr_tpu.core import coords as jc
from ciaosr_tpu.models.restorers import CiaoSRRestorer as JaxRestorer
from ciaosr_tpu.models.restorers import as_scale_fraction as jax_fraction
from ciaosr_tpu.ops import neighborhood as jn
from ciaosr_tpu.ops import sampling as js
from tests.test_torch_weights import SMALL, generator_params, jax_query_rgb


@pytest.mark.parametrize("shape", [(20, 15), (17, 13), (1, 7), (96, 240)])
def test_make_coord_cell_bit_equal(shape):
    coord, cell = tc.make_coord_cell(shape)
    jcoord, jcell = jc.make_coord_cell(shape)
    np.testing.assert_array_equal(coord.numpy(), np.asarray(jcoord))
    np.testing.assert_array_equal(cell.numpy(), np.asarray(jcell))
    np.testing.assert_array_equal(
        tc.make_coord(shape, flatten=False).numpy(),
        np.asarray(jc.make_coord(shape, flatten=False)))


@pytest.mark.parametrize("shape,q", [((2, 7, 9, 3), 50), ((1, 1, 5, 4), 9)])
def test_grid_sample_bilinear_border(rng, shape, q):
    feat = rng.standard_normal(shape).astype(np.float32)
    coord = rng.uniform(-1.2, 1.2, (shape[0], q, 2)).astype(np.float32)
    coord[0, :3] = [[-1.0, -1.0], [1.0, 1.0], [0.0, 0.0]]
    ref = np.asarray(js.grid_sample_bilinear_border(jnp.asarray(feat),
                                                    jnp.asarray(coord)))
    got = ts.grid_sample_bilinear_border(torch.from_numpy(feat),
                                         torch.from_numpy(coord)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("lead", [(30,), (4, 11)])
def test_gather_patches(rng, lead):
    feat = rng.standard_normal((2, 6, 7, 5)).astype(np.float32)
    iy = rng.integers(0, 6, (2, *lead)).astype(np.int32)
    ix = rng.integers(0, 7, (2, *lead)).astype(np.int32)
    ref = np.asarray(jn.gather_patches(jnp.asarray(feat), jnp.asarray(iy),
                                       jnp.asarray(ix)))
    got = tn.gather_patches(torch.from_numpy(feat), torch.from_numpy(iy),
                            torch.from_numpy(ix)).numpy()
    # the port's layout is channel-major (c·9 + tap), JAX's tap-major
    np.testing.assert_array_equal(got[..., tn.tap_major_perm(5)], ref)


@pytest.fixture(scope="module")
def nets():
    jnet, params = generator_params(SMALL, seed=9)
    pnet = build_generator(SMALL, device="cpu")
    pnet.load_state_dict(state_dict_from_jax(params, feat_dim=16,
                                             n_hidden=2), strict=True)
    x = np.random.default_rng(4).random((2, 9, 8, 3), dtype=np.float32)
    feat = jax.jit(lambda p, x: jnet.apply(p, x, method="gen_feature"))(
        params, jnp.asarray(x))
    nl = jax.jit(lambda p, f: jnet.apply(p, f, method="nl_feature"))(
        params, feat)
    return jnet, params, pnet, x, feat, nl


@pytest.mark.parametrize("kind", ["random", "grid_17x13"])
def test_query_rgb_matches_jax(nets, kind):
    """Random queries (cells differ per image, so the first-query shift
    radius matters) and a full non-dense target grid."""
    jnet, params, pnet, x, feat, nl = nets
    rng = np.random.default_rng(6)
    if kind == "random":
        coord = rng.uniform(-1, 1, (2, 64, 2)).astype(np.float32)
        cell = np.stack([np.full((64, 2), 0.11, np.float32),
                         np.full((64, 2), 0.07, np.float32)])
    else:
        co, ce = tc.make_coord_cell((17, 13))
        coord = np.broadcast_to(co.numpy(), (2, 17 * 13, 2)).copy()
        cell = np.broadcast_to(ce.numpy(), (2, 17 * 13, 2)).copy()
    ref = jax_query_rgb(jnet, params, feat, x, coord, cell, nl)
    with torch.no_grad():
        args = (torch.from_numpy(np.array(feat)), torch.from_numpy(x),
                torch.from_numpy(coord), torch.from_numpy(cell))
        got = pnet.query_rgb(*args).numpy()
        got_nl = pnet.query_rgb(*args, torch.from_numpy(np.array(nl)))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_nl.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("eval_bsize", [50, None])
def test_predict_per_query_fallback_matches_jax(eval_bsize):
    """17×13 from 8×6 has 17·13 = 221 > 128 dense phases: both restorers
    take the chunked per-query path (chunks of 50 pad the last one)."""
    cfg = dict(SMALL, eval_bsize=eval_bsize)
    _, params = generator_params(cfg, seed=3)
    jres = JaxRestorer(cfg)
    restorer = CiaoSRRestorer(cfg, device="cpu")
    restorer.generator.load_state_dict(
        state_dict_from_jax(params, feat_dim=16, n_hidden=2), strict=True)
    lq = np.random.default_rng(8).random((8, 6, 3), dtype=np.float32)
    ref = np.asarray(jres.predict(params, lq, (17, 13)))
    assert any(k[0] == "pred" for k in jres._jit_cache)
    got = restorer.predict(lq, (17, 13))
    assert got.shape == (17, 13, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("s", [2, 2.5, 7 / 3, 1.5, "7/3", "5/2",
                               Fraction(9, 4), 0.1, 1.2345678, 3.0])
def test_as_scale_fraction_matches_jax(s):
    got = as_scale_fraction(s)
    assert isinstance(got, Fraction)
    assert got == jax_fraction(s)
