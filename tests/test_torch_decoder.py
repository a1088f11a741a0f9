"""Port dense-grid decode vs the JAX per-query gather path (query_rgb on
the full HR grid), f32, same weights.

Both port routes are checked: ``query_rgb_grid`` (the plain dense decode)
and ``query_rgb_grid_kernels`` on CPU tensors (the plain versions of
K4 and K1 → K2 → K3). The JAX gather path is the fast oracle: the JAX
grid routes reach Pallas kernels in interpret mode (cs_attn(flash=True)),
which the JAX package keeps in its slow lane; its equality with the grid
path is tested there. W = 9 exercises W % 8 != 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciaosr_torch.convert.from_jax import state_dict_from_jax
from ciaosr_torch.models.builder import build_generator
from ciaosr_tpu.core.coords import make_coord_cell
from tests.test_torch_weights import SMALL, generator_params


@pytest.fixture(scope="module")
def nets():
    jnet, params = generator_params(SMALL, seed=5)
    pnet = build_generator(SMALL, device="cpu")
    pnet.load_state_dict(state_dict_from_jax(params, feat_dim=16,
                                             n_hidden=2), strict=True)
    x = np.random.default_rng(1).random((1, 10, 9, 3), dtype=np.float32)
    feat = jax.jit(lambda p, x: jnet.apply(p, x, method="gen_feature"))(
        params, jnp.asarray(x))
    nl = jax.jit(lambda p, f: jnet.apply(p, f, method="nl_feature"))(
        params, feat)
    return jnet, params, pnet, x, feat, nl


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_grid_decode_matches_jax_gather(nets, scale):
    jnet, params, pnet, x, feat, nl = nets
    h, w = x.shape[1:3]
    th, tw = h * scale, w * scale
    coord, cell = make_coord_cell((th, tw))
    ref = jax.jit(lambda p, f, x, co, ce, nl: jnet.apply(
        p, f, x, co, ce, nl, method="query_rgb"))(
            params, feat, jnp.asarray(x), coord[None], cell[None], nl)
    ref = np.asarray(ref).reshape(1, th, tw, 3)
    ft, xt = torch.from_numpy(np.array(feat)), torch.from_numpy(x)
    with torch.no_grad():
        plain = pnet.query_rgb_grid(ft, xt, scale).numpy()
        routed = pnet.query_rgb_grid_kernels(ft, xt, scale).numpy()
    np.testing.assert_allclose(plain, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(routed, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("local_size", [1, 3])
def test_grid_decode_local_sizes(local_size):
    """1 and 9 local-ensemble shifts (the flagship has 4)."""
    cfg = dict(SMALL, local_size=local_size)
    jnet, params = generator_params(cfg, seed=local_size)
    pnet = build_generator(cfg, device="cpu")
    pnet.load_state_dict(state_dict_from_jax(params, feat_dim=16,
                                             n_hidden=2), strict=True)
    x = np.random.default_rng(2).random((1, 7, 8, 3), dtype=np.float32)
    s, th, tw = 3, 21, 24
    coord, cell = make_coord_cell((th, tw))
    ref = jax.jit(lambda p, x, co, ce: jnet.apply(p, x, co, ce))(
        params, jnp.asarray(x), coord[None], cell[None])
    ref = np.asarray(ref).reshape(1, th, tw, 3)
    with torch.no_grad():
        got = pnet.decode_grid(torch.from_numpy(x), s).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_encoder_and_csa_match_jax(nets):
    jnet, params, pnet, x, feat, nl = nets
    with torch.no_grad():
        pf = pnet.gen_feature(torch.from_numpy(x))
        pnl = pnet.nl_feature(pf)
    np.testing.assert_allclose(pf.numpy(), np.asarray(feat), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(pnl.numpy(), np.asarray(nl), atol=1e-5,
                               rtol=0)
