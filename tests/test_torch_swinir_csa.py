"""Config 001 swinir (SwinIR-CiaoSR with cross-scale attention) at a CPU
size, port vs the JAX package, f32, the same weights through
state_dict_from_jax(encoder="swinir", non_local_attn=True): the encoder
features, the CSA output (``nl_feature``: the plain route and the kernel
route, whose kernels take their plain versions on CPU tensors) and the
per-query ``query_rgb`` (the fast oracle: JAX's grid decodes would run its
Pallas CSA in interpret mode). The 001 generator dict with the depth cut,
at a small width (embed 12: Cr = 6) and at its own 180 channels (Cr = 90,
one Swin block). The inputs give the CSA both of its route families: 10 ×
9 (reflect-padded to 10 × 10) streams through the explicit banks, 16 × 16
takes the stencil form. Tolerance: f32, ≤ 1e-5 abs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciaosr_torch.convert.from_jax import state_dict_from_jax
from ciaosr_torch.models.builder import build_generator
from ciaosr_torch.models.csa import csa_route
from tests.test_torch_weights import generator_params, jax_query_rgb

# the generator of configs/001_localimplicitsr_swinir_* (its 'generator'
# dict, copied), full size
SWIN_001 = dict(
    type="LocalImplicitSRSWINIR", window_size=8,
    encoder=dict(type="SwinIR", upscale=4, in_chans=3, img_size=48,
                 window_size=8, compress_ratio=3, squeeze_factor=30,
                 conv_scale=0.01, overlap_ratio=0.5, img_range=1.0,
                 depths=[6] * 6, embed_dim=180, num_heads=[6] * 6,
                 mlp_ratio=2, upsampler="pixelshuffle",
                 resi_connection="1conv"),
    imnet_q=dict(type="MLPRefiner", in_dim=4, out_dim=3,
                 hidden_list=[256] * 4),
    imnet_k=dict(type="MLPRefiner", in_dim=64, out_dim=64,
                 hidden_list=[256] * 4),
    imnet_v=dict(type="MLPRefiner", in_dim=64, out_dim=64,
                 hidden_list=[256] * 4),
    feat_unfold=True, eval_bsize=30000)


def _cut(embed, depths, heads, hidden):
    """The 001 dict at another width and depth (tuples: flax modules are
    hashed as static arguments)."""
    return dict(SWIN_001, encoder=dict(SWIN_001["encoder"], embed_dim=embed,
                                       depths=depths, num_heads=heads),
                **{k: dict(SWIN_001[k], hidden_list=hidden)
                   for k in ("imnet_q", "imnet_k", "imnet_v")})


# name: (config, feature channels, imnet hidden layers, LR H × W)
CASES = {
    "embed12": (_cut(12, (2,), (3,), [32, 32]), 12, 2, (10, 9)),
    "embed180": (_cut(180, (1,), (6,), [256] * 4), 180, 4, (16, 16)),
}


@pytest.fixture(scope="module", params=list(CASES))
def nets(request):
    cfg, c, n_hidden, hw = CASES[request.param]
    jnet, params = generator_params(cfg, seed=c)
    pnet = build_generator(cfg, device="cpu")
    pnet.load_state_dict(state_dict_from_jax(
        params, feat_dim=c, n_hidden=n_hidden, encoder="swinir",
        non_local_attn=True), strict=True)
    x = np.random.default_rng(c).random((1, *hw, 3), dtype=np.float32)
    feat = jax.jit(lambda p, x: jnet.apply(p, x, method="gen_feature"))(
        params, jnp.asarray(x))
    nl = jax.jit(lambda p, f: jnet.apply(p, f, method="nl_feature"))(
        params, feat)
    return jnet, params, pnet, x, np.array(feat), np.array(nl)


def test_generator_has_csa(nets):
    _, _, pnet, _, feat, nl = nets
    c = feat.shape[-1]
    assert pnet.non_local_attn and pnet.cs_attn.conv_match_1[0].out_channels \
        == c // 2
    assert pnet.imnet_q.linears[0].in_features == 9 * c + c
    assert nl.shape == feat.shape


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel_route"])
def test_gen_feature_matches_jax(nets, use_kernels):
    _, _, pnet, x, feat, _ = nets
    pnet.use_kernels = use_kernels
    try:
        with torch.no_grad():
            got = pnet.gen_feature(torch.from_numpy(x)).numpy()
    finally:
        pnet.use_kernels = False
    np.testing.assert_allclose(got, feat, atol=1e-5, rtol=0)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel_route"])
def test_nl_feature_matches_jax(nets, use_kernel):
    """The CSA on JAX's features: the stencil form (plain route), or the
    middle ``csa_route`` picks at this geometry (kernel route)."""
    _, _, pnet, _, feat, nl = nets
    with torch.no_grad():
        got = pnet.nl_feature(torch.from_numpy(feat), use_kernel).numpy()
    np.testing.assert_allclose(got, nl, atol=1e-5, rtol=0)


def test_csa_routes_of_the_cases():
    """The two inputs reach both route families of the kernel route."""
    modes = {name: csa_route(-(-hw[0] // 2) * 2, -(-hw[1] // 2) * 2, 2, c,
                             c // 2, 4)
             for name, (_, c, _, hw) in CASES.items()}
    assert modes == {"embed12": "streaming", "embed180": "stencil_fused"}


@pytest.mark.parametrize("with_nl", [False, True],
                         ids=["own_csa", "jax_csa"])
def test_query_rgb_matches_jax(nets, with_nl):
    """Random queries against JAX's per-query decoder: with the port's own
    CSA (``nl_feat`` None) and with JAX's CSA features handed in."""
    jnet, params, pnet, x, feat, nl = nets
    rng = np.random.default_rng(7)
    coord = rng.uniform(-1, 1, (1, 96, 2)).astype(np.float32)
    cell = np.full((1, 96, 2), 0.06, np.float32)
    ref = jax_query_rgb(jnet, params, jnp.asarray(feat), x, coord, cell,
                        jnp.asarray(nl))
    with torch.no_grad():
        got = pnet.query_rgb(torch.from_numpy(feat), torch.from_numpy(x),
                             torch.from_numpy(coord), torch.from_numpy(cell),
                             torch.from_numpy(nl) if with_nl else None)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
