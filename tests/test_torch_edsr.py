"""Config 001 edsr in the port against the JAX package, f32, the same
weights (carried by ``state_dict_from_jax`` or ``convert_generator(...,
strict=True)``): the EDSR encoder against ``EDSREncoder`` (≤ 1e-5 abs),
the config's generator built by both builders (with and without the
unfold, and ``LocalImplicitSRNet`` with either trunk), the state-dict
round trip of an EDSR generator, and a ×4 ``predict_tiled`` against the
JAX restorer's own (its XLA route)."""

import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciaosr_torch.convert.from_jax import (edsr_state_dict_from_jax,
                                           state_dict_from_jax)
from ciaosr_torch.models.builder import build_generator
from ciaosr_torch.models.edsr import EDSR
from ciaosr_torch.models.restorers import CiaoSRRestorer
from ciaosr_tpu.convert.torch_weights import convert_generator
from ciaosr_tpu.models.edsr import EDSREncoder
from ciaosr_tpu.models.restorers import CiaoSRRestorer as JaxRestorer
from tests.test_torch_weights import (ROOT, _same_tree, generator_params,
                                      seeded_params)

CONFIG = ROOT / "configs" / ("001_localimplicitsr_edsr_div2k_g1_c64b16_"
                             "1000k_unfold_lec_mulwkv_res_nonlocal.py")

# config 001 edsr's generator cut to test dims: 16 channels, 2 blocks,
# imnet [32]×2
EDSR_SMALL = dict(
    type="LocalImplicitSREDSR",
    encoder=dict(type="EDSR", in_channels=3, out_channels=3,
                 mid_channels=16, num_blocks=2, res_scale=1.0),
    imnet_q=dict(type="MLPRefiner", out_dim=3, hidden_list=[32, 32]),
    imnet_k=dict(type="MLPRefiner", out_dim=16, hidden_list=[32, 32]),
    imnet_v=dict(type="MLPRefiner", out_dim=16, hidden_list=[32, 32]),
    feat_unfold=True, eval_bsize=30000)


def config_generator() -> dict:
    """The ``generator`` dict of configs/001_localimplicitsr_edsr_*."""
    return runpy.run_path(str(CONFIG))["model"]["generator"]


@pytest.mark.parametrize("num_blocks,res_scale", [(3, 1.0), (2, 0.1)])
def test_edsr_matches_jax(rng, num_blocks, res_scale):
    cfg = dict(in_channels=3, mid_channels=16, num_blocks=num_blocks,
               res_scale=res_scale)
    x = rng.random((2, 11, 13, 3), dtype=np.float32)
    enc = EDSREncoder(**cfg)
    params = seeded_params(enc, num_blocks, jnp.asarray(x))
    ref = np.asarray(jax.jit(enc.apply)(params, jnp.asarray(x)))
    net = EDSR(**cfg)
    net.load_state_dict(edsr_state_dict_from_jax(params["params"]),
                        strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_edsr_bf16_compute_keeps_f32_params():
    net = EDSR(mid_channels=16, num_blocks=2)
    x = torch.from_numpy(np.random.default_rng(1).random(
        (1, 9, 10, 3), dtype=np.float32))
    with torch.no_grad():
        got = net(x, torch.bfloat16)
        ref = net(x)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 9, 10, 16)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert float((got.float() - ref).abs().max()) <= 2e-2 * float(
        ref.abs().max())


@pytest.mark.parametrize("feat_unfold", [True, False],
                         ids=["unfold", "no_unfold"])
def test_config_generator_builds_in_both_packages(feat_unfold):
    """Config 001 edsr's generator (C = 64, 16 blocks, imnet [256]×4, CSA)
    as shipped and without the unfold: the JAX builder's param tree goes
    into the port's generator key for key (strict), and back through
    ``convert_generator(strict=True)`` bit for bit."""
    cfg = dict(config_generator(), feat_unfold=feat_unfold)
    assert cfg["type"] == "LocalImplicitSREDSR"
    _, params = generator_params(cfg, seed=3)
    sd = state_dict_from_jax(params, feat_dim=64, encoder="edsr",
                             feat_unfold=feat_unfold)
    net = build_generator(cfg, device="cpu")
    net.load_state_dict(sd, strict=True)
    base = 64 * (9 if feat_unfold else 1)
    assert net.imnet_k.linears[0].in_features == base + 4
    assert net.imnet_v.linears[-1].out_features == base + 64
    assert net.imnet_q.linears[0].in_features == base + 64
    assert len(net.encoder.body) == 16 and net.feat_unfold == feat_unfold
    back = convert_generator(net.state_dict(), encoder="edsr", feat_dim=64,
                             feat_unfold=feat_unfold, strict=True)
    _same_tree(back, params)


@pytest.mark.parametrize("enc_type", ["RDN", "EDSR"])
def test_local_implicit_sr_net_takes_either_encoder(enc_type):
    enc = dict(type=enc_type, in_channels=3, mid_channels=16, num_blocks=2)
    if enc_type == "RDN":
        enc.update(num_layers=2, channel_growth=8)
    cfg = dict(EDSR_SMALL, type="LocalImplicitSRNet", encoder=enc)
    net = build_generator(cfg, device="cpu")
    assert type(net.encoder).__name__ == enc_type
    _, params = generator_params(cfg, seed=4)
    net.load_state_dict(state_dict_from_jax(
        params, feat_dim=16, n_hidden=2, encoder=enc_type.lower()),
        strict=True)
    with pytest.raises(KeyError, match="RDN or EDSR"):
        build_generator(dict(cfg, encoder=dict(type="SwinIR")), device="cpu")


@pytest.mark.parametrize("feat_unfold", [True, False],
                         ids=["unfold", "no_unfold"])
def test_state_dict_roundtrip_edsr(feat_unfold):
    cfg = dict(EDSR_SMALL, feat_unfold=feat_unfold)
    _, params = generator_params(cfg, seed=2)
    sd = state_dict_from_jax(params, feat_dim=16, n_hidden=2,
                             encoder="edsr", feat_unfold=feat_unfold)
    back = convert_generator(sd, encoder="edsr", feat_dim=16, n_hidden=2,
                             feat_unfold=feat_unfold, strict=True)
    _same_tree(back, params)
    net = build_generator(cfg, device="cpu")
    net.load_state_dict(sd, strict=True)
    assert set(net.state_dict()) == set(sd)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel_route"])
def test_predict_tiled_x4_matches_jax(use_kernels):
    """Config 001 edsr's protocol at test dims: ×4 ``predict_tiled``
    (overlap-average, clamp after the average) of a 24 × 20 image in 16²
    tiles, overlap 4, against the JAX restorer's own ``predict_tiled`` on
    its XLA route; the port's plain route and its kernel route on CPU
    tensors (the plain versions of K4 and K1 → K2 → K3)."""
    _, params = generator_params(EDSR_SMALL, seed=7)
    restorer = CiaoSRRestorer(dict(EDSR_SMALL, use_kernels=use_kernels),
                              device="cpu")
    restorer.generator.load_state_dict(state_dict_from_jax(
        params, feat_dim=16, n_hidden=2, encoder="edsr"), strict=True)
    lq = np.random.default_rng(5).random((24, 20, 3), dtype=np.float32)
    ref = np.asarray(JaxRestorer(EDSR_SMALL).predict_tiled(
        params, lq, 4, tile=16, tile_overlap=4))
    got = restorer.predict_tiled(lq, 4, tile=16, tile_overlap=4)
    assert got.shape == ref.shape == (96, 80, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
