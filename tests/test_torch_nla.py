"""The SwinIR-CiaoSR generator of the 002 configs (non_local_attn=False)
at a small size, port vs the JAX package's XLA routes, f32, same weights
through state_dict_from_jax: the dense-grid decode at ×2 and ×4 (the
plain route and the kernel route on CPU tensors, with the 12-channel
feature zero-padded to the kernels' width), the per-query decoder, and
``predict_tiled`` at ×4 with tiles smaller than the image. Also the
build_generator's 002 knobs and the entry points' device rule. Tolerance: f32,
≤ 1e-5 abs.
"""

import warnings
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciaosr_torch.convert.from_jax import state_dict_from_jax
from ciaosr_torch.models.builder import build_generator
from ciaosr_torch.models.restorers import CiaoSRRestorer, tile_layout
from ciaosr_tpu.models.restorers import CiaoSRRestorer as JaxRestorer
from tests.test_torch_weights import (SWIN_SMALL, generator_params,
                                      jax_query_rgb)

# the 002 generator as its configs write it (knobs included), full size
SWIN_002 = dict(
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
    feat_unfold=True, eval_bsize=30000, local_ensemble_coord=True,
    non_local_attn=False)


@pytest.fixture(scope="module")
def nets():
    jnet, params = generator_params(SWIN_SMALL, seed=11)
    pnet = build_generator(SWIN_SMALL, device="cpu")
    pnet.load_state_dict(state_dict_from_jax(
        params, feat_dim=12, n_hidden=2, encoder="swinir",
        non_local_attn=False), strict=True)
    x = np.random.default_rng(2).random((1, 10, 9, 3), dtype=np.float32)
    feat = jax.jit(lambda p, x: jnet.apply(p, x, method="gen_feature"))(
        params, jnp.asarray(x))
    return jnet, params, pnet, x, feat


def test_generator_has_no_csa(nets):
    _, _, pnet, _, _ = nets
    assert not hasattr(pnet, "cs_attn")
    assert pnet.imnet_v.linears[0].in_features == 9 * 12 + 4
    assert pnet.imnet_q.linears[0].in_features == 9 * 12
    assert not any(k.startswith("cs_attn") for k in pnet.state_dict())


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel_route"])
def test_gen_feature_matches_jax(nets, use_kernels):
    _, _, pnet, x, feat = nets
    pnet.use_kernels = use_kernels
    try:
        with torch.no_grad():
            got = pnet.gen_feature(torch.from_numpy(x)).numpy()
    finally:
        pnet.use_kernels = False
    np.testing.assert_allclose(got, np.asarray(feat), atol=1e-5, rtol=0)


@pytest.mark.parametrize("scale", [2, 4])
def test_grid_decode_matches_jax(nets, scale):
    """Both port routes against JAX's XLA dense decode (no CSA, so no
    Pallas kernel on the JAX side either)."""
    jnet, params, pnet, x, feat = nets
    ref = np.asarray(jax.jit(lambda p, f, x: jnet.apply(
        p, f, x, scale, method="query_rgb_grid"))(params, feat,
                                                   jnp.asarray(x)))
    ft, xt = torch.from_numpy(np.array(feat)), torch.from_numpy(x)
    with torch.no_grad():
        plain = pnet.query_rgb_grid(ft, xt, scale).numpy()
        routed = pnet.query_rgb_grid_kernels(ft, xt, scale).numpy()
    np.testing.assert_allclose(plain, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(routed, ref, atol=1e-5, rtol=0)


def test_query_rgb_matches_jax(nets):
    jnet, params, pnet, x, feat = nets
    rng = np.random.default_rng(6)
    coord = rng.uniform(-1, 1, (1, 80, 2)).astype(np.float32)
    cell = np.full((1, 80, 2), 0.07, np.float32)
    ref = jax_query_rgb(jnet, params, feat, x, coord, cell, None)
    with torch.no_grad():
        got = pnet.query_rgb(torch.from_numpy(np.array(feat)),
                             torch.from_numpy(x), torch.from_numpy(coord),
                             torch.from_numpy(cell)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel_route"])
def test_predict_tiled_matches_jax(nets, use_kernels):
    """×4 with 12-pixel tiles over a 20 × 17 image (overlap 4): the encoder
    pads each tile to 16 and the decode runs at 12 × 12."""
    _, params, _, _, _ = nets
    cfg = dict(SWIN_SMALL, use_kernels=use_kernels)
    jres = JaxRestorer(SWIN_SMALL)
    restorer = CiaoSRRestorer(cfg, device="cpu")
    restorer.generator.load_state_dict(state_dict_from_jax(
        params, feat_dim=12, n_hidden=2, encoder="swinir",
        non_local_attn=False), strict=True)
    lq = np.random.default_rng(4).random((20, 17, 3), dtype=np.float32)
    ref = np.asarray(jres.predict_tiled(params, lq, 4, tile=12,
                                        tile_overlap=4))
    got = restorer.predict_tiled(lq, 4, tile=12, tile_overlap=4)
    assert got.shape == ref.shape == (80, 68, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_002_knobs_warn_or_raise():
    cfg = dict(SWIN_SMALL, imnet_k_type="no_mul")
    with pytest.warns(UserWarning, match="baked-in"):
        build_generator(cfg, device="cpu")
    with pytest.raises(ValueError, match="baked-in"):
        build_generator(dict(cfg, strict_knobs=True), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # values that agree pass silently
        build_generator(dict(SWIN_SMALL, local_ensemble_coord=True,
                             res=True, imnet_v_type="mul_w_cell"),
                        device="cpu")


def test_002_generator_needs_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_generator(SWIN_002)


def test_002_generator_builds_at_full_width():
    """The 002 dict as its configs write it: window 8 reaches the encoder,
    6 × 6 blocks of 180 channels, the trunk's reference init."""
    net = build_generator(SWIN_002, device="cpu", seed=0)
    enc = net.encoder
    assert enc.window_size == 8 and net.non_local_attn is False
    assert [len(l.residual_group.blocks) for l in enc.layers] == [6] * 6
    assert net.imnet_q.linears[0].in_features == 9 * 180
    blk = enc.layers[0].residual_group.blocks[1]
    assert blk.shift_size == 4 and blk.attn.num_heads == 6
    assert torch.equal(blk.norm1.weight, torch.ones(180))
    assert torch.equal(blk.attn.qkv.bias, torch.zeros(540))
    assert 0.015 < float(blk.mlp.fc1.weight.detach().std()) < 0.025


# chip_smoke.py's SwinIR path at a CPU size: the 002 dict, knobs included,
# cut to one RSTB of 18 channels (6 heads of 3) with narrow MLPs
SWIN_002_ONE_RSTB = dict(
    SWIN_002, encoder=dict(SWIN_002["encoder"], depths=[6], embed_dim=18,
                           num_heads=[6]),
    **{k: dict(SWIN_002[k], hidden_list=[32, 32])
       for k in ("imnet_q", "imnet_k", "imnet_v")})


@pytest.mark.parametrize("scale,decode", [(4, "grid_decode"),
                                          (2.5, "grid_decode_rational")])
def test_002_forward_test_one_rstb(monkeypatch, scale, decode):
    """``forward_test`` with tiles of 16 (overlap 4) over a 28 × 28 image:
    the kernel route calls the Swin block wrapper 6 × tiles times and each
    decode wrapper once per tile (the launch counts chip_smoke.py checks),
    and agrees with the plain route of the same weights."""
    import ciaosr_torch.models.ciaosr as mciaosr
    import ciaosr_torch.models.swinir as mswin

    calls = Counter()

    def count(mod, name):
        fn = getattr(mod, name)

        def counted(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)

    count(mswin, "swin_block")
    for name in ("f3p_build", "wt_hoist", "grid_decode",
                 "grid_decode_rational"):
        count(mciaosr.dk_ops, name)
    test_cfg = dict(scale=scale, tile=16, tile_overlap=4)
    routed = CiaoSRRestorer(dict(SWIN_002_ONE_RSTB, use_kernels=True),
                            test_cfg=test_cfg, device="cpu", seed=3)
    plain = CiaoSRRestorer(SWIN_002_ONE_RSTB, test_cfg=test_cfg,
                           device="cpu", seed=4)
    plain.generator.load_state_dict(routed.generator.state_dict())
    lq = np.random.default_rng(5).random((28, 28, 3), dtype=np.float32)
    _, hs, ws = tile_layout(28, 28, scale, 16, 4)
    tiles = len(hs) * len(ws)
    got = routed.forward_test(lq)
    assert dict(calls) == {"swin_block": 6 * tiles, "f3p_build": tiles,
                           "wt_hoist": tiles, decode: tiles}
    calls.clear()
    ref = plain.forward_test(lq)
    assert not calls
    assert got.shape == ref.shape == (round(28 * scale),) * 2 + (3,)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
