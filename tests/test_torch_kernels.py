"""The port's CUDA kernels (bf16) against their plain PyTorch versions
(f32, the same input values): max|Δ|/max|ref| ≤ 1e-2, the bf16 class the
JAX kernels hold. Needs a CUDA card; on the card run
``python -m pytest --noconftest -q tests/test_torch_kernels.py`` (this file
imports no JAX). Shapes are flagship widths (C = 64, hidden 256) at small,
odd spatial sizes so the block tails and partial tiles are exercised.
"""

import numpy as np
import pytest
import torch

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
    return x.float() if x.is_floating_point() else x


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


@torch.inference_mode()
def test_f3p_build(case):
    net, feat, csa, dk = case
    pk = dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, 64, 4,
                         torch.bfloat16)
    args = (feat, csa, pk["wk0"], pk["wvu"], pk["wvc"])
    got = dk.f3p_build(*args)
    assert _rel(got, dk.f3p_build_plain(*_f32(args))) <= REL_TOL


@torch.inference_mode()
def test_wt_hoist(case):
    net, feat, _, dk = case
    pk = dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, 64, 4,
                         torch.bfloat16)
    got = dk.wt_hoist(feat, pk["wkout"], pk["bkout"])
    ref = dk.wt_hoist_plain(feat.float(), pk["wkout"].float(), pk["bkout"])
    assert _rel(got, ref) <= REL_TOL


@pytest.mark.parametrize("scale,local_size", [(3, 2), (4, 2), (2, 1),
                                              (2, 3)])
@torch.inference_mode()
def test_grid_decode(case, scale, local_size):
    """local_size 1/2/3 gives 1/4/9 shifts: the kernel stacks them 4 at a
    time, so 9 covers a partial group."""
    net, feat, csa, dk = case
    pk = dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, 64, scale,
                         torch.bfloat16)
    tabs = dk.decoder_tables(scale, *feat.shape[1:3], local_size,
                             feat.device)
    gk, gv = dk.f3p_build(feat, csa, pk["wk0"], pk["wvu"], pk["wvc"])
    wt, ck = dk.wt_hoist(feat, pk["wkout"], pk["bkout"])
    got = dk.grid_decode(feat, csa, gk, gv, wt, ck, pk, tabs, 1.0)
    ref = dk.grid_decode_plain(*_f32((feat, csa, gk, gv, wt, ck)), _f32(pk),
                               tabs, 1.0)
    assert got.shape == (2, scale * scale, 21, 37, 3)
    assert _rel(got, ref) <= REL_TOL


@pytest.mark.parametrize("hw", [(21, 37), (16, 32)])
@torch.inference_mode()
def test_csa_stencil(case, hw):
    from ciaosr_torch.ops.kernels import csa_stencil as k4
    net, feat, _, _ = case
    x = torch.nn.functional.interpolate(
        feat.permute(0, 3, 1, 2).float(), size=hw).permute(0, 2, 3, 1)
    match, keys, embed = net.cs_attn.stencil_inputs(
        x.to(torch.bfloat16).contiguous(), 2, torch.bfloat16)
    got = k4.csa_stencil(match, keys, embed, 10.0, 2)
    ref = k4.csa_stencil_plain(match.float(), keys.float(), embed.float(),
                               10.0, 2)
    assert got.shape == ref.shape
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
    from ciaosr_torch.ops.kernels import csa_stencil as k4
    _, feat, csa, dk = case
    w = torch.zeros(576, 256, device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        dk.f3p_build(feat.float(), csa, w, w, w[:64])
    with pytest.raises(ValueError, match="s=2"):
        k4.csa_stencil(csa, csa, csa, 10.0, 3)
