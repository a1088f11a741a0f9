"""The kernel route of an f32 model hands its kernels bf16.

No shipped config sets a ``dtype``, so ``build_generator`` makes f32
models, and the card's kernels take bf16 only. The JAX package's kernels
cast an f32 model's inputs to bf16 inside; the port casts at the kernel
route's boundary in its models (``kernels.route_dtype``): the CSA
middle's maps, K1-K3's feature, CSA map and packed decoder weights, and
the Swin block's packed weights (x stays f32), on the eval route and
under autograd. The encoder and the plain routes stay in the model
dtype.

On the CPU the rule hands the plain versions the model dtype (the tests
that hold the f32 kernel route to the JAX package at f32 rely on it).
These tests put the card's rule in place on the CPU, wrap every wrapper
the models call so that each call asserts the dtypes it receives, and hold
the f32 model's kernel route against its f32 plain route at the bf16 class
(max|Δ|/max|ref| ≤ 1e-2, the bound the card holds its kernel routes to).
"""

import numpy as np
import pytest
import torch

from test_torch_weights import SMALL  # noqa: F401  (caps torch threads)

import ciaosr_torch.models.ciaosr as mciaosr
import ciaosr_torch.models.csa as mcsa
import ciaosr_torch.models.swinir as mswin
import ciaosr_torch.ops.kernels.swin_block as sb
from ciaosr_torch.models.builder import build_generator
from ciaosr_torch.ops import kernels
from ciaosr_torch.ops.sampling import interpolate_bilinear

REL_TOL = 1e-2
BF, F32 = torch.bfloat16, torch.float32
# the 002 SwinIR-CiaoSR generator cut to one RSTB of 18 channels
SWIN_SMALL = dict(
    type="LocalImplicitSRSWINIR", window_size=8,
    encoder=dict(type="SwinIR", embed_dim=18, depths=[2], num_heads=[6],
                 window_size=8),
    imnet_q=dict(type="MLPRefiner", out_dim=3, hidden_list=[32, 32]),
    imnet_k=dict(type="MLPRefiner", out_dim=64, hidden_list=[32, 32]),
    imnet_v=dict(type="MLPRefiner", out_dim=64, hidden_list=[32, 32]),
    non_local_attn=False, use_kernels=True)
# the packed decoder weights K3 takes as matrices (the rest are f32)
DECODER_MATRICES = ("kw", "vw", "vout", "qw0", "qw", "wk0", "wvu", "wvc",
                    "wkout")
SWIN_MATRICES = ("wqkv", "wp", "w1", "w2")


def _rel(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def _expect(got: torch.Tensor | None, dtype, what: str) -> None:
    if got is not None:
        assert got.dtype == dtype, f"{what}: {got.dtype}, want {dtype}"


class Recorder:
    """Wraps the wrappers the models call; each call asserts its inputs'
    dtypes and is counted under the wrapper's name."""

    def __init__(self, monkeypatch):
        self.mp, self.calls = monkeypatch, {}

    def wrap(self, mod, name, check):
        fn = getattr(mod, name)

        def checked(*a, **k):
            check(*a)
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*a, **k)
        self.mp.setattr(mod, name, checked)


def _card_rule(monkeypatch):
    """The rule the card applies: bf16 whatever the model dtype."""
    monkeypatch.setattr(kernels, "route_dtype", lambda device, dtype: BF)


def _decoder_checks(rec: Recorder) -> None:
    def maps(feature, csa, *rest):
        _expect(feature, BF, "feature")
        _expect(csa, BF, "csa")

    def decode(feature, csa, gk, gv, wt, ck, pk, *rest):
        maps(feature, csa)
        for name, t in (("gk", gk), ("gv", gv), ("wt", wt)):
            _expect(t, BF, name)
        for k in DECODER_MATRICES:
            if k in pk:
                _expect(pk[k], BF, k)

    def k1(feature, csa, wk0, wvu, wvc):
        maps(feature, csa)
        for name, t in (("wk0", wk0), ("wvu", wvu), ("wvc", wvc)):
            _expect(t, BF, name)

    def k2(feature, wkout, bkout):
        maps(feature, None)
        _expect(wkout, BF, "wkout")

    rec.wrap(mciaosr.dk_ops, "f3p_build", k1)
    rec.wrap(mciaosr.dk_ops, "wt_hoist", k2)
    rec.wrap(mciaosr.dk_ops, "grid_decode", decode)
    rec.wrap(mciaosr.dk_ops, "grid_decode_rational", decode)


def _swin_checks(rec: Recorder, mod) -> None:
    def block(x, pk, *rest):
        _expect(x, F32, "x")
        for k in SWIN_MATRICES:
            _expect(pk[k], BF, k)

    rec.wrap(mod, "swin_block", block)


def _route_pair(net, x, scale):
    """decode_grid on the kernel route and on the plain route of the same
    f32 weights, and the bilinear base both add in f32."""
    with torch.no_grad():
        got = net.decode_grid(x, scale)
        net.use_kernels = False
        try:
            ref = net.decode_grid(x, scale)
        finally:
            net.use_kernels = True
        base = interpolate_bilinear(x, *ref.shape[1:3])
    return got, ref, base


def test_route_dtype_rule():
    """bf16 on a CUDA device whatever the model dtype; the model dtype on
    the CPU."""
    assert kernels.route_dtype(torch.device("cuda", 0), F32) == BF
    assert kernels.route_dtype("cuda", BF) == BF
    assert kernels.route_dtype("cpu", F32) == F32
    assert kernels.route_dtype(torch.device("cpu"), BF) == BF


# each CSA middle the route can pick, forced in turn, at ×4 (K3) and at
# ×2.5 (K3's rational mode)
@pytest.mark.parametrize("scale,decode", [(4, "grid_decode"),
                                          (2.5, "grid_decode_rational")],
                         ids=["x4", "x2.5"])
@pytest.mark.parametrize("mode,middle", [
    ("stencil_fused", "csa_stencil_fused"), ("stencil", "csa_stencil"),
    ("resident", "csa_fused"), ("streaming", "csa_attention")])
def test_f32_flagship_kernel_route_takes_bf16(monkeypatch, mode, middle,
                                              scale, decode):
    _card_rule(monkeypatch)
    net = build_generator(dict(SMALL, use_kernels=True), device="cpu",
                          seed=11)
    assert net.dtype == F32
    rec = Recorder(monkeypatch)
    _decoder_checks(rec)
    monkeypatch.setattr(mcsa, "csa_route", lambda *a: mode)

    def csa_maps(match, keys, embed_or_v, *rest):
        for name, t in (("match", match), ("keys", keys),
                        ("embed", embed_or_v)):
            _expect(t, BF, f"{middle} {name}")
    rec.wrap(mcsa, middle, csa_maps)
    x = torch.as_tensor(np.random.default_rng(12).random(
        (1, 16, 16, 3), dtype=np.float32)) - 0.45
    got, ref, base = _route_pair(net, x, scale)
    assert rec.calls == {middle: 1, "f3p_build": 1, "wt_hoist": 1,
                         decode: 1}
    assert got.dtype == ref.dtype == F32 and got.shape == ref.shape
    assert _rel(got, ref) <= REL_TOL
    # the f32 bilinear residual dominates the output: the decoder's own
    # part too
    assert _rel(got - base, ref - base) <= REL_TOL


@pytest.mark.parametrize("scale,decode", [(4, "grid_decode"),
                                          (2.5, "grid_decode_rational")],
                         ids=["x4", "x2.5"])
def test_f32_swinir_kernel_route_takes_bf16(monkeypatch, scale, decode):
    """Eval: each Swin block's kernel gets the bf16 packing and the f32
    map, the decode kernels bf16 maps; the encoder's features and the
    output agree with the plain f32 route."""
    _card_rule(monkeypatch)
    net = build_generator(SWIN_SMALL, device="cpu", seed=13)
    assert net.dtype == F32
    rec = Recorder(monkeypatch)
    _decoder_checks(rec)
    _swin_checks(rec, mswin)
    x = torch.as_tensor(np.random.default_rng(14).random(
        (1, 16, 24, 3), dtype=np.float32)) - 0.45
    with torch.no_grad():
        feat = net.gen_feature(x)
        net.use_kernels = False
        try:
            feat_ref = net.gen_feature(x)
        finally:
            net.use_kernels = True
    assert rec.calls == {"swin_block": 2}
    assert feat.dtype == F32 and _rel(feat, feat_ref) <= REL_TOL
    rec.calls.clear()
    got, ref, base = _route_pair(net, x, scale)
    assert rec.calls == {"swin_block": 2, "f3p_build": 1, "wt_hoist": 1,
                         decode: 1}
    assert _rel(got, ref) <= REL_TOL
    assert _rel(got - base, ref - base) <= REL_TOL


def test_f32_swinir_training_route_takes_bf16(monkeypatch):
    """Under autograd (rows 11 and 12 through ``SwinBlockFunction``) the
    forward and the backward get the bf16 packing and f32 maps; the
    features and x's gradient agree with the plain f32 route."""
    _card_rule(monkeypatch)
    net = build_generator(SWIN_SMALL, device="cpu", seed=15)
    rec = Recorder(monkeypatch)
    _swin_checks(rec, sb)

    def bwd(x, dy, pk, *rest):
        _expect(x, F32, "x")
        _expect(dy, F32, "dy")
        for k in SWIN_MATRICES:
            _expect(pk[k], BF, k)
    rec.wrap(sb, "swin_block_bwd", bwd)
    x0 = torch.as_tensor(np.random.default_rng(16).random(
        (2, 16, 16, 3), dtype=np.float32)) - 0.45
    outs = {}
    for use_kernels in (True, False):
        net.use_kernels = use_kernels
        x = x0.clone().requires_grad_()
        feat = net.gen_feature(x)
        feat.square().mean().backward()
        outs[use_kernels] = (feat.detach(), x.grad)
        net.zero_grad(set_to_none=True)
    net.use_kernels = True
    assert rec.calls == {"swin_block": 2, "swin_block_bwd": 2}
    (feat, dx), (feat_ref, dx_ref) = outs[True], outs[False]
    assert _rel(feat, feat_ref) <= REL_TOL
    assert _rel(dx, dx_ref) <= REL_TOL
