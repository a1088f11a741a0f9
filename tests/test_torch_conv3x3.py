"""The f32 3×3 conv of the SwinIR trunk (ops/kernels/conv3x3.py,
csrc/conv3x3_f32_sm90.cu) and its route.

CPU: the wrapper is ``F.conv2d`` on CPU tensors; the weight's tap-major
re-layout round-trips; ``Conv3x3Function`` gives ``F.conv2d``'s output and
gradients bit for bit; the SwinIR trunk takes the route for its square
3×3 convs (each RSTB's and conv_after_body) only in an f32 model with
``use_kernels``, conv_first and bf16 models keep ``conv``, and the trunk's
features and gradients on the route equal those of ``conv`` everywhere.

Card (marked ``cuda``; skips without one): the kernel against ``F.conv2d``
in float64 (an error bound every f32 summation order meets) and in f32
with TF32 off, at the 002 training batch (6 × 64² × 180), 001 swinir's
(10 × 48² × 180), a ragged 1 × 47 × 60 and small widths; the same bits on
two launches; the Function's gradients bit-equal to ``F.conv2d``
autograd's; 7 launches a trunk forward; no FFT kernel in a profiled
training step of the 002 generator. This file imports no JAX: on the card
run ``python -m pytest --noconftest -q tests/test_torch_conv3x3.py``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import ciaosr_torch.models.swinir as mswin
import ciaosr_torch.ops.kernels.conv3x3 as c3
from ciaosr_torch.models.rdn import conv
from ciaosr_torch.ops import kernels

# every test worker imports every test file: keep torch's CPU pool small
if torch.get_num_threads() > 2:
    torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
F32 = torch.float32


def _inputs(shape, cout, seed, device="cpu"):
    """x (B, H, W, Cin) and a conv's weight and bias at PyTorch's default
    init scale, from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    b, h, w, cin = shape
    bound = 1 / np.sqrt(9 * cin)
    x = rng.standard_normal(shape, dtype=np.float32)
    wt = rng.uniform(-bound, bound, (cout, cin, 3, 3)).astype(np.float32)
    bias = rng.uniform(-bound, bound, cout).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (x, wt, bias))


# ------------------------------------------------------------------- CPU
@pytest.mark.parametrize("shape,cout", [((2, 9, 11, 12), 8),
                                        ((1, 5, 7, 4), 4),
                                        ((1, 6, 6, 180), 180)],
                         ids=["12to8", "4to4", "180to180"])
def test_wrapper_is_conv2d_on_cpu(shape, cout):
    x, w, b = _inputs(shape, cout, 1)
    got = c3.conv3x3(x, w, b)
    ref = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=1)
    assert got.shape == (*shape[:3], cout)
    assert torch.equal(got, ref.permute(0, 2, 3, 1))


def test_weight_relayout_round_trips():
    _, w, _ = _inputs((1, 1, 1, 12), 8, 2)
    wt = c3.relayout_weight(w)
    assert wt.shape == (9 * 12, 8) and wt.is_contiguous()
    for dy in range(3):
        for dx in range(3):
            for ci in (0, 5, 11):
                assert torch.equal(wt[(3 * dy + dx) * 12 + ci],
                                   w[:, ci, dy, dx])
    assert torch.equal(wt.reshape(3, 3, 12, 8).permute(3, 2, 0, 1), w)


def test_wrapper_refuses_a_weight_of_other_widths():
    x, w, b = _inputs((1, 4, 4, 12), 8, 3)
    with pytest.raises(ValueError, match="weight must be"):
        c3.conv3x3(x, w[:, :8].contiguous(), b)


@pytest.mark.parametrize("x_grad", [True, False], ids=["x_grad", "no_x_grad"])
def test_function_is_conv2d_with_its_gradients_on_cpu(x_grad):
    """Output, dx, dw, db bit for bit those of ``F.conv2d`` on the NCHW
    view of an NHWC map (as the trunk hands it); without x's gradient
    (conv_first's case) the backward leaves it out."""
    x, w, b = _inputs((2, 8, 10, 12), 12, 4)
    w.requires_grad_(), b.requires_grad_()
    x.requires_grad_(x_grad)
    xv = x.permute(0, 3, 1, 2)
    got = c3.Conv3x3Function.apply(xv, w, b)
    ref = F.conv2d(xv, w, b, padding=1)
    assert torch.equal(got, ref) and got.stride() == ref.stride()
    dy = torch.as_tensor(np.random.default_rng(5).standard_normal(
        tuple(ref.shape), dtype=np.float32))
    leaves = (x, w, b) if x_grad else (w, b)
    for g, r in zip(torch.autograd.grad(got, leaves, dy),
                    torch.autograd.grad(ref, leaves, dy)):
        assert torch.equal(g, r)


def _trunk(seed=6):
    torch.manual_seed(seed)
    return mswin.SwinIR(embed_dim=12, depths=(2, 2), num_heads=(3, 3),
                        window_size=8)


class _Counter:
    """Counts the trunk's calls of the route's Function and of ``conv``."""

    def __init__(self, monkeypatch):
        self.routed = self.conv = 0
        apply = c3.Conv3x3Function.apply

        def routed(*a):
            self.routed += 1
            return apply(*a)

        def counted_conv(*a, **k):
            self.conv += 1
            return conv(*a, **k)
        monkeypatch.setattr(mswin.Conv3x3Function, "apply", routed)
        monkeypatch.setattr(mswin, "conv", counted_conv)


@pytest.mark.parametrize("dtype,use_kernels,routed", [
    (torch.float32, True, 3), (torch.bfloat16, True, 0),
    (torch.float32, False, 0), (torch.bfloat16, False, 0)],
    ids=["f32_kernels", "bf16_kernels", "f32_plain", "bf16_plain"])
def test_trunk_takes_the_route_only_in_f32_with_kernels(monkeypatch, dtype,
                                                        use_kernels, routed):
    """Two RSTBs: their convs and conv_after_body take the route (3) in an
    f32 model with kernels; conv_first always keeps ``conv``."""
    net = _trunk()
    count = _Counter(monkeypatch)
    x = torch.as_tensor(np.random.default_rng(7).random(
        (1, 8, 16, 3), dtype=np.float32))
    with torch.no_grad():
        net(x, dtype, use_kernels)
    assert (count.routed, count.conv) == (routed, 4 - routed)


def test_trunk_route_equals_conv_with_its_gradients(monkeypatch):
    """On the CPU the route runs ``F.conv2d``: the f32 trunk with kernels
    gives the features and every parameter's gradient of the same trunk
    with ``conv`` in place of the route, bit for bit."""
    net = _trunk()
    x = torch.as_tensor(np.random.default_rng(8).random(
        (2, 8, 16, 3), dtype=np.float32))

    def run():
        net.zero_grad(set_to_none=True)
        feat = net(x, F32, True)
        feat.square().mean().backward()
        return feat.detach(), {n: p.grad for n, p in net.named_parameters()}

    got, got_grads = run()
    monkeypatch.setattr(mswin, "trunk_conv",
                        lambda x, layer, dtype, use_kernels:
                        conv(x, layer, dtype))
    ref, ref_grads = run()
    assert torch.equal(got, ref)
    assert got_grads.keys() == ref_grads.keys()
    for n, g in got_grads.items():
        assert torch.equal(g, ref_grads[n]), n


# ------------------------------------------------------------------ card
U = 2.0 ** -24   # f32 unit round-off


@pytest.fixture
def card():
    """Skip without a card (decided at set-up, not at import); TF32 off
    for the test, as in the training configuration."""
    if not torch.cuda.is_available():
        pytest.skip("the f32 conv kernel needs a CUDA card")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", torch.cuda.current_device())
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


CARD_SHAPES = [((6, 64, 64, 180), 180), ((10, 48, 48, 180), 180),
               ((1, 47, 60, 180), 180), ((2, 19, 23, 4), 4),
               ((2, 19, 23, 12), 12)]
CARD_IDS = ["6x64x64x180", "10x48x48x180", "1x47x60x180", "C4", "C12"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout", CARD_SHAPES, ids=CARD_IDS)
def test_kernel_matches_conv2d(card, shape, cout):
    """Against float64: each output within γ_n·(Σ|w·x| + |b|), n = 9·Cin + 1
    terms, γ_n = n·u/(1 − n·u) — the bound of any order of f32
    multiply-adds over those terms, so any correct f32 sum meets it.
    Against ``F.conv2d`` in f32: cuDNN's result is held to the same bound
    (its FFT route included), so the two f32 results lie within twice it
    of each other, element by element."""
    x, w, b = _inputs(shape, cout, 9, card)
    got = c3.conv3x3(x, w, b)
    torch.cuda.synchronize()
    xd = x.double().permute(0, 3, 1, 2)
    ref64 = F.conv2d(xd, w.double(), b.double(), padding=1).permute(
        0, 2, 3, 1)
    mag = F.conv2d(xd.abs(), w.double().abs(), b.double().abs(),
                   padding=1).permute(0, 2, 3, 1)
    n = 9 * shape[3] + 1
    bound = n * U / (1 - n * U) * mag
    err = (got.double() - ref64).abs()
    assert got.shape == ref64.shape and got.is_contiguous()
    assert bool((err <= bound).all()), float((err / bound).max())
    lib = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=1).permute(
        0, 2, 3, 1).double()
    assert bool(((lib - ref64).abs() <= bound).all())
    assert bool(((got.double() - lib).abs() <= 2 * bound).all())


@pytest.mark.cuda
def test_kernel_same_bits_on_two_launches(card):
    x, w, b = _inputs((6, 64, 64, 180), 180, 10, card)
    first = c3.conv3x3(x, w, b)
    for _ in range(3):
        assert torch.equal(c3.conv3x3(x, w, b), first)


@pytest.mark.cuda
def test_kernel_refuses_widths_off_four(card):
    x, w, b = _inputs((1, 8, 8, 6), 6, 11, card)
    with pytest.raises(ValueError, match="multiples of 4"):
        c3.conv3x3(x, w, b)


@pytest.mark.cuda
def test_function_gradients_bit_equal_conv2d(card):
    """The backward is ``aten.convolution_backward`` on autograd's own
    arguments: dx, dw, db bit for bit those of ``F.conv2d`` autograd at the
    002 training batch. With cuDNN's deterministic algorithms: its default
    dgrad at this shape gives other bits for dx from one call to the next,
    ``F.conv2d`` against itself included."""
    x, w, b = _inputs((6, 64, 64, 180), 180, 12, card)
    dy = torch.as_tensor(np.random.default_rng(13).standard_normal(
        (6, 180, 64, 64), dtype=np.float32), device=card)
    dy = dy.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    grads = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for fn in (c3.Conv3x3Function.apply,
                   lambda xv, w, b: F.conv2d(xv, w, b, padding=1)):
            leaves = [t.clone().requires_grad_() for t in (x, w, b)]
            out = fn(leaves[0].permute(0, 3, 1, 2), leaves[1], leaves[2])
            grads.append(torch.autograd.grad(out, leaves, dy))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for g, r in zip(*grads):
        assert torch.equal(g, r)


def _gen_002(card, depths=None):
    from ciaosr_torch.config import Config
    from ciaosr_torch.models.builder import build_generator
    (path,) = (ROOT / "configs").glob("002_real_wogan_*.py")
    cfg = dict(Config.fromfile(str(path)).model["generator"],
               use_kernels=True)
    if depths is not None:
        cfg["encoder"] = dict(cfg["encoder"], depths=depths)
    return build_generator(cfg, device=card, seed=14)


@pytest.mark.cuda
def test_seven_launches_a_trunk_forward(card):
    """The 002 trunk (six RSTBs, depth cut to 1) in f32 with kernels: six
    RSTB convs and conv_after_body."""
    net = _gen_002(card, depths=[1] * 6)
    assert net.dtype == F32
    x = torch.rand(1, 24, 32, 3, device=card)
    n0 = kernels.LAUNCHES["conv3x3_f32"]
    with torch.no_grad():
        net.gen_feature(x)
    assert kernels.LAUNCHES["conv3x3_f32"] - n0 == 7


@pytest.mark.cuda
def test_no_fft_kernel_in_a_training_step(card):
    """One profiled step of the 002 generator at its training batch (6 ×
    64² LR, 4096 queries a patch; forward, L1, backward, Adam) after one
    unprofiled: no kernel of cuDNN's FFT route (a name holding "fft" or
    the complex GEMM's "cf32") and 7 launches of the f32 conv."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    net = _gen_002(card).train()
    opt = torch.optim.Adam(net.parameters(), lr=2e-4, betas=(0.9, 0.99))
    g = torch.Generator(device=card).manual_seed(15)
    lq = torch.rand(6, 64, 64, 3, device=card, generator=g)
    coord = torch.rand(6, 4096, 2, device=card, generator=g) * 2 - 1
    cell = torch.full((6, 4096, 2), 2 / 256, device=card)
    gt = torch.rand(6, 4096, 3, device=card, generator=g)

    def step():
        opt.zero_grad(set_to_none=True)
        (net(lq, coord, cell) - gt).abs().mean().backward()
        opt.step()

    step()
    torch.cuda.synchronize()
    n0 = kernels.LAUNCHES["conv3x3_f32"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA}
    assert kernels.LAUNCHES["conv3x3_f32"] - n0 == 7
    assert any("conv3x3" in k for k in names), sorted(names)
    assert not [k for k in names if "fft" in k.lower() or "cf32" in k]
