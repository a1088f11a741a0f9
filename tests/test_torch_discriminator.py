"""The port's U-Net SN discriminators against the JAX package's (flax
``nn.SpectralNorm``), f32 on the CPU, from the same variables carried by
``discriminator_state_dict_from_jax`` and the same numpy images.

Both U-Nets (mid_channels 8, 16² and 32² images): the logits (max|Δ| /
max|ref| ≤ 1e-5); the power-iteration state ``u`` and ``sigma`` after a
real-then-fake pair of ``update_stats=True`` calls (≤ 1e-6 abs); an
``update_stats=False`` call leaves both as they were; the gradients with
respect to the input and every weight against ``jax.grad`` (≤ 1e-5
relative per tensor). Also the ×2 upsampling against
``interpolate_bilinear`` and the spectral norm against its definition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciaosr_torch.convert.from_jax import discriminator_state_dict_from_jax
from ciaosr_torch.models import discriminator as td
from ciaosr_torch.ops.sampling import interpolate_bilinear, upsample2x_bilinear
from ciaosr_tpu.models import discriminator as jd
from tests.test_torch_weights import ROOT

CASES = [(jd.UNetDiscriminatorSN, td.UNetDiscriminatorSN, 16),
         (jd.UNetDiscriminatorSN, td.UNetDiscriminatorSN, 32),
         (jd.SmallUNetDiscriminatorSN, td.SmallUNetDiscriminatorSN, 16),
         (jd.SmallUNetDiscriminatorSN, td.SmallUNetDiscriminatorSN, 32)]
IDS = ["unet_16", "unet_32", "small_16", "small_32"]


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


# the JAX side compiled once per module and shape (the modules are static)
_init = jax.jit(lambda jm, key, x: jm.init(key, x), static_argnums=0)
_apply = jax.jit(lambda jm, v, x: jm.apply(v, x, update_stats=False),
                 static_argnums=0)
_apply_update = jax.jit(lambda jm, v, x: jm.apply(
    v, x, update_stats=True, mutable=["batch_stats"]), static_argnums=0)


def _loss(jm, update_stats, params, batch_stats, img, w):
    variables = {"params": params, "batch_stats": batch_stats}
    if update_stats:
        out = jm.apply(variables, img, update_stats=True,
                       mutable=["batch_stats"])[0]
    else:
        out = jm.apply(variables, img, update_stats=False)
    return jnp.sum(out * w)


_grad = jax.jit(jax.grad(_loss, argnums=(2, 4)), static_argnums=(0, 1))


def _case(jcls, tcls, side, seed=0):
    """(flax module, its variables, the port's module with them, two
    NHWC images)."""
    jm = jcls(mid_channels=8)
    rng = np.random.default_rng(seed)
    imgs = [rng.standard_normal((2, side, side, 3)).astype(np.float32)
            for _ in range(2)]
    variables = jax.tree.map(np.asarray, _init(
        jm, jax.random.PRNGKey(seed), jnp.asarray(imgs[0])))
    tm = tcls(mid_channels=8)
    tm.load_state_dict(discriminator_state_dict_from_jax(variables),
                       strict=True)
    return jm, variables, tm, imgs


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _stats(tm) -> dict:
    return {k: v.clone() for k, v in tm.state_dict().items()
            if k.endswith((".u", ".sigma"))}


@pytest.mark.parametrize("jcls,tcls,side", CASES, ids=IDS)
def test_logits_and_stats_match_jax(jcls, tcls, side):
    jm, variables, tm, (real, fake) = _case(jcls, tcls, side)
    # a real-then-fake pair of update_stats=True calls, as the D step
    ref_r, mut = _apply_update(jm, variables, jnp.asarray(real))
    ref_f, mut = _apply_update(jm, {"params": variables["params"], **mut},
                               jnp.asarray(fake))
    with torch.no_grad():
        got_r = tm(_nchw(real), update_stats=True)
        got_f = tm(_nchw(fake), update_stats=True)
    for got, ref in ((got_r, ref_r), (got_f, ref_f)):
        assert got.shape == (2, 1, side, side)
        assert _rel(got.permute(0, 2, 3, 1).numpy(), ref) <= 1e-5
    want = discriminator_state_dict_from_jax(
        {"params": {}, "batch_stats": jax.tree.map(np.asarray,
                                                   mut["batch_stats"])})
    got = _stats(tm)
    assert set(got) == set(want) and len(got) >= 12
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("jcls,tcls,side", CASES[::2], ids=IDS[::2])
def test_update_stats_false_keeps_the_stats(jcls, tcls, side):
    jm, variables, tm, (x, _) = _case(jcls, tcls, side, seed=1)
    before = _stats(tm)
    with torch.no_grad():
        got = tm(_nchw(x))    # update_stats=False, the default
    after = _stats(tm)
    assert all(torch.equal(before[k], after[k]) for k in before)
    ref = _apply(jm, variables, jnp.asarray(x))
    assert _rel(got.permute(0, 2, 3, 1).numpy(), ref) <= 1e-5
    # one power-iteration step on every call: a second call with stored
    # stats gives another output than the first's stats-free reading
    with torch.no_grad():
        tm(_nchw(x), update_stats=True)
        again = tm(_nchw(x))
    assert not torch.equal(again, got)


@pytest.mark.parametrize(
    "jcls,tcls,side,update_stats",
    [c + (u,) for c, u in zip(CASES, (False, True, True, False))],
    ids=[f"{i}-{u}" for i, u in zip(IDS, ("frozen_stats", "update_stats",
                                          "update_stats", "frozen_stats"))])
def test_gradients_match_jax(jcls, tcls, side, update_stats):
    jm, variables, tm, (x, w) = _case(jcls, tcls, side, seed=2)
    g_params, g_img = _grad(jm, update_stats, variables["params"],
                            variables["batch_stats"], jnp.asarray(x),
                            jnp.asarray(w[..., :1]))
    xt = _nchw(x).requires_grad_(True)
    out = tm(xt, update_stats=update_stats)
    (out * _nchw(w[..., :1].copy())).sum().backward()
    assert _rel(xt.grad.permute(0, 2, 3, 1).numpy(), g_img) <= 1e-5
    want = discriminator_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, g_params)})
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k].numpy(), want[k].numpy()) <= 1e-5, k


def test_spectral_norm_is_flax_power_iteration():
    """σ = v W uᵀ with v = l2n(u Wᵀ), u' = l2n(v W) on the HWIO-ordered
    (kh·kw·in, out) kernel, and the conv runs with W / σ."""
    torch.manual_seed(0)
    conv = td.SNConv2d(4, 6, 3)
    u0 = conv.u.clone()
    w = conv.weight.detach().permute(2, 3, 1, 0).reshape(-1, 6).double()
    v = u0.double() @ w.t()
    v = v / v.norm()
    u = v @ w
    u = u / u.norm()
    sigma = float(v @ w @ u.t())
    got = conv.normalized_weight(update_stats=True)
    np.testing.assert_allclose(got.detach().numpy(),
                               (conv.weight.detach().double() / sigma).numpy(),
                               rtol=1e-6, atol=0)
    assert abs(float(conv.sigma) - sigma) <= 1e-6 * sigma
    np.testing.assert_allclose(conv.u.double().numpy(), u.numpy(), atol=1e-6)


@pytest.mark.parametrize("hw", [(1, 1), (4, 6), (7, 5)])
def test_upsample2x_matches_interpolate_bilinear(hw):
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 3, *hw)).astype(np.float32))
    ref = interpolate_bilinear(x.permute(0, 2, 3, 1), 2 * hw[0], 2 * hw[1])
    torch.testing.assert_close(upsample2x_bilinear(x),
                               ref.permute(0, 3, 1, 2), atol=1e-6, rtol=0)


def test_no_torch_spectral_norm_in_the_port():
    for path in (ROOT / "ciaosr_torch").rglob("*.py"):
        text = path.read_text()
        assert "utils.spectral_norm" not in text, path
        assert "parametrizations.spectral_norm" not in text, path
