"""The port's GAN and pixel losses against the JAX package's, f32 on the
CPU, the same numpy inputs (NHWC for JAX, NCHW for the port).

Every ``GANLoss`` type × real / fake × discriminator / generator; smgan
with a mask of the prediction's size and of another size (the prediction
resized, align_corners=True) and its blurred-mask target; the three pixel
losses under each reduction, with and without a weight. Tolerance: 1e-6
abs on every value (a sum reduction's: 1e-6 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciaosr_torch.config.registry import LOSSES
from ciaosr_torch.losses import gan as tg
from ciaosr_tpu.losses import gan as jg

TOL = 1e-6


def _pair(a: np.ndarray):
    """(JAX NHWC, port NCHW) of one numpy NHWC array."""
    return jnp.asarray(a), torch.from_numpy(a).permute(0, 3, 1, 2)


def _pred(seed=0, hw=(8, 8)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, *hw, 1)) * 2).astype(np.float32)


@pytest.mark.parametrize("gan_type", tg.GAN_TYPES)
@pytest.mark.parametrize("real", [True, False], ids=["real", "fake"])
@pytest.mark.parametrize("is_disc", [True, False], ids=["disc", "gen"])
def test_gan_loss_matches_jax(gan_type, real, is_disc):
    kw = dict(gan_type=gan_type, real_label_val=0.9, fake_label_val=0.1,
              loss_weight=0.1)
    jp, tp = _pair(_pred())
    ref = float(jg.GANLoss(**kw)(jp, real, is_disc=is_disc))
    got = float(tg.GANLoss(**kw)(tp, real, is_disc=is_disc))
    assert abs(got - ref) <= TOL, (got, ref)


@pytest.mark.parametrize("mask_hw", [(8, 8), (12, 10)],
                         ids=["same_size", "other_size"])
@pytest.mark.parametrize("real", [True, False], ids=["real", "fake"])
@pytest.mark.parametrize("is_disc", [True, False], ids=["disc", "gen"])
def test_smgan_with_mask_matches_jax(mask_hw, real, is_disc):
    rng = np.random.default_rng(1)
    mask = rng.random((2, *mask_hw, 1), dtype=np.float32)
    jp, tp = _pair(_pred(2))
    jm, tm = _pair(mask)
    kw = dict(gan_type="smgan", loss_weight=0.5)
    ref = float(jg.GANLoss(**kw)(jp, real, is_disc=is_disc, mask=jm))
    got = float(tg.GANLoss(**kw)(tp, real, is_disc=is_disc, mask=tm))
    assert abs(got - ref) <= TOL, (got, ref)


def test_smgan_helpers_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    jx, tx = _pair(x)
    got = tg.interp_bilinear_align_corners(tx, 9, 4).permute(0, 2, 3, 1)
    ref = jg._interp_bilinear_align_corners(jx, 9, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=0)
    m = rng.random((1, 20, 24, 2), dtype=np.float32)
    jm, tm = _pair(m)
    got = tg.gaussian_blur_71(tm).permute(0, 2, 3, 1)
    ref = jg.gaussian_blur_71(jm)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("name", ["L1Loss", "MSELoss", "CharbonnierLoss"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True], ids=["", "weighted"])
def test_pixel_losses_match_jax(name, reduction, weighted):
    rng = np.random.default_rng(4)
    pred, target, w = (rng.random((2, 16, 3), dtype=np.float32)
                       for _ in range(3))
    kw = dict(loss_weight=0.7, reduction=reduction)
    ref = getattr(jg, name)(**kw)(jnp.asarray(pred), jnp.asarray(target),
                                  jnp.asarray(w) if weighted else None)
    got = LOSSES.get(name)(**kw)(torch.from_numpy(pred),
                                 torch.from_numpy(target),
                                 torch.from_numpy(w) if weighted else None)
    # a sum of 96 values differs by its order of addition: 1e-6 of it
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=0 if reduction == "sum" else TOL,
                               rtol=TOL if reduction == "sum" else 0)


def test_gan_loss_rejects_unknown_type():
    with pytest.raises(ValueError, match="unsupported gan_type"):
        tg.GANLoss(gan_type="relativistic")
