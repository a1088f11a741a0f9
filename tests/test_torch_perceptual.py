"""The port's VGG19 features and perceptual loss against the JAX
package's, f32 on the CPU.

* ``VGG19Features`` taps (conv outputs before their ReLU at 2, 7, 16, 25
  and 34; a ReLU and a pool output too) from flax params carried by
  ``vgg19_state_dict_from_jax``: max|Δ|/max|ref| ≤ 1e-5 per tap.
* A torchvision-layout ``vgg19`` state dict written by the test with
  ``torch.save`` (``features.N`` keys and a classifier), loaded by both
  packages' ``PerceptualLoss(pretrained=...)``: the same perceptual and
  style losses (≤ 1e-5 relative) under L1 and MSE, with and without
  ``norm_img``; the same file without the ``features.`` prefix.
* The lazy loading order: the missing-weights error, the
  ``CIAOSR_VGG19_WEIGHTS`` file and the explicit synthetic opt-in.
* VGG's parameters are frozen and gradients reach the prediction.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciaosr_torch.convert.from_jax import vgg19_state_dict_from_jax
from ciaosr_torch.losses.perceptual import PerceptualLoss
from ciaosr_torch.models.vgg import VGG19_CONVS, VGG19Features
from ciaosr_tpu.losses.perceptual import PerceptualLoss as JaxPerceptual
from ciaosr_tpu.models.vgg import VGG19Features as JaxVGG
from tests.test_torch_weights import ROOT  # noqa: F401  (caps torch threads)

LAYER_WEIGHTS = {"2": 0.1, "7": 0.1, "16": 1.0, "25": 1.0, "34": 1.0}
TOL = 1e-5


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _images(seed, n=2, side=32):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (n, side, side, 3)).astype(np.float32)
            for _ in range(2)]


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


_apply = jax.jit(lambda net, p, x: net.apply(p, x), static_argnums=0)


def test_vgg_taps_match_jax():
    taps = (2, 3, 4, 7, 16, 25, 34)
    jnet = JaxVGG(layer_name_list=taps)
    x, _ = _images(0)
    params = jax.tree.map(np.asarray, jax.jit(jnet.init)(
        jax.random.PRNGKey(3), jnp.asarray(x)))
    net = VGG19Features(taps)
    net.load_state_dict(vgg19_state_dict_from_jax(params), strict=True)
    assert len(net.features) == 35   # built up to the deepest tap only
    ref = _apply(jnet, params, jnp.asarray(x))
    with torch.no_grad():
        got = net(_nchw(x))
    assert set(got) == set(ref) == set(taps)
    for k in taps:
        assert _rel(got[k].permute(0, 2, 3, 1).numpy(), ref[k]) <= TOL, k
    # tap 2 is conv1_2's output before its ReLU: it has negative values
    assert float(got[2].min()) < 0 and float(got[3].min()) >= 0


@pytest.fixture(scope="module")
def vgg_file(tmp_path_factory):
    """A torchvision vgg19 state dict of seeded weights (He-normal, so the
    deep taps stay O(1)), with a classifier the loss leaves out."""
    rng = np.random.default_rng(11)
    sd, cin = {}, 3
    for idx, cout in zip(VGG19_CONVS, (64, 64, 128, 128) + (256,) * 4
                         + (512,) * 8):
        std = (2.0 / (9 * cin)) ** 0.5
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            (rng.standard_normal((cout, cin, 3, 3)) * std).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            (rng.standard_normal(cout) * 0.01).astype(np.float32))
        cin = cout
    sd["classifier.0.weight"] = torch.zeros(4, 8)
    root = tmp_path_factory.mktemp("vgg")
    torch.save(sd, root / "vgg19.pth")
    torch.save({k[len("features."):]: v for k, v in sd.items()
                if k.startswith("features.")}, root / "vgg19_features.pth")
    return root


@pytest.mark.parametrize("criterion", ["l1", "mse"])
@pytest.mark.parametrize("norm_img", [False, True], ids=["", "norm_img"])
def test_perceptual_and_style_match_jax(vgg_file, criterion, norm_img):
    kw = dict(layer_weights=dict(LAYER_WEIGHTS), perceptual_weight=1.0,
              style_weight=0.5, norm_img=norm_img, criterion=criterion,
              pretrained=str(vgg_file / "vgg19.pth"))
    x, gt = _images(1)
    p_ref, s_ref = JaxPerceptual(**kw)(jnp.asarray(x), jnp.asarray(gt))
    p_got, s_got = PerceptualLoss(**kw)(_nchw(x), _nchw(gt))
    assert abs(float(p_got) - float(p_ref)) <= TOL * abs(float(p_ref))
    assert abs(float(s_got) - float(s_ref)) <= TOL * abs(float(s_ref))


def test_features_only_file_and_gradients(vgg_file):
    kw = dict(layer_weights=dict(LAYER_WEIGHTS), style_weight=0.0,
              norm_img=False)
    x, gt = _images(2, n=1, side=16)
    full = PerceptualLoss(**kw, pretrained=str(vgg_file / "vgg19.pth"))
    bare = PerceptualLoss(**kw,
                          pretrained=str(vgg_file / "vgg19_features.pth"))
    xt = _nchw(x).requires_grad_(True)
    p_full, style = full(xt, _nchw(gt))
    assert style is None
    p_bare, _ = bare(_nchw(x), _nchw(gt))
    assert torch.equal(p_full.detach(), p_bare)
    p_full.backward()
    assert xt.grad is not None and float(xt.grad.abs().max()) > 0
    assert all(not p.requires_grad and p.grad is None
               for p in full.vgg.parameters())
    ref, _ = JaxPerceptual(**kw, pretrained=str(vgg_file / "vgg19.pth"))(
        jnp.asarray(x), jnp.asarray(gt))
    assert abs(float(p_bare) - float(ref)) <= TOL * abs(float(ref))


def test_missing_weights_raise_and_the_synthetic_opt_in(monkeypatch, caplog,
                                                        vgg_file):
    kw = dict(layer_weights={"2": 1.0})
    x, gt = (_nchw(a) for a in _images(3, n=1, side=8))
    monkeypatch.delenv("CIAOSR_VGG19_WEIGHTS", raising=False)
    monkeypatch.delenv("CIAOSR_VGG19_SYNTHETIC", raising=False)
    loss = PerceptualLoss(**kw)          # builds; the weights load lazily
    with pytest.raises(FileNotFoundError, match="CIAOSR_VGG19_SYNTHETIC"):
        loss(x, gt)
    with pytest.raises(FileNotFoundError, match="pretrained VGG19"):
        PerceptualLoss(**kw, pretrained="/nonexistent/vgg19.pth")(x, gt)

    monkeypatch.setenv("CIAOSR_VGG19_WEIGHTS", str(vgg_file / "vgg19.pth"))
    from_env = PerceptualLoss(**kw)(x, gt)[0]
    from_arg = PerceptualLoss(**kw, pretrained=str(vgg_file / "vgg19.pth"))(
        x, gt)[0]
    assert torch.equal(from_env, from_arg)
    monkeypatch.delenv("CIAOSR_VGG19_WEIGHTS")

    for how in ("argument", "environment"):
        with caplog.at_level(logging.WARNING):
            if how == "argument":
                synth = PerceptualLoss(**kw, pretrained="synthetic")
            else:
                monkeypatch.setenv("CIAOSR_VGG19_SYNTHETIC", "1")
                synth = PerceptualLoss(**kw)
            value = synth(x, gt)[0]
        assert "SYNTHETIC" in caplog.text
        caplog.clear()
        assert torch.isfinite(value) and float(value) > 0
        # seeded: the same weights every time
        again = PerceptualLoss(**kw, pretrained="synthetic")
        again(x, gt)
        assert all(torch.equal(a, b) for a, b in zip(
            synth.vgg.state_dict().values(), again.vgg.state_dict().values()))
