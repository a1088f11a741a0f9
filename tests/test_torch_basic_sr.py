"""The fixed-scale restorer in the port against the JAX package, f32 on
the CPU, the same weights (carried by ``basic_sr_state_dict_from_jax``):
``pixel_shuffle`` and ``PixelShuffleUpsample`` (×2, ×3, ×4, ×8; ×5 a
ValueError in both), the ``EDSRNet`` and ``RDNNet`` forwards (≤ 1e-5
abs), the converter's leaf count, ``BasicRestorer.predict`` with and
without the window pad (≤ 1e-5 abs) and its ``evaluate``, 3 train steps
of ``make_train_step`` with Adam (losses and weights ≤ 1e-5 relative),
``build_model`` on a ``BasicRestorer`` config, and the trainer's
``batch_keys``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_weights as tw
from ciaosr_torch.convert.from_jax import basic_sr_state_dict_from_jax
from ciaosr_torch.models import builder
from ciaosr_torch.models.basic_sr import (EDSRNet, PixelShuffleUpsample,
                                          RDNNet, pixel_shuffle)
from ciaosr_torch.models.builder import build_model
from ciaosr_torch.models.restorers import BasicRestorer
from ciaosr_torch.train.optim import build_optimizer
from ciaosr_torch.train.trainer import TrainState, make_train_step
from ciaosr_tpu.models import basic_sr as jax_basic_sr
from ciaosr_tpu.models.builder import build_model as jax_build_model
from ciaosr_tpu.models.restorers import BasicRestorer as JaxBasicRestorer
from ciaosr_tpu.train import optim as jax_optim
from ciaosr_tpu.train import trainer as jax_trainer

# the nets at test widths: mid 8, 2 blocks (RDN: 2 layers, growth 4)
EDSR_SMALL = dict(type="EDSRNet", mid_channels=8, num_blocks=2,
                  res_scale=0.5, rgb_mean=(0.3, 0.5, 0.6),
                  rgb_std=(0.9, 1.1, 0.8))
RDN_SMALL = dict(type="RDNNet", mid_channels=8, num_blocks=2, num_layers=2,
                 channel_growth=4)
FAMILY = {"EDSRNet": "edsr", "RDNNet": "rdn"}
ADAM = dict(type="Adam", lr=1e-4)
LR_CFG = dict(policy="Step", by_epoch=False, step=[2], gamma=0.5)
ATOL = 1e-5


def jax_restorer(gen: dict, scale: int, test_cfg=None, seed: int = 0):
    """(JAX BasicRestorer, seeded params) of ``gen`` at ``scale``."""
    res = JaxBasicRestorer(generator=dict(gen, upscale_factor=scale),
                           test_cfg=test_cfg)
    return res, tw.seeded_params(res.generator, seed,
                                 jnp.zeros((1, 8, 8, 3)))


def port_restorer(gen: dict, scale: int, params, test_cfg=None):
    """The port's BasicRestorer of ``gen`` on the CPU with JAX's
    ``params``."""
    res = BasicRestorer(dict(gen, upscale_factor=scale), test_cfg=test_cfg,
                        device="cpu")
    res.generator.load_state_dict(basic_sr_state_dict_from_jax(
        params, FAMILY[gen["type"]]), strict=True)
    return res


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle_matches_jax(rng, r):
    x = rng.random((2, 4, 5, 6 * r * r), dtype=np.float32)
    ref = np.asarray(jax_basic_sr.pixel_shuffle(jnp.asarray(x), r))
    got = pixel_shuffle(torch.from_numpy(x), r).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("scale", [2, 3, 4, 8])
def test_upsample_matches_jax(rng, scale):
    x = rng.random((1, 5, 6, 8), dtype=np.float32)
    mod = jax_basic_sr.PixelShuffleUpsample(scale, 8)
    params = tw.seeded_params(mod, scale, jnp.asarray(x))
    ref = np.asarray(jax.jit(mod.apply)(params, jnp.asarray(x)))
    up = PixelShuffleUpsample(scale, 8)
    sd = {}
    for name, p in params["params"].items():
        i = int(name[len("up_"):])
        sd[f"{i}.weight"] = torch.from_numpy(
            np.asarray(p["kernel"]).transpose(3, 2, 0, 1).copy())
        sd[f"{i}.bias"] = torch.from_numpy(np.asarray(p["bias"]))
    up.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = up(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 5 * scale, 6 * scale, 8)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_upscale_factor_5_raises_in_both():
    with pytest.raises(ValueError, match="unsupported upscale factor 5"):
        PixelShuffleUpsample(5, 8)
    with pytest.raises(ValueError, match="unsupported upscale factor 5"):
        tw.seeded_params(jax_basic_sr.PixelShuffleUpsample(5, 8), 0,
                         jnp.zeros((1, 4, 4, 8)))


@pytest.mark.parametrize("gen,scale", [(EDSR_SMALL, 3), (EDSR_SMALL, 4),
                                       (RDN_SMALL, 2), (RDN_SMALL, 4)],
                         ids=["edsr-x3", "edsr-x4", "rdn-x2", "rdn-x4"])
def test_net_forward_matches_jax(rng, gen, scale):
    jr, params = jax_restorer(gen, scale, seed=scale)
    x = rng.random((2, 7, 9, 3), dtype=np.float32)
    ref = np.asarray(jax.jit(jr.generator.apply)(params, jnp.asarray(x)))
    net = port_restorer(gen, scale, params).generator
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert got.shape == ref.shape == (2, 7 * scale, 9 * scale, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("gen", [EDSR_SMALL, RDN_SMALL],
                         ids=["edsr", "rdn"])
def test_converter_consumes_every_leaf(gen):
    _, params = jax_restorer(gen, 4)
    sd = basic_sr_state_dict_from_jax(params, FAMILY[gen["type"]])
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(sd) == n_leaves
    assert set(sd) == set(BasicRestorer(dict(gen, upscale_factor=4),
                                        device="cpu").generator.state_dict())
    extra = jax.tree.map(np.asarray, params)
    extra["params"]["stray"] = {"kernel": np.zeros((3, 3, 8, 8))}
    with pytest.raises(KeyError, match="1 JAX leaves left over"):
        basic_sr_state_dict_from_jax(extra, FAMILY[gen["type"]])


@pytest.mark.parametrize("window", [4, 1])
@pytest.mark.parametrize("gen,scale", [(EDSR_SMALL, 2), (RDN_SMALL, 3)],
                         ids=["edsr-x2", "rdn-x3"])
def test_predict_and_evaluate_match_jax(rng, gen, scale, window):
    """10×13 is no multiple of 4: window 4 takes the reflect pad."""
    test_cfg = dict(metrics=["PSNR", "SSIM"], crop_border=scale,
                    window_size=window)
    jr, params = jax_restorer(gen, scale, test_cfg, seed=window)
    port = port_restorer(gen, scale, params, test_cfg)
    lq = rng.random((10, 13, 3), dtype=np.float32)
    ref = jr.predict(params, lq)
    got = port.predict(lq)
    assert got.shape == ref.shape == (10 * scale, 13 * scale, 3)
    assert got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(port.forward_test(lq, (1, 1), 7), got)
    gt = rng.random(ref.shape, dtype=np.float32)
    want = jr.evaluate(ref, gt)
    have = port.evaluate(ref, gt)
    assert set(have) == set(want) == {"PSNR", "SSIM"}
    assert have["PSNR"] == want["PSNR"]
    assert abs(have["SSIM"] - want["SSIM"]) <= 1e-9


@pytest.mark.parametrize("gen,scale", [(EDSR_SMALL, 2), (RDN_SMALL, 3)],
                         ids=["edsr-x2", "rdn-x3"])
def test_train_steps_match_jax(rng, gen, scale):
    """3 steps of each package's make_train_step with Adam and a step
    schedule: the losses and the weights after them."""
    jr, params = jax_restorer(gen, scale, seed=11)
    port = port_restorer(gen, scale, params)
    batches = [dict(lq=rng.random((2, 8, 8, 3), dtype=np.float32),
                    gt=rng.random((2, 8 * scale, 8 * scale, 3),
                                  dtype=np.float32)) for _ in range(3)]

    tx, _ = jax_optim.build_optimizer(dict(ADAM), LR_CFG)
    step = jax_trainer.make_train_step(jr, tx)
    state = jax_trainer.TrainState(step=jnp.asarray(0), params=params,
                                   opt_state=tx.init(params))
    ref_losses = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        ref_losses.append(float(m["loss_pix"]))

    opt, sched = build_optimizer(port.generator.parameters(), ADAM, LR_CFG)
    pstate = TrainState(0, port.generator, opt, sched)
    pstep = make_train_step(port, opt, sched)
    losses = []
    for b in batches:
        pstate, m = pstep(pstate, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        losses.append(float(m["loss_pix"]))
    assert pstate.step == 3
    for got, ref in zip(losses, ref_losses, strict=True):
        assert abs(got - ref) <= 1e-5 * abs(ref)
    want = basic_sr_state_dict_from_jax(state.params, FAMILY[gen["type"]])
    for k, v in port.generator.state_dict().items():
        ref = want[k].numpy()
        err = np.abs(v.numpy() - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), (k, err)


def test_build_model_matches_jax(rng):
    """A BasicRestorer config's model dict through both builders: the
    same generator and test_cfg, the same predictions on the same
    weights."""
    model = dict(type="BasicRestorer", generator=dict(RDN_SMALL,
                                                      upscale_factor=2),
                 pixel_loss=dict(type="L1Loss", loss_weight=1.0,
                                 reduction="mean"))
    test_cfg = dict(metrics=["PSNR", "SSIM"], crop_border=2,
                    window_size=4)
    ref = jax_build_model(model, test_cfg=test_cfg)
    port = build_model(model, test_cfg=test_cfg, device="cpu")
    assert isinstance(port, BasicRestorer) and isinstance(ref,
                                                          JaxBasicRestorer)
    assert isinstance(port.generator, RDNNet)
    assert port.test_cfg == ref.test_cfg
    assert port.pixel_loss_cfg == ref.pixel_loss_cfg
    assert port.device == torch.device("cpu")
    params = tw.seeded_params(ref.generator, 3, jnp.zeros((1, 8, 8, 3)))
    port.generator.load_state_dict(basic_sr_state_dict_from_jax(
        params, "rdn"), strict=True)
    lq = rng.random((9, 14, 3), dtype=np.float32)
    np.testing.assert_allclose(port.predict(lq), ref.predict(params, lq),
                               atol=ATOL, rtol=0)


def test_build_model_gives_kernels_only_to_ciaosr_generators(monkeypatch):
    """On a CUDA device use_kernels goes to a CiaoSR generator only: the
    fixed-scale nets take no such field."""
    seen = []

    class Recorder:
        def __init__(self, **kw):
            seen.append(kw["generator"])

    monkeypatch.setattr(builder, "resolve_device",
                        lambda d: torch.device(d or "cuda"))
    for gen in (EDSR_SMALL, RDN_SMALL):
        build_model(dict(type=Recorder, generator=gen))
    build_model(dict(type=Recorder, generator=tw.SMALL))
    assert seen[:2] == [EDSR_SMALL, RDN_SMALL]
    assert seen[2] == dict(tw.SMALL, use_kernels=True)
    with pytest.raises(TypeError):
        EDSRNet(use_kernels=True)


def test_train_step_reads_batch_keys():
    """make_train_step feeds train_forward the restorer's batch_keys, and
    lq, gt, coord, cell for a restorer without them (as JAX does)."""

    class Fake:
        def __init__(self, keys=None):
            self.w = torch.nn.Parameter(torch.ones(()))
            self.got = None
            if keys:
                self.batch_keys = keys

        def train_forward(self, *args):
            self.got = args
            return self.w * sum(a.sum() for a in args), None

    batch = {k: torch.full((1,), float(i))
             for i, k in enumerate(("lq", "gt", "coord", "cell", "extra"))}
    for keys, want in ((("lq", "gt"), (0.0, 1.0)),
                       (None, (0.0, 1.0, 2.0, 3.0)),
                       (("extra", "lq"), (4.0, 0.0))):
        fake = Fake(keys)
        opt, sched = build_optimizer([fake.w], ADAM)
        make_train_step(fake, opt, sched)(TrainState(0, None, opt, sched),
                                          batch)
        assert tuple(float(a) for a in fake.got) == want
    assert BasicRestorer.batch_keys == JaxBasicRestorer.batch_keys


@pytest.mark.slow
@pytest.mark.parametrize("gen,scale", [
    (dict(type="EDSRNet"), 3),
    (dict(type="RDNNet"), 4)], ids=["edsr-x3", "rdn-x4"])
def test_production_width_forward_matches_jax(rng, gen, scale):
    """The published widths (64 channels, 16 blocks; RDN 8 layers, growth
    64) on a 12×10 image."""
    jr, params = jax_restorer(gen, scale, seed=1)
    x = rng.random((1, 12, 10, 3), dtype=np.float32)
    ref = np.asarray(jax.jit(jr.generator.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port_restorer(gen, scale, params).generator(
            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
