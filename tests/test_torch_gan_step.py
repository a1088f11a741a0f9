"""The port's GAN train step against the JAX package's, f32 on the CPU.

Both packages start from one ``GANTrainState`` (the generator's seeded
params, an EMA copy apart from them, a flax discriminator's variables)
carried into the port by ``convert/from_jax.py``, with the same VGG19
file and the same numpy batches (B = 2, 16² LR, 256 queries: a
contiguous run of four rows of the ×4 grid, which the √ns reshape makes a
16 × 16 image, as the reference does with ``is_shuffle=False``). Three
steps of ``make_gan_train_step`` each:

* ``gan``: pixel + perceptual (layers 2 and 7) + vanilla GAN, the 002
  routing (sharpened GT in the pixel and perceptual losses), the
  generator re-seeded from its EMA copy at ``start_iter`` 2;
* ``gated``: ``disc_init_steps`` 2 (the generator frozen, zero losses,
  the discriminator learning), the sharpened GT in the GAN;
* ``disc_steps``: ``disc_steps`` 2 (the generator updates on steps 0
  and 2);
* ``wogan``: no discriminator (the generator and EMA only).

After each step: every loss key (≤ 1e-5 relative; the gated zeros
exactly), then the generator, EMA and discriminator parameters (≤ 1e-6
abs, the class of ``tests/test_torch_train.py::
test_train_steps_match_jax``) and the spectral norms' ``u`` and
``sigma`` (≤ 1e-6 abs). The ``gan`` case also on the kernel route (the
kernels' plain versions on the CPU). Also: the √ns reshape of a strip,
and an eval after an EMA update sees the new weights (the Swin blocks'
packed-weight cache).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ciaosr_torch.convert.from_jax import (discriminator_state_dict_from_jax,
                                           state_dict_from_jax)
from ciaosr_torch.core.coords import make_coord_cell
from ciaosr_torch.models.real_restorer import (GANTrainState,
                                               RealCiaoSRRestorer,
                                               query_images)
from ciaosr_torch.train.optim import build_optimizer
from ciaosr_tpu.models import real_restorer as jrr
from ciaosr_tpu.train import optim as jax_optim
from tests.test_torch_perceptual import vgg_file  # noqa: F401  (fixture)
from tests.test_torch_weights import SWIN_SMALL, generator_params

# SGD with momentum: its updates are linear in the gradients, so the
# parameters after three steps hold the gradients' own agreement. Adam's
# first steps divide by |g| + eps and so scale the f32 rounding of a
# near-zero gradient element (1e-5 of its tensor's largest: jit against
# eager within the JAX package alone) by up to lr/eps, past the 1e-6
# bound; Adam itself is held to optax in tests/test_torch_train.py
OPT = dict(type="SGD", lr=1e-2, momentum=0.9)
DISC = dict(type="UNetDiscriminatorWithSpectralNorm", mid_channels=8)
KW = dict(feat_dim=12, n_hidden=2, encoder="swinir", non_local_attn=False)
STEPS = 3
LOSS_TOL, PARAM_TOL = 1e-5, 1e-6


def model_cfg(case: str, vgg: str) -> dict:
    case = {"gated_sched": "gated"}.get(case, case)
    base = dict(generator=SWIN_SMALL,
                pixel_loss=dict(type="L1Loss", loss_weight=1.0))
    gan = dict(discriminator=DISC, gan_loss=dict(
        type="GANLoss", gan_type="vanilla", loss_weight=0.1))
    if case == "gan":
        return dict(base, **gan, perceptual_loss=dict(
            type="PerceptualLoss", layer_weights={"2": 0.1, "7": 0.1},
            perceptual_weight=1.0, style_weight=0, norm_img=False,
            pretrained=vgg), is_use_sharpened_gt_in_pixel=True,
            is_use_sharpened_gt_in_percep=True)
    if case == "gated":
        return dict(base, **gan, is_use_sharpened_gt_in_gan=True)
    if case == "disc_steps":
        return dict(base, **gan)
    return dict(base, is_use_sharpened_gt_in_pixel=True)   # wogan


TRAIN_CFG = {"gan": dict(ema_momentum=0.9, start_iter=2),
             "gated": dict(ema_momentum=0.9, disc_init_steps=2),
             "disc_steps": dict(ema_momentum=0.9, disc_steps=2),
             "gated_sched": dict(ema_momentum=0.9, disc_init_steps=1),
             "wogan": dict(ema_momentum=0.9)}
# the steps on which the generator updates
G_STEPS = {"gan": {0, 1, 2}, "gated": {2}, "gated_sched": {1, 2},
           "disc_steps": {0, 2}, "wogan": {0, 1, 2}}
# a step schedule that halves the learning rate after the first update:
# the generator's two updates (steps 1 and 2) and the discriminator's
# first two (steps 0 and 1) each straddle it
LR_CFG = {"gated_sched": dict(policy="Step", step=[1], gamma=0.5)}


def batches(n: int = STEPS) -> list[dict]:
    """B = 2, 16² LR in [0, 1]; 256 queries: rows 20-23 of the 64² HR
    grid (a strip), gt and gt_unsharp in [0, 1]."""
    coord, cell = make_coord_cell((64, 64))
    coord = coord[20 * 64:24 * 64].numpy()
    cell = cell[:256].numpy()
    rng = np.random.default_rng(8)
    return [dict(lq=rng.random((2, 16, 16, 3), dtype=np.float32),
                 gt=rng.random((2, 256, 3), dtype=np.float32),
                 gt_unsharp=rng.random((2, 256, 3), dtype=np.float32),
                 coord=np.broadcast_to(coord, (2, 256, 2)).copy(),
                 cell=np.broadcast_to(cell, (2, 256, 2)).copy())
            for _ in range(n)]


def snapshot(state) -> dict:
    """A JAX GANTrainState's compared parts as numpy."""
    return dict(g=jax.tree.map(np.asarray, state.g_params),
                ema=jax.tree.map(np.asarray, state.ema_params),
                d=jax.tree.map(np.asarray, state.d_vars))


def jax_state(jres, g_tx, d_tx):
    """The carried start: seeded generator params, an EMA copy 1e-2 away
    from them, the discriminator's flax init."""
    _, g = generator_params(SWIN_SMALL, seed=31)
    rng = np.random.default_rng(32)
    ema = jax.tree.map(lambda a: np.asarray(a) + 1e-2 * rng.standard_normal(
        np.shape(a)).astype(np.float32), g)
    return jres.init_gan_state(jax.random.PRNGKey(33), g_tx, d_tx,
                               lq_shape=(1, 16, 16, 3), n_queries=256,
                               g_params=g, ema_params=jax.tree.map(
                                   jnp.asarray, ema))


_RUNS: dict = {}


def schedule_lr(schedule, opt_state) -> float:
    """optax's learning rate for the next update: the schedule at the
    optimizer state's count, which moves only when an update is applied."""
    if not callable(schedule):
        return float(schedule)
    return float(schedule(optax.tree_utils.tree_get(opt_state, "count")))


def jax_run(case: str, vgg: str):
    """(start, [(losses, snapshot, (G lr, D lr))] per step) of JAX's step,
    memoized; the learning rates are those the step's updates use."""
    if case not in _RUNS:
        jres = jrr.RealCiaoSRRestorer(**model_cfg(case, vgg),
                                      train_cfg=TRAIN_CFG[case])
        g_tx, g_lr = jax_optim.build_optimizer(dict(OPT), LR_CFG.get(case))
        d_tx, d_lr = jax_optim.build_optimizer(dict(OPT), LR_CFG.get(case))
        state = jax_state(jres, g_tx, d_tx)
        start = snapshot(state)
        step = jres.make_gan_train_step(g_tx, d_tx)
        out = []
        for b in batches():
            lrs = (schedule_lr(g_lr, state.g_opt),
                   schedule_lr(d_lr, state.d_opt))
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            out.append(({k: float(v) for k, v in m.items()},
                        snapshot(state), lrs))
        _RUNS[case] = (start, out)
    return _RUNS[case]


def port_restorer(case: str, vgg: str, start: dict,
                  use_kernels: bool = False) -> RealCiaoSRRestorer:
    cfg = model_cfg(case, vgg)
    res = RealCiaoSRRestorer(**dict(cfg, generator=dict(
        cfg["generator"], use_kernels=use_kernels)),
        train_cfg=TRAIN_CFG[case], device="cpu")
    res.generator.load_state_dict(state_dict_from_jax(start["g"], **KW),
                                  strict=True)
    res.generator_ema.load_state_dict(state_dict_from_jax(start["ema"], **KW),
                                      strict=True)
    if res.discriminator is not None:
        res.discriminator.load_state_dict(
            discriminator_state_dict_from_jax(start["d"]), strict=True)
    return res


def port_step(res, lr_cfg=None):
    g_opt, g_sched = build_optimizer(res.generator.parameters(), OPT, lr_cfg)
    d_opt = d_sched = None
    if res.discriminator is not None:
        d_opt, d_sched = build_optimizer(res.discriminator.parameters(), OPT,
                                         lr_cfg)
    state = GANTrainState(0, g_opt, d_opt, g_sched, d_sched)
    return state, res.make_gan_train_step(g_opt, d_opt, (g_sched, d_sched))


def assert_close_sd(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(),
                                   atol=PARAM_TOL, rtol=0,
                                   err_msg=f"{what} {k}")


CASES = [("gan", False), ("gan", True), ("gated", False),
         ("gated_sched", False), ("disc_steps", False), ("wogan", False)]


@pytest.mark.parametrize("case,use_kernels", CASES,
                         ids=["gan", "gan_kernel_route", "gated",
                              "gated_step_schedule", "disc_steps", "wogan"])
def test_gan_steps_match_jax(vgg_file, case, use_kernels):  # noqa: F811
    vgg = str(vgg_file / "vgg19.pth")
    start, ref = jax_run(case, vgg)
    res = port_restorer(case, vgg, start, use_kernels)
    state, step = port_step(res, LR_CFG.get(case))
    assert (state.d_opt is None) == (case == "wogan")
    for i, (b, (ref_losses, ref_state, (g_lr, d_lr))) in enumerate(
            zip(batches(), ref)):
        g_before = copy.deepcopy(res.generator.state_dict())
        # the learning rate each update of this step uses, against optax's
        # schedule at its count
        if i in G_STEPS[case]:
            assert state.g_opt.param_groups[0]["lr"] == pytest.approx(
                g_lr, rel=1e-7), (i, "G")
        if state.d_opt is not None:
            assert state.d_opt.param_groups[0]["lr"] == pytest.approx(
                d_lr, rel=1e-7), (i, "D")
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert state.step == i + 1
        assert set(m) == set(ref_losses), (i, m.keys())
        for k, r in ref_losses.items():
            if i not in G_STEPS[case] and k.startswith("loss_") \
                    and not k.startswith("loss_d_"):
                assert float(m[k]) == 0.0 == r, (i, k)
            else:
                assert abs(float(m[k]) - r) <= LOSS_TOL * abs(r), (i, k)
        assert_close_sd(res.generator.state_dict(),
                        state_dict_from_jax(ref_state["g"], **KW),
                        f"step {i} generator")
        assert_close_sd(res.generator_ema.state_dict(),
                        state_dict_from_jax(ref_state["ema"], **KW),
                        f"step {i} EMA")
        if res.discriminator is not None:
            assert_close_sd(res.discriminator.state_dict(),
                            discriminator_state_dict_from_jax(ref_state["d"]),
                            f"step {i} discriminator")
        gen_moved = any(not torch.equal(v, res.generator.state_dict()[k])
                        for k, v in g_before.items())
        reseeded = TRAIN_CFG[case].get("start_iter") == i
        assert gen_moved == (i in G_STEPS[case] or reseeded), i
    assert g_before   # three steps ran
    if case in LR_CFG:   # the schedule did move within the run
        assert len({ref[i][2][0] for i in G_STEPS[case]}) == 2


def test_query_images_reshape_a_strip_row_major():
    """(B, ns, 3) → (B, √ns, √ns, 3) row-major, then NCHW: a run of four
    64-wide rows becomes a 16 × 16 image whose row r holds queries
    16r..16r+15."""
    flat = torch.arange(2 * 256 * 3, dtype=torch.float32).reshape(2, 256, 3)
    img = query_images(flat)
    assert img.shape == (2, 3, 16, 16)
    want = flat.numpy().reshape(2, 16, 16, 3).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(img.numpy(), want)
    assert not np.array_equal(img.numpy(), flat.numpy().reshape(2, 3, 16, 16))


def test_eval_after_an_ema_update_sees_the_new_weights(
        vgg_file):  # noqa: F811
    """forward_test evaluates the EMA copy through the Swin blocks' packed
    weights, cached on the parameters' version counters: after a step
    updates the EMA copy in place, the next eval equals a fresh restorer
    holding the new EMA weights."""
    vgg = str(vgg_file / "vgg19.pth")
    start, _ = jax_run("wogan", vgg)
    res = port_restorer("wogan", vgg, start, use_kernels=True)
    res.test_cfg = dict(scale=4)
    lq = np.random.default_rng(9).random((16, 16, 3), dtype=np.float32)
    before = res.forward_test(lq)
    blk = res.generator_ema.encoder.layers[0].residual_group.blocks[0]
    assert blk._packed, "the eval packs the EMA copy's Swin blocks"
    versions = [p._version for p in res.generator_ema.parameters()]
    state, step = port_step(res)
    step(state, {k: torch.from_numpy(v) for k, v in batches(1)[0].items()})
    assert all(p._version > v for p, v in
               zip(res.generator_ema.parameters(), versions))
    after = res.forward_test(lq)
    fresh = port_restorer("wogan", vgg, start, use_kernels=True)
    fresh.test_cfg = dict(scale=4)
    fresh.generator_ema.load_state_dict(res.generator_ema.state_dict())
    np.testing.assert_array_equal(after, fresh.forward_test(lq))
    assert not np.array_equal(after, before)
