"""Training in the port vs the JAX package, f32 on the CPU, same weights
through state_dict_from_jax and the same numpy inputs.

* The Swin block's gradients (dx and every parameter) against ``jax.grad``
  through JAX's XLA block (``flash=False``), on the port's module route and
  on its ``SwinBlockFunction`` route (rows 11 and 12; on CPU tensors their
  plain versions, ``swin_block_bwd_plain`` + ``unpack_swin_grads``).
* ``unpack_swin_grads`` is the transpose of ``pack_swin_block``.
* ``build_optimizer`` / ``build_schedule`` against ciaosr_tpu/train/optim.py.
* Three train steps of the small SwinIR-CiaoSR generator against JAX's
  ``make_train_step`` (Adam 2e-4, betas (0.9, 0.99), the 002 recipe's).
* The device rule, and no fallback off the CPU.

Tolerances: per tensor max|Δ|/max|ref| ≤ 1e-5 for gradients, with the q,
k and v parts of the qkv bias held separately; the k-bias gradient is 0 in
exact arithmetic (softmax is shift-invariant), so it is held to ≤ 1e-6
abs. Optimizer results ≤ 1e-6 abs; losses ≤ 1e-5 relative.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ciaosr_torch.convert.from_jax import (state_dict_from_jax,
                                           swin_block_state_dict_from_jax)
from ciaosr_torch.core.coords import make_coord_cell
from ciaosr_torch.models import swinir as ts
from ciaosr_torch.models.restorers import CiaoSRRestorer
from ciaosr_torch.ops.kernels import swin_block as sb
from ciaosr_torch.train.optim import build_optimizer, build_schedule
from ciaosr_torch.train.trainer import TrainState, make_train_step
from ciaosr_tpu.convert.torch_weights import convert_generator
from ciaosr_tpu.models.restorers import CiaoSRRestorer as JaxRestorer
from ciaosr_tpu.models.swinir import SwinBlock as JaxBlock
from ciaosr_tpu.train import optim as jax_optim
from ciaosr_tpu.train import trainer as jax_trainer
from tests.test_torch_weights import (SWIN_SMALL, generator_params,
                                      seeded_params)

ADAM_002 = dict(type="Adam", lr=2e-4, betas=(0.9, 0.99))


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def assert_grads_close(got: dict, ref: dict, dim: int, tol: float) -> None:
    """Per tensor max|Δ|/max|ref| ≤ tol; qkv.bias in its three parts, the
    k part (analytically 0) ≤ 1e-6 abs."""
    assert set(got) == set(ref)
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.shape == r.shape, k
        if k.endswith("qkv.bias"):
            assert _rel(g[:dim], r[:dim]) <= tol, k
            assert np.abs(g[dim:2 * dim]).max() <= 1e-6, k
            assert np.abs(r[dim:2 * dim]).max() <= 1e-6, k
            assert _rel(g[2 * dim:], r[2 * dim:]) <= tol, k
        else:
            assert _rel(g, r) <= tol, k


# ------------------------------------------------------------ Swin block --
# the last: 002's real head layout (6 heads of 30 in slots of 32, hidden
# 360) on a shifted 16 x 16 map
BLOCK_CASES = [(16, 2, 4, (8, 8), 0), (16, 2, 4, (8, 12), 2),
               (12, 3, 8, (16, 16), 0), (12, 3, 8, (16, 24), 4),
               (180, 6, 8, (16, 16), 4)]
BLOCK_IDS = ["C16_ws4", "C16_ws4_shifted", "C12_ws8", "C12_ws8_shifted",
             "C180_ws8_shifted"]


def _block_case(dim, heads, window, hw, shift):
    """A JAX block with seeded params, x and dy (numpy), and the port's
    block with the same weights."""
    h, w = hw
    rng = np.random.default_rng(dim * 7 + h + w + shift)
    x = rng.standard_normal((2, h * w, dim)).astype(np.float32)
    dy = rng.standard_normal((2, h * w, dim)).astype(np.float32)
    jblk = JaxBlock(dim, heads, window, shift)
    init = SimpleNamespace(init=lambda key, t: jblk.init(key, t, hw))
    params = seeded_params(init, h + shift, jnp.asarray(x))
    blk = ts.SwinBlock(dim, heads, window, shift)
    blk.load_state_dict(swin_block_state_dict_from_jax(params["params"]),
                        strict=True)
    return jblk, params, x, dy, blk


def _jax_block_grads(jblk, params, x, dy, hw, flash=False):
    def loss(p, x_):
        return jnp.sum(jblk.apply(p, x_, hw, flash) * dy)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    ref = {k: v.numpy() for k, v in
           swin_block_state_dict_from_jax(gp["params"]).items()}
    return ref, np.asarray(gx)


def _port_block_grads(blk, x, dy, hw, use_kernels):
    h, w = hw
    xt = torch.from_numpy(x).reshape(2, h, w, -1).requires_grad_()
    y = blk(xt, torch.float32, use_kernels)
    (y * torch.from_numpy(dy).reshape(y.shape)).sum().backward()
    got = {k: p.grad.numpy() for k, p in blk.named_parameters()}
    return got, xt.grad.reshape(x.shape).numpy()


@pytest.mark.parametrize("dim,heads,window,hw,shift", BLOCK_CASES,
                         ids=BLOCK_IDS)
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["module", "function"])
def test_block_grads_match_jax(dim, heads, window, hw, shift, use_kernels):
    jblk, params, x, dy, blk = _block_case(dim, heads, window, hw, shift)
    ref, ref_dx = _jax_block_grads(jblk, params, x, dy, hw)
    got, got_dx = _port_block_grads(blk, x, dy, hw, use_kernels)
    assert _rel(got_dx, ref_dx) <= 1e-5
    assert_grads_close(got, ref, dim, 1e-5)


def test_function_route_runs_the_backward_wrapper(monkeypatch):
    """With kernels on, the block's backward goes through swin_block_bwd
    (its plain version on CPU tensors) once per block and call."""
    calls = []
    real = sb.swin_block_bwd
    monkeypatch.setattr(sb, "swin_block_bwd",
                        lambda *a: calls.append(a[3:]) or real(*a))
    blk = ts.SwinBlock(12, 3, 4, 2)
    x = torch.randn(1, 8, 8, 12, requires_grad=True)
    blk(x, torch.float32, True).sum().backward()
    assert calls == [(4, 2)]
    with torch.inference_mode():   # eval: the forward kernel alone
        blk(x, torch.float32, True)
    assert len(calls) == 1


@pytest.mark.parametrize("dim,heads,window,ws", [(12, 3, 4, 4),
                                                 (18, 3, 8, 4),
                                                 (180, 6, 8, 8)],
                         ids=["C12", "C18_ws_shrunk", "C180_6x30"])
def test_unpack_is_pack_transpose(dim, heads, window, ws):
    """For random cotangents of the packed tensors, unpack_swin_grads equals
    autograd through pack_swin_block's own code: padded C, head slots of
    32 (6 heads of 30 at embed 180, one 8 × 8 window), the pre-scaled q
    bias and the bias-table scatter-add (a window smaller than the
    configured one included)."""
    torch.manual_seed(dim)
    blk = ts.SwinBlock(dim, heads, window, 0)
    with torch.no_grad():
        for p in blk.parameters():
            p.normal_()
    pk = sb.pack_swin_block.__wrapped__(blk, ws, torch.float32)
    rng = np.random.default_rng(ws)
    ct = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
        np.float32)) for k, v in pk.items()}
    names, params = zip(*blk.named_parameters())
    ref = torch.autograd.grad(sum((pk[k] * ct[k]).sum() for k in pk),
                              params)
    got = sb.unpack_swin_grads(blk, ct, ws)
    assert set(got) == set(names)
    for name, r in zip(names, ref):
        assert got[name].shape == r.shape and got[name].dtype == torch.float32
        assert float((got[name] - r).abs().max()) <= 1e-6 * max(
            1.0, float(r.abs().max())), name


def test_backward_wrapper_does_not_fall_back():
    """Off the CPU the wrapper launches the kernel or raises: a tensor on
    another device is refused, never sent to the plain version."""
    blk = ts.SwinBlock(12, 3, 4, 0)
    pk = blk.packed(4, torch.bfloat16)
    x = torch.zeros(1, 8, 8, 12, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sb.swin_block_bwd(x, x, pk, 4, 0)


# ------------------------------------------------------------- optimizer --
def test_schedule_matches_optax_across_step_boundaries():
    lr_cfg = dict(policy="Step", step=[3, 6], gamma=0.5)
    ref = jax_optim.build_schedule(2e-4, lr_cfg)
    got = build_schedule(2e-4, lr_cfg)
    params = [torch.nn.Parameter(torch.zeros(2))]
    opt, sched = build_optimizer(params, ADAM_002, lr_cfg)
    for k in range(9):   # optax computes in f32: 1e-6 relative
        assert abs(got(k) - float(ref(k))) <= 1e-6 * float(ref(k))
        assert abs(opt.param_groups[0]["lr"] - float(ref(k))) <= 1e-6 * float(
            ref(k))
        opt.step()
        sched.step()
    assert build_schedule(1e-4, None)(5) == 1e-4


@pytest.mark.parametrize("cfg", [ADAM_002,
                                 dict(type="AdamW", lr=1e-3,
                                      weight_decay=0.05),
                                 dict(type="SGD", lr=1e-2, momentum=0.8)],
                         ids=["adam", "adamw", "sgd"])
def test_optimizer_updates_match_optax(cfg):
    lr_cfg = dict(policy="Step", step=[2, 4], gamma=0.5)
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal((4, 5)).astype(np.float32)
    grads = rng.standard_normal((5, 4, 5)).astype(np.float32)
    tx, _ = jax_optim.build_optimizer(dict(cfg), lr_cfg)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = build_optimizer([param], dict(cfg), lr_cfg)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        param.grad = torch.from_numpy(g.copy())
        opt.step()
        sched.step()
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp),
                               atol=1e-6, rtol=0)


# ------------------------------------------------------------ train step --
def _batches(n_steps: int = 3):
    """Seeded batches: B = 2, 16² LR in [0, 1], 64 queries (an 8 × 8 block
    of a 48² HR grid), gt in [0, 1]."""
    coord, cell = make_coord_cell((48, 48))
    coord = coord.reshape(48, 48, 2)[10:18, 20:28].reshape(-1, 2).numpy()
    cell = cell[:64].numpy()
    rng = np.random.default_rng(5)
    return [dict(lq=rng.random((2, 16, 16, 3), dtype=np.float32),
                 gt=rng.random((2, 64, 3), dtype=np.float32),
                 coord=np.broadcast_to(coord, (2, 64, 2)).copy(),
                 cell=np.broadcast_to(cell, (2, 64, 2)).copy())
            for _ in range(n_steps)]


@pytest.fixture(scope="module")
def jax_run():
    """Three steps of JAX's make_train_step on the small generator."""
    _, params = generator_params(SWIN_SMALL, seed=21)
    init = jax.tree.map(np.array, params)
    jres = JaxRestorer(SWIN_SMALL)
    tx, _ = jax_optim.build_optimizer(dict(ADAM_002))
    step = jax_trainer.make_train_step(jres, tx)
    state = jax_trainer.TrainState(step=jnp.asarray(0), params=params,
                                   opt_state=tx.init(params))
    losses = []
    for b in _batches():
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss_pix"]))
    return init, losses, jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel_route"])
def test_train_steps_match_jax(jax_run, use_kernels):
    init, ref_losses, ref_params = jax_run
    kw = dict(feat_dim=12, n_hidden=2, encoder="swinir",
              non_local_attn=False)
    res = CiaoSRRestorer(dict(SWIN_SMALL, use_kernels=use_kernels),
                         device="cpu")
    res.generator.load_state_dict(state_dict_from_jax(init, **kw),
                                  strict=True)
    opt, sched = build_optimizer(res.generator.parameters(), ADAM_002)
    state = TrainState(0, res.generator, opt, sched)
    step = make_train_step(res, opt, sched)
    for b, ref in zip(_batches(), ref_losses):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        assert abs(float(m["loss_pix"]) - ref) <= 1e-5 * abs(ref)
    assert state.step == 3 and sched.last_epoch == 3
    got = convert_generator(res.generator.state_dict(), strict=True, **kw)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(ref_params))
    assert len(flat_got) == len(flat_ref)
    for path, v in flat_got:
        np.testing.assert_allclose(v, flat_ref[path], atol=1e-6, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_train_restorer_needs_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CiaoSRRestorer(SWIN_SMALL)
    res = CiaoSRRestorer(dict(SWIN_SMALL, use_kernels=True), device="cpu")
    opt, sched = build_optimizer(res.generator.parameters(), ADAM_002)
    b = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    _, m = make_train_step(res, opt, sched)(
        TrainState(0, res.generator, opt, sched), b)
    assert m["loss_pix"].device.type == "cpu"
    assert torch.isfinite(m["loss_pix"])


# -------------------------------------------------- the TPU kernel itself --
@pytest.mark.slow
@pytest.mark.parametrize("shift", [0, 2])
def test_block_grads_match_tpu_kernel_interpret(shift):
    """The port's block gradients against JAX's flash=True route (the TPU
    kernel, interpret mode) within its own bound of 5e-2 (bf16 inside).
    The q-bias gradient is the exception: the TPU kernel's equals the
    port's (the true one) times head_dim^-0.5."""
    dim, heads = 16, 2
    jblk, params, x, dy, blk = _block_case(dim, heads, 4, (8, 8), shift)
    ref, ref_dx = _jax_block_grads(jblk, params, x, dy, (8, 8), flash=True)
    got, got_dx = _port_block_grads(blk, x, dy, (8, 8), True)
    assert _rel(got_dx, ref_dx) <= 5e-2
    qb_got = got.pop("attn.qkv.bias")
    qb_ref = ref.pop("attn.qkv.bias")
    for k in ref:
        assert _rel(got[k], ref[k]) <= 5e-2, k
    assert _rel(qb_got[2 * dim:], qb_ref[2 * dim:]) <= 5e-2
    factor = (dim // heads) ** -0.5
    assert _rel(qb_got[:dim] * factor, qb_ref[:dim]) <= 5e-2
