"""One RDN + CSA train step of the port against the JAX package's, f32 on
the CPU: the nine-tap decoder (the 3×3 unfold) and cross-scale attention
under autograd, the 001 generators' training forward.

A small 001-rdn-shaped generator (2 RDBs, 16 channels, CSA at scale 2)
with JAX's seeded weights carried across (``state_dict_from_jax``), one
seeded batch: the loss within 1e-5 relative; every parameter's gradient
(JAX's ``jax.grad`` of its ``train_forward``, carried across the same
way) within max|Δ|/max|ref| ≤ 1e-4; then one Adam step (the 001 recipe,
lr 1e-4) on each side: the updated parameters within 1e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tests.test_torch_weights as tw
from ciaosr_torch.convert.from_jax import state_dict_from_jax
from ciaosr_torch.models.restorers import CiaoSRRestorer
from ciaosr_torch.train.optim import build_optimizer
from ciaosr_tpu.models.restorers import CiaoSRRestorer as JaxRestorer
from ciaosr_tpu.train import optim as jax_optim
from tests.test_torch_trainer import batches

ADAM_001 = dict(type="Adam", lr=1e-4)


def to_port(tree) -> dict:
    """A JAX parameter (or gradient) tree in the port's layout, numpy."""
    return {k: v.numpy() for k, v in state_dict_from_jax(
        tree, feat_dim=16, n_hidden=2).items()}


@pytest.fixture(scope="module")
def jax_step():
    """JAX: initial weights, the loss and gradients of one batch, and the
    weights after one Adam update, all in the port's layout."""
    _, params = tw.generator_params(tw.SMALL, seed=12)
    init = jax.tree.map(np.array, params)
    res = JaxRestorer(tw.SMALL)
    batch = {k: jnp.asarray(v) for k, v in batches(1, seed=9)[0].items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: res.train_forward(p, *(batch[k] for k in res.batch_keys))[
            0]))(params)
    tx, _ = jax_optim.build_optimizer(dict(ADAM_001))
    upd, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, upd)
    return init, float(loss), to_port(grads), to_port(new)


def test_nine_tap_csa_step_matches_jax(jax_step):
    init, ref_loss, ref_grads, ref_new = jax_step
    res = CiaoSRRestorer(tw.SMALL, device="cpu")
    gen = res.generator
    assert gen.taps == 9 and gen.non_local_attn
    gen.load_state_dict(state_dict_from_jax(init, feat_dim=16, n_hidden=2),
                        strict=True)
    opt, sched = build_optimizer(gen.parameters(), ADAM_001)
    b = {k: torch.from_numpy(v) for k, v in batches(1, seed=9)[0].items()}
    loss, _ = res.train_forward(b["lq"], b["gt"], b["coord"], b["cell"])
    loss.backward()
    assert abs(float(loss.detach()) - ref_loss) <= 1e-5 * abs(ref_loss)

    named = dict(gen.named_parameters())
    assert set(named) == set(ref_grads)
    assert any(k.startswith("cs_attn.") for k in named)
    for k, p in named.items():
        got, ref = p.grad.numpy(), ref_grads[k]
        scale = np.abs(ref).max()
        assert scale > 0, k
        assert np.abs(got - ref).max() <= 1e-4 * scale, k

    opt.step()
    sched.step()
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), ref_new[k], atol=1e-6,
                                   rtol=0, err_msg=k)
