"""Port SwinIR trunk and Swin block vs the JAX package, f32, same weights
through state_dict_from_jax.

The block is held on both of its routes: the plain block (the JAX XLA
route) and the kernel route on CPU tensors (roll, pack_swin_block,
swin_block_plain on the packed weights, roll back), so the packing is held
against JAX too. Cases: shifted and unshifted, a head dim (6) far from
its 32-wide slot, and a window that shrinks to the map (6 × 6 at window 8,
shift dropped). Tolerance: f32, ≤ 1e-5 abs.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciaosr_torch.convert.from_jax import (swin_block_state_dict_from_jax,
                                           swinir_state_dict_from_jax)
from ciaosr_torch.models import swinir as ts
from ciaosr_torch.ops.kernels import swin_block as sb
from ciaosr_tpu.models.swinir import SwinBlock as JaxBlock
from ciaosr_tpu.models.swinir import SwinIREncoder
from tests.test_torch_weights import seeded_params


def block_params(jblk, seed, x, hw):
    """Seeded params of a JAX SwinBlock at map size hw (static)."""
    init = SimpleNamespace(init=lambda key, t: jblk.init(key, t, hw))
    return seeded_params(init, seed, x)


@pytest.mark.parametrize("dim,heads,window,hw,shift", [
    (12, 3, 4, (8, 8), 0),
    (12, 3, 4, (8, 12), 2),
    (18, 3, 4, (12, 8), 2),
    (12, 3, 8, (6, 6), 4),
], ids=["unshifted", "shifted", "head_dim_6", "ws_shrunk"])
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel_route"])
def test_block_matches_jax(dim, heads, window, hw, shift, use_kernels):
    h, w = hw
    x = np.random.default_rng(dim + h).standard_normal(
        (2, h * w, dim)).astype(np.float32)
    jblk = JaxBlock(dim, heads, window, shift)
    params = block_params(jblk, h, jnp.asarray(x), (h, w))
    ref = np.asarray(jax.jit(jblk.apply, static_argnums=2)(
        params, jnp.asarray(x), (h, w)))
    blk = ts.SwinBlock(dim, heads, window, shift)
    blk.load_state_dict(swin_block_state_dict_from_jax(params["params"]),
                        strict=True)
    with torch.no_grad():
        got = blk(torch.from_numpy(x).reshape(2, h, w, dim), torch.float32,
                  use_kernels)
    np.testing.assert_allclose(got.reshape(2, h * w, dim).numpy(), ref,
                               atol=1e-5, rtol=0)


def test_packed_block_matches_module_in_bf16():
    """The plain version on bf16-packed weights (the kernel's own casts)
    stays within the bf16 class of the f32 block."""
    blk = ts.SwinBlock(18, 3, 4, 2)
    torch.manual_seed(0)
    x = torch.randn(1, 8, 8, 18)
    with torch.no_grad():
        ref = blk(x, torch.float32)
        xr = torch.roll(x, (-2, -2), (1, 2))
        got = torch.roll(sb.swin_block_plain(
            xr, sb.pack_swin_block(blk, 4, torch.bfloat16), 4, 2), (2, 2),
            (1, 2))
    assert float((got - ref).abs().max()) <= 1e-2 * float(ref.abs().max())


def test_pack_rejects_what_the_layout_does_not_hold():
    with pytest.raises(ValueError, match="packed layout"):
        sb.pack_swin_block(ts.SwinBlock(64, 1, 4, 0), 4, torch.float32)


def test_block_pack_is_kept_until_a_weight_changes():
    blk = ts.SwinBlock(12, 3, 4, 0)
    first = blk.packed(4, torch.float32)
    assert blk.packed(4, torch.float32) is first
    with torch.no_grad():
        blk.mlp.fc1.bias.add_(1.0)
    again = blk.packed(4, torch.float32)
    assert again is not first
    assert torch.equal(again["b1m"][:24], blk.mlp.fc1.bias)


@pytest.fixture(scope="module")
def trunk():
    cfg = dict(embed_dim=12, depths=(2, 2), num_heads=(3, 3), window_size=8)
    jenc = SwinIREncoder(**cfg)
    params = seeded_params(jenc, 3, jnp.zeros((1, 16, 16, 3)))
    enc = ts.SwinIR(**cfg)
    enc.load_state_dict(swinir_state_dict_from_jax(params["params"]),
                        strict=True)
    return jax.jit(jenc.apply), params, enc


@pytest.mark.parametrize("hw", [(16, 16), (13, 11)], ids=["aligned",
                                                          "reflect_pad"])
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel_route"])
def test_trunk_matches_jax(trunk, hw, use_kernels):
    japply, params, enc = trunk
    x = np.random.default_rng(hw[1]).random((2, *hw, 3), dtype=np.float32)
    ref = np.asarray(japply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = enc(torch.from_numpy(x), torch.float32, use_kernels)
    assert got.shape == ref.shape == (2, *hw, 12)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.slow
@pytest.mark.parametrize("shift", [0, 2])
def test_plain_block_matches_tpu_kernel_interpret(shift):
    """swin_block_plain against the TPU kernel itself (swin_block_fused in
    interpret mode), both in its bf16 numerics: the bf16 class."""
    from ciaosr_tpu.ops.pallas.swin_block import swin_block_fused
    dim, heads, ws, h, w = 12, 3, 4, 8, 8
    x = np.random.default_rng(shift).standard_normal(
        (1, h, w, dim)).astype(np.float32)
    jblk = JaxBlock(dim, heads, ws, shift)
    params = block_params(jblk, 1, jnp.asarray(x.reshape(1, -1, dim)),
                          (h, w))
    p = params["params"]
    ref = np.asarray(swin_block_fused(
        jnp.asarray(x), (p["norm1"]["scale"], p["norm1"]["bias"]),
        p["attn"]["qkv"]["kernel"], p["attn"]["qkv"]["bias"],
        p["attn"]["proj"]["kernel"], p["attn"]["proj"]["bias"],
        jblk.bind(params).attn._bias(ws), sb.attn_mask(h, w, ws, shift),
        (p["norm2"]["scale"], p["norm2"]["bias"]),
        p["mlp_fc1"]["kernel"], p["mlp_fc1"]["bias"],
        p["mlp_fc2"]["kernel"], p["mlp_fc2"]["bias"], heads, ws,
        interpret=True))
    blk = ts.SwinBlock(dim, heads, ws, shift)
    blk.load_state_dict(swin_block_state_dict_from_jax(p), strict=True)
    with torch.no_grad():
        got = sb.swin_block_plain(torch.from_numpy(x), sb.pack_swin_block(
            blk, ws, torch.bfloat16), ws, shift).numpy()
    assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()
