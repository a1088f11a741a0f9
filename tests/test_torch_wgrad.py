"""Row 12's weight-gradient products on the CPU: the plain twin of the
weight-gradient kernel (``swin_block_wgrad_plain``) and the contract it
reads, the window kernel's per-token operand pairs
(``swin_block_pairs_plain``).

* ``swin_block_wgrad_plain`` on seeded bf16 pairs against numpy's aᵀ b of
  each product (float64), max|Δ|/max|ref| ≤ 1e-6, and ``_split_grads``
  putting each product at its key; T = 64, 512 and 768 tokens.
* ``swin_block_pairs_plain`` composed with ``swin_block_wgrad_plain`` on
  f32 packed weights against ``swin_block_bwd_plain``'s wqkv, wp, w1 and w2
  gradients, and through ``unpack_swin_grads`` against ``jax.grad`` of the
  JAX package's block (the cases of ``test_block_grads_match_jax``), each
  max|Δ|/max|ref| ≤ 1e-5 (f32 sums in another order).
"""

import numpy as np
import pytest
import torch

from ciaosr_torch.ops.kernels import swin_block as sb
from tests.test_torch_train import (BLOCK_CASES, BLOCK_IDS, _block_case,
                                    _jax_block_grads, _rel)

WEIGHTS = {"wqkv": "attn.qkv.weight", "wp": "attn.proj.weight",
           "w1": "mlp.fc1.weight", "w2": "mlp.fc2.weight"}


def _pairs(t: int, n: int, seed: int) -> list[torch.Tensor]:
    """Seeded bf16 pairs of t tokens, NT rows a window of which the first
    n are tokens (the rest zero)."""
    rng = np.random.default_rng(seed)
    live = (np.arange(t) % sb.NT < n)[:, None]
    return [torch.from_numpy(np.where(live, rng.standard_normal(
        (t, width)), 0.0).astype(np.float32)).to(torch.bfloat16)
            for _, width in sb._PAIRS]


@pytest.mark.parametrize("t,n", [(64, 36), (512, 64), (768, 64)],
                         ids=["T64_window_6", "T512", "T768"])
def test_wgrad_plain_matches_numpy(t, n):
    pairs = _pairs(t, n, t)
    flat = sb.swin_block_wgrad_plain(pairs)
    ld = sum(r * c for _, (r, c) in sb._MATRICES)
    assert flat.shape == (ld,) and flat.dtype == torch.float32
    heads, nn = 6, 64
    lw = sum(size for _, size in sb._VECTORS) + heads * nn * nn
    g = sb._split_grads(torch.cat([torch.zeros(lw), flat]), heads, nn)
    for i, (k, shape) in enumerate(sb._MATRICES):
        a, b = (pairs[2 * i + j].float().numpy().astype(np.float64)
                for j in range(2))
        ref = a.T @ b
        assert g[k].shape == shape == ref.shape, k
        assert _rel(g[k].numpy(), ref) <= 1e-6, k
    # on CPU tensors the wrapper is the plain version, as one chunk
    assert torch.equal(sb.swin_block_wgrad(pairs), flat[None])


@pytest.mark.parametrize("dim,heads,window,hw,shift", BLOCK_CASES,
                         ids=BLOCK_IDS)
def test_pairs_compose_to_block_grads(dim, heads, window, hw, shift):
    jblk, params, x, dy, blk = _block_case(dim, heads, window, hw, shift)
    h, w = hw
    ws, sh = blk.geometry(h, w)
    assert sh == shift

    def rolled(a):   # the kernel's map: rolled by the shift
        t = torch.from_numpy(a).reshape(2, h, w, dim)
        return torch.roll(t, (-sh, -sh), (1, 2)) if sh else t

    xr, dyr = rolled(x), rolled(dy)
    pk = blk.packed(ws, torch.float32)
    pairs = sb.swin_block_pairs_plain(xr, dyr, pk, ws, sh)
    nwin = 2 * (h // ws) * (w // ws)
    assert [tuple(p.shape) for p in pairs] == [
        (nwin * sb.NT, width) for _, width in sb._PAIRS]
    pad = (torch.arange(nwin * sb.NT) % sb.NT) >= ws * ws
    assert all(not p[pad].any() for p in pairs)
    flat = sb.swin_block_wgrad_plain(pairs)
    _, rg = sb.swin_block_bwd_plain(xr, dyr, pk, ws, sh)
    g, at = dict(rg), 0
    for k, (r, c) in sb._MATRICES:
        g[k] = flat[at:at + r * c].view(r, c)
        at += r * c
        assert _rel(g[k].numpy(), rg[k].numpy()) <= 1e-5, k
    got = sb.unpack_swin_grads(blk, g, ws)
    ref, _ = _jax_block_grads(jblk, params, x, dy, hw)
    for k, name in WEIGHTS.items():
        assert got[name].shape == ref[name].shape, name
        assert _rel(got[name].numpy(), ref[name]) <= 1e-5, name
