"""K2's plain version (``decoder.wt_hoist_plain``) against the hoisted
imnet_k output layer as the JAX package forms it
(``ciaosr_tpu/ops/pallas/decoder_kernel.py``, ``hoist_kout``):
``unfold_nhwc``, the nine edge-clamped ``_shift_planes``, their product
with the query and ``_mm`` by W_kout and b_kout.

The weights are one seeded reference-layout imnet_k (the unfold block
channel-major, c·9 + tap). The port packs them with ``pack_decoder``
(tap-major rows, zero rows at padded channels); the JAX side takes the
out layer as the JAX package's converter lays it out
(``convert.torch_weights``: tap-major). Cases: nine taps at 8 channels
and at 180 channels zero-padded to 192 (the padded rows are exactly
zero), one tap (the feature itself), B = 2, odd shapes and a map 2 pixels
high, where both edge clamps of a column act at once.

Held at max|Δ|/max|ref| ≤ 1e-5 with both sides in f32, and in the bf16
class (1e-2) against the JAX package's bf16 composition as written
(bf16 product of the planes, f32 sums, wt rounded to bf16, b_kout
rounded to bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciaosr_torch.models.mlp import ImplicitMLP
from ciaosr_torch.ops.kernels import decoder as dk
from ciaosr_tpu.convert.torch_weights import _mlp, tap_major_perm
from ciaosr_tpu.ops.neighborhood import unfold_nhwc
from ciaosr_tpu.ops.pallas.decoder_kernel import _mm, _shift_planes
from tests.test_torch_weights import cap_torch_threads

cap_torch_threads()

F32_TOL, BF16_TOL = 1e-5, 1e-2
HIDDEN = [32, 32]


def _heads(c: int, taps: int, seed: int):
    """Seeded imnet_k, imnet_v, imnet_q in the reference layout (no CSA),
    the unfold block ``taps``·c wide."""
    torch.manual_seed(seed)
    dk_ = taps * c
    return (ImplicitMLP(dk_ + 4, dk_, HIDDEN),
            ImplicitMLP(dk_ + 4, dk_, HIDDEN), ImplicitMLP(dk_, 3, HIDDEN))


def _jax_kout(imnet_k, c: int, taps: int):
    """W_kout^T (DK, hidden) and b_kout in the JAX package's channel order,
    from its own converter."""
    sd = {f"imnet_k.{k}": v for k, v in imnet_k.state_dict().items()}
    perm = tap_major_perm(c) if taps == 9 else None
    out = _mlp(sd, "imnet_k", len(HIDDEN), out_perm=perm)["out"]
    return out["kernel"].T, out["bias"]


def _jax_planes(feat, w_kout_t, b_kout, taps: int, dtype):
    """decoder_kernel.py's hoisted planes (the hoist_kout branch): wt
    (B, 9, H, W, hidden) and ck (B, 9, H, W); in bf16 as written there
    (products and wt in bf16, f32 sums), else in f32."""
    bsz, h, w, _ = feat.shape
    u_map = unfold_nhwc(jnp.asarray(feat)) if taps == 9 else \
        jnp.asarray(feat)
    dk_ = u_map.shape[-1]
    u9 = _shift_planes(u_map.astype(dtype))
    q_rep = jnp.repeat(u_map.astype(dtype), 9, axis=0)
    qk9 = (u9 * q_rep).reshape(-1, dk_)
    wt9 = _mm(qk9, jnp.asarray(w_kout_t).astype(dtype)).astype(dtype)
    ck9 = _mm(qk9, jnp.asarray(b_kout).astype(dtype)[:, None])
    return (np.asarray(wt9.astype(jnp.float32)).reshape(bsz, 9, h, w, -1),
            np.asarray(ck9).reshape(bsz, 9, h, w))


def _port(feat, imnet_k, imnet_v, imnet_q, c: int, c_pad: int, dtype):
    """The port: pack_decoder's W_kout and b_kout, the feature zero-padded
    to c_pad channels, wt_hoist_plain; as (B, 9, ...) numpy f32."""
    pk = dk.pack_decoder(imnet_k, imnet_v, imnet_q, c, (0.5, 0.5), dtype,
                         c_pad=c_pad)
    ft = torch.nn.functional.pad(torch.from_numpy(feat), (0, c_pad - c))
    with torch.no_grad():
        wt, ck = dk.wt_hoist_plain(ft.to(dtype), pk["wkout"], pk["bkout"])
    return (wt.float().transpose(0, 1).numpy(),
            ck.float().transpose(0, 1).numpy(), pk)


def _rel(got, ref) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


CASES = {  # b, h, w, c, c_pad, taps
    "9tap_C8_13x29_B2": (2, 13, 29, 8, 8, 9),
    "9tap_C8_7x5": (1, 7, 5, 8, 8, 9),
    "9tap_C8_2x9_B2": (2, 2, 9, 8, 8, 9),
    "9tap_C180pad192_7x5": (1, 7, 5, 180, 192, 9),
    "9tap_C180pad192_2x6_B2": (2, 2, 6, 180, 192, 9),
    "1tap_C16_13x29_B2": (2, 13, 29, 16, 16, 1),
    "1tap_C16_2x9": (1, 2, 9, 16, 16, 1),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_wt_hoist_plain_matches_jax_f32(case):
    b, h, w, c, c_pad, taps = CASES[case]
    heads = _heads(c, taps, seed=h * w + c)
    feat = np.random.default_rng(b * h * w).standard_normal(
        (b, h, w, c)).astype(np.float32)
    wt, ck, pk = _port(feat, *heads, c, c_pad, torch.float32)
    wt_j, ck_j = _jax_planes(feat, *_jax_kout(heads[0], c, taps), taps,
                             jnp.float32)
    assert wt.shape == (b, 9, h, w, HIDDEN[-1]) and ck.shape == (b, 9, h, w)
    assert _rel(wt, wt_j) <= F32_TOL
    assert _rel(ck, ck_j) <= F32_TOL
    if c_pad > c:   # the padded channels' rows contribute exactly 0
        pad = torch.ones(taps * c_pad, dtype=torch.bool)
        pad[torch.as_tensor([t * c_pad + ch for t in range(taps)
                             for ch in range(c)])] = False
        assert not pk["wkout"][pad].any() and not pk["bkout"][pad].any()


@pytest.mark.parametrize("case", ["9tap_C8_13x29_B2", "9tap_C180pad192_7x5",
                                  "1tap_C16_13x29_B2"])
def test_wt_hoist_plain_matches_jax_bf16(case):
    b, h, w, c, c_pad, taps = CASES[case]
    heads = _heads(c, taps, seed=h * w + c)
    feat = np.random.default_rng(b * h * w).standard_normal(
        (b, h, w, c)).astype(np.float32)
    wt, ck, _ = _port(feat, *heads, c, c_pad, torch.bfloat16)
    wt_j, ck_j = _jax_planes(feat, *_jax_kout(heads[0], c, taps), taps,
                             jnp.bfloat16)
    assert _rel(wt, wt_j) <= BF16_TOL
    assert _rel(ck, ck_j) <= BF16_TOL


def test_clamp_after_unfold():
    """The shifted plane reads u at the clamped pixel (the unfold's zero
    padding moves with it), not the unfold of a clamped map: at the top
    row, shift (-1, 0) reads the row itself, whose tap (-1, 0) is zero."""
    feat = np.random.default_rng(3).standard_normal(
        (1, 2, 3, 4)).astype(np.float32)
    heads = _heads(4, 9, seed=0)
    wt, ck, pk = _port(feat, *heads, 4, 4, torch.float32)
    u = dk.unfold_taps(torch.from_numpy(feat), 9)
    qk = (u * u)[0, 0]                         # d = (-1, 0) at row 0
    assert qk[:, 4:8].abs().max() == 0         # tap (-1, 0) of row 0
    ref = (qk @ pk["wkout"]).numpy()
    np.testing.assert_allclose(wt[0, 1, 0], ref, rtol=0,
                               atol=F32_TOL * np.abs(ref).max())
