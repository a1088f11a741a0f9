"""Row 8's paste (``csa_attention.plane_overlap_add_plain``, the plain
version of csrc/csa_paste.cu) against the JAX package, f32, on the CPU.

The paste reads per-pixel (3s)×(3s) kernels in the plane-major column
order (``plane_major_perm``) and adds, for each output block, the nine
taps (t, r) of query pixel (y − t + 1, x − r + 1) in a fixed order,
dropping sources off the grid. On seeded tap-major kernels k_tm and their
plane-major permutation k_pm it is held, at ≤ 1e-5 abs, to the port's
``overlap_add`` of k_tm and to the JAX package's
``models/csa.py::_overlap_add`` of k_tm, at B = 2, s = 2 and maps of
1 × 1, 1 × 7, 5 × 1, 3 × 5, 13 × 29 and 72 × 72 (every edge mask acts: a
map one pixel high or wide keeps only its middle tap row or column), at
C = 8 and at the flagship's C = 64. Row 8's plain version is held to the
JAX attention and ``_overlap_add`` at odd Hp × Wp, B = 2, and so is the
card's composition of it (row 7's function on the plane-major bank, then
the paste). Last, a scan of the kernel sources: none uses
``nvcuda::wmma``, and every quoted include names a file that exists.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciaosr_torch.ops.kernels import _build
from ciaosr_torch.ops.kernels import csa_attention as ca
from ciaosr_torch.ops.neighborhood import overlap_add, plane_major_perm
from ciaosr_tpu.models.csa import _overlap_add
from ciaosr_tpu.ops.neighborhood import extract_patches_same
from ciaosr_tpu.ops.pallas.csa_attention import \
    plane_major_perm as jax_plane_major_perm
from tests.test_torch_weights import cap_torch_threads

cap_torch_threads()

TOL = 1e-5
S = 2
SHAPES = [(1, 1), (1, 7), (5, 1), (3, 5), (13, 29), (72, 72)]


def _kernels(seed: int, b: int, hp: int, wp: int, c: int):
    """Seeded tap-major kernels k_tm (B, Hp·Wp, 9s²C) and their plane-major
    permutation k_pm, as numpy f32."""
    rng = np.random.default_rng(seed)
    k_tm = rng.standard_normal((b, hp * wp, 9 * S * S * c),
                               dtype=np.float32)
    return k_tm, np.ascontiguousarray(k_tm[..., plane_major_perm(S, c)])


@pytest.mark.parametrize("c", [8, 64])
@pytest.mark.parametrize("hp,wp", SHAPES)
def test_paste_plain_matches_overlap_add(hp, wp, c):
    k_tm, k_pm = _kernels(hp * 100 + wp + c, 2, hp, wp, c)
    got = ca.plane_overlap_add_plain(torch.from_numpy(k_pm), hp, wp,
                                     S).numpy()
    assert got.shape == (2, S * hp, S * wp, c)
    port = overlap_add(torch.from_numpy(k_tm), hp, wp, S, c).numpy()
    np.testing.assert_allclose(got, port, atol=TOL, rtol=0)
    ref = np.asarray(_overlap_add(jnp.asarray(k_tm), hp, wp, S, c))
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(ca.plane_overlap_add(
        torch.from_numpy(k_pm), hp, wp, S).numpy(), got)


def test_paste_plain_is_the_gather_in_order():
    """The plain version adds exactly csrc/csa_paste.cu's sum, element by
    element in the same order: the same bits as the gather written out."""
    hp, wp, c = 3, 5, 8
    _, k_pm = _kernels(7, 2, hp, wp, c)
    got = ca.plane_overlap_add_plain(torch.from_numpy(k_pm), hp, wp,
                                     S).numpy()
    want = np.zeros((2, S * hp, S * wp, c), np.float32)
    for oy in range(S * hp):
        for ox in range(S * wp):
            y, a, x, be = oy // S, oy % S, ox // S, ox % S
            acc = np.zeros((2, c), np.float32)
            for t in range(3):
                for r in range(3):
                    ys, xs = y - t + 1, x - r + 1
                    if 0 <= ys < hp and 0 <= xs < wp:
                        col = ((3 * t + r) * S + a) * S * c + be * c
                        acc = acc + k_pm[:, ys * wp + xs, col:col + c]
            want[:, oy, ox] = acc
    np.testing.assert_array_equal(got, want)


def _banks(seed: int, b: int, hp: int, wp: int, l_: int, c: int, cr: int):
    """q (B, P, 9Cr) from a seeded match map, normalized keys (B, L, 9Cr)
    and a tap-major value bank (B, L, 9s²C), numpy f32."""
    rng = np.random.default_rng(seed)
    match = 0.25 * rng.standard_normal((b, hp, wp, cr)).astype(np.float32)
    q = np.array(extract_patches_same(jnp.asarray(match), 3, 1))
    k = rng.standard_normal((b, l_, 9 * cr))
    k = (k / np.linalg.norm(k, axis=-1, keepdims=True)).astype(np.float32)
    v = rng.standard_normal((b, l_, 9 * S * S * c)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("hp,wp,l_", [(7, 9, 12), (11, 5, 30)])
def test_overlap_add_plain_odd_geometry(hp, wp, l_):
    """Row 8's plain version, and row 7's on the plane-major bank followed
    by the paste (what the card runs), against the JAX attention and
    _overlap_add at odd Hp × Wp, B = 2."""
    c, cr, scale = 6, 4, 10.0
    q, k, v = _banks(hp * wp, 2, hp, wp, l_, c, cr)
    perm = plane_major_perm(S, c)
    np.testing.assert_array_equal(perm, jax_plane_major_perm(S, c))
    v_pm = np.ascontiguousarray(v[..., perm])
    attn = jax.nn.softmax(jnp.einsum("bpk,blk->bpl", q, k) * scale, -1)
    ref = np.asarray(_overlap_add(jnp.einsum("bpl,blk->bpk", attn, v), hp,
                                  wp, S, c))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v_pm))
    got8 = ca.csa_attention_overlap_add(tq, tk, tv, scale, hp, wp,
                                        S).numpy()
    assert got8.shape == ref.shape == (2, S * hp, S * wp, c)
    np.testing.assert_allclose(got8, ref, atol=TOL, rtol=0)
    card = ca.plane_overlap_add_plain(ca.csa_attention_plain(tq, tk, tv,
                                                             scale),
                                      hp, wp, S).numpy()
    np.testing.assert_allclose(card, ref, atol=TOL, rtol=0)


def _sources():
    return sorted(_build.CSRC.glob("*.cu*"))


def test_sources_use_no_wmma():
    """Every kernel source is on its Hopper design: no nvcuda::wmma
    fragment and no <mma.h>."""
    assert _sources()
    for src in _sources():
        text = src.read_text()
        assert "nvcuda::wmma" not in text and "<mma.h>" not in text, \
            src.name


def test_source_includes_exist():
    """Every #include "..." of a kernel source names a file in csrc/."""
    names = {src.name for src in _sources()}
    for src in _sources():
        for inc in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
            assert inc in names, f"{src.name} includes missing {inc}"
