"""The port's CSA routes against the JAX package, f32, on the CPU.

(a) ``csa_route`` picks the JAX package's ``fused_admission`` mode at every
geometry of a sweep; (b) each plain middle (rows 5-8) against its JAX XLA
counterpart; (c) the kernel route of CrossScaleAttention with the route
forced to each mode against JAX's flash=False module; (d) average=False,
ties included; (e) a small-model ×4 ``predict_tiled`` at a geometry the
route sends to ``streaming``, against JAX's ``predict_tiled``. Tolerance
1e-5 abs throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ciaosr_torch.models.csa as csa_mod
from ciaosr_torch.convert.from_jax import (csa_state_dict_from_jax,
                                           state_dict_from_jax)
from ciaosr_torch.models.csa import CrossScaleAttention, csa_route
from ciaosr_torch.models.restorers import CiaoSRRestorer
from ciaosr_torch.ops.kernels import csa_stencil as stencil_mod
from ciaosr_torch.ops.kernels.csa_attention import (
    csa_attention_overlap_add_plain, csa_attention_plain, csa_fused_plain)
from ciaosr_torch.ops.kernels.csa_stencil import csa_stencil_plain
from ciaosr_torch.ops.neighborhood import extract_patches_same as \
    port_patches
from ciaosr_torch.ops.neighborhood import plane_major_perm
from ciaosr_tpu.models.csa import CrossScaleAttention as JaxCSA
from ciaosr_tpu.models.csa import (_overlap_add, _stencil_reconstruct,
                                   fused_admission)
from ciaosr_tpu.models.restorers import CiaoSRRestorer as JaxRestorer
from ciaosr_tpu.ops.neighborhood import extract_patches_same
from ciaosr_tpu.ops.pallas.csa_attention import \
    plane_major_perm as jax_plane_major_perm
from tests.test_torch_weights import SMALL, generator_params, seeded_params

TOL = 1e-5
MODES = ("stencil_fused", "stencil", "resident", "windowed", "streaming")

# (a) ------------------------------------------------------------ the route
SWEEP = {
    "square": [(n, n) for n in (16, 18, 32, 46, 48, 58, 64, 70, 72, 96, 120,
                                128, 192, 256, 384, 512)],
    "2:1": [(n, 2 * n) for n in (16, 24, 36, 48, 64, 96, 128, 192, 256)],
    "1024_wide": [(n, 1024) for n in (8, 16, 24, 32, 40, 48, 56, 64, 96,
                                      128, 192)],
}
# (C, Cr): the test widths, the flagship's, SwinIR's (s²C not 128-aligned)
WIDTHS = ((16, 8), (64, 32), (180, 90))


@pytest.mark.parametrize("budget", [85 << 20, 24 << 20], ids=["85MiB",
                                                                "24MiB"])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("es", [2, 4])
@pytest.mark.parametrize("family", sorted(SWEEP))
def test_route_matches_jax_admission(monkeypatch, family, es, batch,
                                     budget):
    monkeypatch.setenv("CIAOSR_CSA_VMEM_BUDGET", str(budget))
    for hp, wp in SWEEP[family]:
        for c, cr in WIDTHS:
            want = fused_admission(hp, wp, 2, c, cr, es, batch)[0]
            assert csa_route(hp, wp, 2, c, cr, es, batch) == want, \
                (hp, wp, c, cr)


def test_route_sweep_reaches_every_mode(monkeypatch):
    """The flagship widths at bf16, batch 1 and the default budget reach
    all five modes within the sweep."""
    monkeypatch.delenv("CIAOSR_CSA_VMEM_BUDGET", raising=False)
    seen = {csa_route(hp, wp, 2, 64, 32, 2, 1)
            for geoms in SWEEP.values() for hp, wp in geoms}
    assert seen == set(MODES)


# (b) ---------------------------------------------------- the plain middles
def _inputs(rng, b, hp, wp, s, c, cr):
    """match at 0.25 of unit scale keeps the scores (×10) of the order of
    the module's, so the softmax is not a near one-hot whose f32 rounding
    alone reaches the tolerance."""
    match = 0.25 * rng.standard_normal((b, hp, wp, cr)).astype(np.float32)
    keys = rng.standard_normal((b, (hp // s) * (wp // s), 9 * cr))
    keys = (keys / np.linalg.norm(keys, axis=-1, keepdims=True)).astype(
        np.float32)
    embed = rng.standard_normal((b, hp, wp, c)).astype(np.float32)
    return match, keys, embed


def _jax_attn(match, keys, scale):
    x_nb = extract_patches_same(jnp.asarray(match), 3, 1)
    return x_nb, jax.nn.softmax(
        jnp.einsum("bpk,blk->bpl", x_nb, jnp.asarray(keys)) * scale, -1)


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


# 15×17 reflect-pads to 16×18; 58² is the 57-wide Set5 tile's geometry
GEOMS_B = [(16, 18, 2), (58, 58, 2), (12, 15, 3)]


@pytest.fixture(params=["one_block", "row_blocks"])
def plain_blocks(request, monkeypatch):
    """Run the plain versions in one block, and in blocks of a few rows
    (so that the blocks' stencil halos and seams are exercised)."""
    if request.param == "row_blocks":
        monkeypatch.setattr(stencil_mod, "PLAIN_BLOCK", 3000)


@pytest.mark.parametrize("hp,wp,s", GEOMS_B)
def test_attention_plain_matches_jax(rng, plain_blocks, hp, wp, s):
    c, cr, scale = 6, 4, 10.0
    match, keys, embed = _inputs(rng, 2, hp, wp, s, c, cr)
    x_nb, attn = _jax_attn(match, keys, scale)
    v = extract_patches_same(jnp.asarray(embed), 3 * s, s)
    ref = np.asarray(jnp.einsum("bpl,blk->bpk", attn, v))
    got = csa_attention_plain(*_t(np.asarray(x_nb), keys, np.asarray(v)),
                              scale).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("hp,wp,s", GEOMS_B)
def test_overlap_add_middles_match_jax(rng, plain_blocks, hp, wp, s):
    """Rows 8 (plane-major bank) and 6 (banks assembled from the maps)
    against the attention and _overlap_add on the tap-major bank."""
    c, cr, scale = 6, 4, 10.0
    match, keys, embed = _inputs(rng, 2, hp, wp, s, c, cr)
    x_nb, attn = _jax_attn(match, keys, scale)
    v = extract_patches_same(jnp.asarray(embed), 3 * s, s)
    ref = np.asarray(_overlap_add(jnp.einsum("bpl,blk->bpk", attn, v), hp,
                                  wp, s, c))
    perm = plane_major_perm(s, c)
    np.testing.assert_array_equal(perm, jax_plane_major_perm(s, c))
    v_pm = np.ascontiguousarray(np.asarray(v)[..., perm])
    got8 = csa_attention_overlap_add_plain(
        *_t(np.asarray(x_nb), keys, v_pm), scale, hp, wp, s).numpy()
    got6 = csa_fused_plain(*_t(match, keys, embed), scale, s).numpy()
    assert got8.shape == got6.shape == ref.shape == (2, s * hp, s * wp, c)
    np.testing.assert_allclose(got8, ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(got6, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("hp,wp,s", GEOMS_B)
def test_stencil_plain_matches_jax(rng, plain_blocks, hp, wp, s):
    c, cr, scale = 6, 4, 10.0
    match, keys, embed = _inputs(rng, 2, hp, wp, s, c, cr)
    _, attn = _jax_attn(match, keys, scale)
    ref = np.asarray(_stencil_reconstruct(attn, jnp.asarray(embed), hp, wp,
                                          s, c))
    got = csa_stencil_plain(*_t(match, keys, embed), scale, s).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


# (c), (d) -------------------------------------------------------- modules
def _csa_pair(x, average=True, seed=3):
    c = x.shape[-1]
    jcsa = JaxCSA(channels=c, average=average)
    params = seeded_params(jcsa, seed, jnp.asarray(x))
    csa = CrossScaleAttention(channels=c, average=average)
    csa.load_state_dict(csa_state_dict_from_jax(params["params"]),
                        strict=True)
    return jcsa, params, csa


MIDDLES = {"stencil_fused": "csa_stencil_fused", "stencil": "csa_stencil",
           "resident": "csa_fused", "windowed": "csa_fused",
           "streaming": "csa_attention"}


@pytest.mark.parametrize("hw", [(16, 16), (15, 17)],
                         ids=["aligned", "reflect_pad"])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_route_each_mode_matches_jax(rng, monkeypatch, mode, hw):
    """CrossScaleAttention(use_kernel=True) with csa_route forced to each
    mode calls that mode's wrapper (its plain version on CPU tensors) and
    matches JAX's module (flash=False)."""
    x = rng.standard_normal((2, *hw, 16)).astype(np.float32)
    jcsa, params, csa = _csa_pair(x)
    ref = np.asarray(jax.jit(jcsa.apply)(params, jnp.asarray(x)))
    calls = []
    monkeypatch.setattr(csa_mod, "csa_route", lambda *a: mode)
    for name in set(MIDDLES.values()):
        fn = getattr(csa_mod, name)
        monkeypatch.setattr(csa_mod, name,
                            lambda *a, _n=name, _f=fn: calls.append(_n)
                            or _f(*a))
    with torch.no_grad():
        got = csa(torch.from_numpy(x), use_kernel=True).numpy()
    assert calls == [MIDDLES[mode]]
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("kind", ["random", "tied"])
def test_average_false_matches_jax(rng, kind):
    """average=False: the one-hot of the softmax maxima. A constant image
    gives every interior key the same patch, so each query row ties."""
    if kind == "random":
        x = rng.standard_normal((2, 15, 17, 16)).astype(np.float32)
    else:
        x = np.broadcast_to(rng.standard_normal(16).astype(np.float32),
                            (1, 12, 14, 16)).copy()
    jcsa, params, csa = _csa_pair(x, average=False, seed=5)
    ref = np.asarray(jax.jit(jcsa.apply)(params, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = csa(xt).numpy()
        routed = csa(xt, use_kernel=True).numpy()
        if kind == "tied":
            match, keys, _ = csa.stencil_inputs(xt, 2, torch.float32)
            attn = torch.softmax(port_patches(match, 3, 1) @ keys.transpose(
                1, 2) * csa.softmax_scale, -1)
            n_max = (attn == attn.amax(-1, keepdim=True)).sum(-1)
            assert int(n_max.max()) > 1
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    # no kernel runs for average=False: the same plain route either way
    np.testing.assert_array_equal(routed, got)


# (e) ------------------------------------------------------ the whole slice
def test_predict_tiled_streaming_matches_jax(monkeypatch):
    """×4 predict_tiled of an 18×22 image: one 18-wide tile size (the
    short side), whose CSA geometry 18×18 the route sends to streaming,
    through the port's kernel route on the CPU (plain versions) against
    JAX's predict_tiled (XLA)."""
    jnet, params = generator_params(SMALL, seed=9)
    jres = JaxRestorer(SMALL)
    port = CiaoSRRestorer(dict(SMALL, use_kernels=True), device="cpu")
    port.generator.load_state_dict(
        state_dict_from_jax(params, feat_dim=16, n_hidden=2), strict=True)
    routes = []
    route = csa_mod.csa_route
    monkeypatch.setattr(csa_mod, "csa_route",
                        lambda *a: routes.append(route(*a)) or routes[-1])
    lq = np.random.default_rng(4).random((18, 22, 3), dtype=np.float32)
    ref = np.asarray(jres.predict_tiled(params, lq, 4, tile=192,
                                        tile_overlap=8))
    got = port.predict_tiled(lq, 4, tile=192, tile_overlap=8)
    assert routes and set(routes) == {"streaming"}
    assert got.shape == ref.shape == (72, 88, 3)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
