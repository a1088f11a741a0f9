"""Port restorer: tiled eval against a composition of JAX per-tile decodes,
the metric protocol against ciaosr_tpu.core.metrics, and the device rule."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciaosr_torch.convert.from_jax import state_dict_from_jax
from ciaosr_torch.models.builder import build_generator
from ciaosr_torch.models.restorers import CiaoSRRestorer
from ciaosr_tpu.core import metrics as jax_metrics
from ciaosr_tpu.core.color import tensor2img
from tests.test_torch_weights import SMALL, generator_params

MEAN = np.asarray((0.4488, 0.4371, 0.4040), np.float32)
TEST_CFG = dict(metrics=["PSNR", "SSIM"], crop_border=2, convert_to="y")


@pytest.fixture(scope="module")
def models():
    jnet, params = generator_params(SMALL, seed=7)
    restorer = CiaoSRRestorer(SMALL, test_cfg=TEST_CFG, device="cpu")
    restorer.generator.load_state_dict(
        state_dict_from_jax(params, feat_dim=16, n_hidden=2), strict=True)
    return jnet, params, restorer


def _tile_starts(n, tile, overlap):
    stride = max(tile - overlap, 1)
    return sorted(set(list(range(0, n - tile, stride)) + [n - tile]))


@partial(jax.jit, static_argnums=(0, 3))
def _jax_tile(jnet, p, t, scale: int):
    tn = t - MEAN
    feat = jnet.apply(p, tn, method="gen_feature")
    return jnet.apply(p, feat, tn, scale, method="query_rgb_grid") + MEAN


def jax_composition(jnet, params, lq, scale: int, tile: int,
                    overlap: int) -> np.ndarray:
    """The oracle of tiled eval: JAX's per-tile encoder and grid decode
    (f32, XLA), overlap-averaged in float64 and clamped."""
    h, w = lq.shape[:2]
    acc = np.zeros((h * scale, w * scale, 3), np.float64)
    cnt = np.zeros((h * scale, w * scale, 1), np.float64)
    for hi in _tile_starts(h, tile, overlap):
        for wi in _tile_starts(w, tile, overlap):
            out = np.asarray(_jax_tile(jnet, params, jnp.asarray(
                lq[None, hi:hi + tile, wi:wi + tile]), scale))[0]
            sl = (slice(hi * scale, (hi + tile) * scale),
                  slice(wi * scale, (wi + tile) * scale))
            acc[sl] += out
            cnt[sl] += 1
    return np.clip(acc / cnt, 0.0, 1.0)


@pytest.mark.parametrize("scale", [2, 4])
def test_predict_tiled_matches_jax_composition(models, scale):
    jnet, params, restorer = models
    lq = np.random.default_rng(scale).random((24, 20, 3), dtype=np.float32)
    tile, overlap = 16, 4
    ref = jax_composition(jnet, params, lq, scale, tile, overlap)
    got = restorer.predict_tiled(lq, scale, tile=tile, tile_overlap=overlap)
    assert got.shape == (24 * scale, 20 * scale, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_evaluate_matches_jax_metrics(models):
    _, _, restorer = models
    rng = np.random.default_rng(3)
    gt = rng.random((40, 36, 3), dtype=np.float32)
    out = np.clip(gt + 0.05 * rng.standard_normal(gt.shape), -0.1, 1.1)
    got = restorer.evaluate(out.astype(np.float32), gt)
    o8, g8 = tensor2img(out.astype(np.float32)), tensor2img(gt)
    assert got["PSNR"] == jax_metrics.psnr(o8, g8, crop_border=2,
                                           convert_to="y")
    # SSIM filters through core/filters.py, not cv2's DFT: the same bound
    # as tests/test_torch_data.py::test_ssim_without_opencv_matches_jax
    ref = jax_metrics.ssim(o8, g8, crop_border=2, convert_to="y")
    assert abs(got["SSIM"] - ref) <= 1e-9, (got["SSIM"], ref)


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_generator(SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CiaoSRRestorer(SMALL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CiaoSRRestorer(SMALL, device="cuda")


@pytest.mark.slow
def test_predict_tiled_matches_jax_pallas_route(models):
    """The JAX restorer's own predict_tiled with use_pallas=True (Pallas
    kernels in interpret mode) against the port's plain route. The Pallas
    decode rounds its activations to bf16 even in an f32 model
    (decoder_kernel.py _mlp_hidden), so the bound is the bf16 class,
    max|Δ| ≤ 1e-2·max|ref|, not the f32 one."""
    from ciaosr_tpu.models.restorers import CiaoSRRestorer as JaxRestorer
    _, params, restorer = models
    jres = JaxRestorer(dict(SMALL, use_pallas=True))
    lq = np.random.default_rng(11).random((24, 20, 3), dtype=np.float32)
    ref = np.asarray(jres.predict_tiled(params, lq, 2, tile=16,
                                        tile_overlap=4))
    got = restorer.predict_tiled(lq, 2, tile=16, tile_overlap=4)
    assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()
