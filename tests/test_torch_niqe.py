"""The port's NIQE against the JAX package's, and what it is built on:

* ``niqe`` on 3 seeded pictures (crop_border 0 and 4, ``convert_to`` y
  and gray) and a gray 2-D input, ≤ 1e-6 abs of JAX's. JAX's
  ``imresize_np`` takes its C++ fast path for NIQE's 2-D image where the
  library is built, which first casts the float64 image to float32 (one
  float32 step apart); the reference here is its numpy path
  (``CIAOSR_NATIVE=0``), the numerics the port's ``imresize_np`` has.
* ``_fit_aggd`` and ``_compute_niqe_feature`` against JAX's, bit for bit;
* the port's copy of the pristine parameters equal to JAX's file, and
  its resolution (explicit path > ``CIAOSR_NIQE_PARAMS`` > the copy);
* ``filter2d(border="replicate")`` against ``cv2.filter2D(...,
  borderType=cv2.BORDER_REPLICATE)`` (NIQE's 7² window on float64 bit
  for bit) and ``bgr2gray`` against ``cv2.cvtColor(COLOR_BGR2GRAY)`` bit
  for bit; OpenCV is the oracle here, the port never imports it;
* the port's NIQE, matting metrics and ``BasicRestorer.evaluate`` with
  ``cv2`` unimportable.
"""

import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from chip_smoke import smooth_picture
from ciaosr_torch.core import metrics as port_metrics
from ciaosr_torch.core.filters import bgr2gray, filter2d, rgb2gray
from ciaosr_torch.models.restorers import BasicRestorer
from ciaosr_tpu.core import metrics as jax_metrics

ROOT = Path(__file__).resolve().parents[1]
PICTURES = ((200, 230), (193, 290), (288, 352))


def picture(i: int) -> np.ndarray:
    """A seeded uint8 BGR picture with texture: a smooth picture plus
    Gaussian noise."""
    rng = np.random.default_rng(40 + i)
    img = smooth_picture(rng, *PICTURES[i]).astype(np.float64)
    return np.clip(np.round(img + rng.normal(0, 6, img.shape)), 0,
                   255).astype(np.uint8)


@pytest.mark.parametrize("convert_to", ["y", "gray"])
@pytest.mark.parametrize("crop", [0, 4])
@pytest.mark.parametrize("i", range(len(PICTURES)))
def test_niqe_matches_jax(monkeypatch, i, crop, convert_to):
    monkeypatch.setenv("CIAOSR_NATIVE", "0")
    img = picture(i)
    got = port_metrics.niqe(img, crop_border=crop, convert_to=convert_to)
    ref = jax_metrics.niqe(img, crop_border=crop, convert_to=convert_to)
    assert np.isfinite(got) and abs(got - ref) <= 1e-6, (got, ref)


def test_niqe_of_a_gray_image_matches_jax(monkeypatch):
    monkeypatch.setenv("CIAOSR_NATIVE", "0")
    img = picture(1)[..., 1]
    for crop in (0, 3):
        got = port_metrics.niqe(img, crop_border=crop)
        ref = jax_metrics.niqe(img, crop_border=crop)
        assert abs(got - ref) <= 1e-6, (crop, got, ref)
    with pytest.raises(ValueError, match="convert_to"):
        port_metrics.niqe(picture(0), convert_to="lab")


def test_aggd_fit_and_features_match_jax():
    rng = np.random.default_rng(7)
    for x in (rng.normal(0, 1, (48, 48)),
              rng.laplace(0.2, 0.5, (96, 96)),
              np.abs(rng.normal(0, 1, (30, 40)))):      # no negatives
        assert port_metrics._fit_aggd(x) == jax_metrics._fit_aggd(x)
        np.testing.assert_array_equal(
            port_metrics._compute_niqe_feature(x),
            jax_metrics._compute_niqe_feature(x))


def test_niqe_params_copy_and_resolution(monkeypatch, tmp_path):
    ours = ROOT / "ciaosr_torch" / "core" / "data" / "niqe_pris_params.npz"
    theirs = ROOT / "ciaosr_tpu" / "core" / "data" / "niqe_pris_params.npz"
    assert ours.read_bytes() == theirs.read_bytes()
    monkeypatch.delenv("CIAOSR_NIQE_PARAMS", raising=False)
    mu, cov, win = port_metrics._load_niqe_params()
    for a, b in zip((mu, cov, win), jax_metrics._load_niqe_params()):
        np.testing.assert_array_equal(a, b)
    assert mu.size == 36 and cov.shape == (36, 36) and win.shape == (7, 7)

    env, arg = tmp_path / "env.npz", tmp_path / "arg.npz"
    np.savez(env, mu_pris_param=mu + 1, cov_pris_param=cov,
             gaussian_window=win)
    np.savez(arg, mu_pris_param=mu + 2, cov_pris_param=cov,
             gaussian_window=win)
    monkeypatch.setenv("CIAOSR_NIQE_PARAMS", str(env))
    np.testing.assert_array_equal(port_metrics._load_niqe_params()[0],
                                  mu + 1)
    np.testing.assert_array_equal(
        port_metrics._load_niqe_params(str(arg))[0], mu + 2)
    img = picture(0)
    assert port_metrics.niqe(img, params_path=str(arg)) != \
        port_metrics.niqe(img)
    monkeypatch.setenv("CIAOSR_NIQE_PARAMS", str(tmp_path / "none.npz"))
    with pytest.raises(FileNotFoundError, match="CIAOSR_NIQE_PARAMS"):
        port_metrics.niqe(img)


@pytest.mark.parametrize("ks", [1, 3, 7, 9, (1, 5), (7, 1), 4, 21],
                         ids=str)
def test_filter2d_replicate_matches_cv2(ks):
    """Each kernel on 2-D, 3-D and 1-channel images, some smaller than its
    reach, float32 and float64: cv2's shape and dtype, values within
    1e-6; a float64 image and a kernel of at most 49 taps (cv2's direct
    loop, NIQE's window) bit for bit."""
    kh, kw = (ks, ks) if isinstance(ks, int) else ks
    rng = np.random.default_rng(kh * 17 + kw)
    for shape in [(40, 37, 3), (40, 37), (40, 37, 1), (2, 3), (3, 60, 3),
                  (9, 9)]:
        for dt in (np.float32, np.float64):
            img = (rng.random(shape) * 2 - 0.5).astype(dt)
            k = rng.random((kh, kw))
            k /= k.sum()
            ref = cv2.filter2D(img, -1, k, borderType=cv2.BORDER_REPLICATE)
            got = filter2d(img, k, border="replicate")
            assert got.shape == ref.shape and got.dtype == ref.dtype
            if dt == np.float64 and kh * kw <= 49:
                np.testing.assert_array_equal(got, ref, err_msg=str(shape))
            else:
                np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0,
                                           err_msg=str((shape, dt)))
    with pytest.raises(ValueError, match="border"):
        filter2d(np.zeros((4, 4)), np.ones((3, 3)), border="reflect")


def test_niqe_window_filters_as_cv2_does():
    """NIQE's two filters, bit for bit: the window is an outer product,
    which the replicate border does not split (cv2 never does)."""
    win = port_metrics._load_niqe_params()[2]
    img = np.round(picture(2)[..., 0].astype(np.float64))
    for x in (img, img ** 2):
        np.testing.assert_array_equal(
            filter2d(x, win, border="replicate"),
            cv2.filter2D(x, -1, win, borderType=cv2.BORDER_REPLICATE))


@pytest.mark.parametrize("hw", [(1, 1), (3, 2), (7, 7), (50, 5), (40, 300),
                                (9, 301), (17, 15), (2, 16), (5, 12)])
def test_bgr2gray_matches_cv2(hw):
    """cv2 runs its fma order over the channels as they lie in memory:
    bgr2gray has its bits, rgb2gray of the reversed image need not."""
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    img = (rng.random(hw + (3,)) * 1.5 - 0.2).astype(np.float32)
    ref = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    got = bgr2gray(img)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(rgb2gray(np.ascontiguousarray(
        img[..., ::-1])), ref, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="bgr2gray takes"):
        bgr2gray(img.astype(np.float64))


def test_metrics_need_no_opencv(monkeypatch):
    """With ``import cv2`` failing: NIQE (y and gray), the four matting
    metrics and a BasicRestorer's evaluate run and give the scores they
    give with OpenCV importable."""
    img = picture(0)
    rng = np.random.default_rng(3)
    alpha = rng.integers(0, 256, (40, 50)).astype(np.uint8)
    trimap = np.full((40, 50), 128, np.uint8)
    trimap[:5], trimap[-5:] = 0, 255
    pred = rng.integers(0, 256, (40, 50)).astype(np.uint8)
    pred[trimap == 0], pred[trimap == 255] = 0, 255
    res = BasicRestorer(dict(type="EDSRNet", mid_channels=4, num_blocks=1,
                             upscale_factor=2), device="cpu",
                        test_cfg=dict(metrics=["PSNR", "SSIM"],
                                      crop_border=2))
    out = res.predict(rng.random((12, 10, 3), dtype=np.float32))
    gt = rng.random(out.shape, dtype=np.float32)

    def scores():
        return ([port_metrics.niqe(img, convert_to=c) for c in ("y", "gray")]
                + [getattr(port_metrics, f)(alpha, trimap, pred)
                   for f in ("sad", "mse", "gradient_error",
                             "connectivity")]
                + [res.evaluate(out, gt)])

    with_cv2 = scores()
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2 as _  # noqa: F401
    assert scores() == with_cv2
