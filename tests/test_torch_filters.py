"""``core/filters.py`` against OpenCV: ``filter2d`` against
``cv2.filter2D`` (every odd size 1-21, USM's 51² Gaussian, even and
rectangular kernels, images smaller than the kernel's reach, 2-D, 3-D and
1-channel inputs, float32 / float64 images and kernels; each of its three
routes), ``gaussian_kernel_1d`` against ``cv2.getGaussianKernel`` and
``rgb2gray`` against ``cv2.cvtColor(COLOR_RGB2GRAY)``. OpenCV is the
oracle here; the port itself never imports it.
"""

import cv2
import numpy as np
import pytest

from ciaosr_torch.core import filters
from ciaosr_torch.core.filters import filter2d, gaussian_kernel_1d, rgb2gray

SHAPES = [(40, 37, 3), (40, 37), (40, 37, 1), (1, 1, 3), (2, 3), (5, 4, 3),
          (3, 60, 3), (9, 9)]


def _kernel(rng, kh, kw, dtype):
    if kh == 51:                     # USM's kernel: an outer product
        g = cv2.getGaussianKernel(51, 0)
        return (g @ g.T).astype(dtype)
    k = rng.random((kh, kw))
    return (k / k.sum()).astype(dtype)


@pytest.mark.parametrize("ks", list(range(1, 22, 2)) + [51, 4, (3, 8),
                                                       (1, 5), (7, 1)],
                         ids=str)
def test_filter2d_matches_cv2(ks):
    """Each kernel on every input shape and dtype pair: cv2's shape and
    dtype, values within 1e-6."""
    kh, kw = (ks, ks) if isinstance(ks, int) else ks
    rng = np.random.default_rng(kh * 31 + kw)
    for shape in SHAPES:
        for dt in (np.float32, np.float64):
            for kdt in (np.float32, np.float64):
                img = (rng.random(shape) * 2 - 0.5).astype(dt)
                k = _kernel(rng, kh, kw, kdt)
                ref = cv2.filter2D(img, -1, k)
                got = filter2d(img, k)
                assert got.shape == ref.shape and got.dtype == ref.dtype, (
                    shape, got.shape, ref.shape)
                np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0,
                                           err_msg=str((shape, dt, kdt)))


@pytest.mark.parametrize("route", ["separable", "direct", "fft"])
def test_filter2d_routes(route, monkeypatch):
    """The route each kernel takes, and each route on a 400² RGB image as
    the degradation chain gives it."""
    rng = np.random.default_rng(3)
    img = rng.random((400, 400, 3), dtype=np.float32)
    calls = []
    for name in ("_direct", "_fft", "_correlate_axis"):
        fn = getattr(filters, name)
        monkeypatch.setattr(filters, name,
                            lambda *a, _f=fn, _n=name: calls.append(_n)
                            or _f(*a))
    if route == "separable":
        g = gaussian_kernel_1d(51, 0)
        k, want = g @ g.T, "_correlate_axis"
    else:
        ks = 7 if route == "direct" else 21
        k, want = _kernel(rng, ks, ks, np.float32), "_" + route
    np.testing.assert_allclose(filter2d(img, k), cv2.filter2D(img, -1, k),
                               atol=1e-6, rtol=0)
    assert set(calls) == {want}


@pytest.mark.parametrize("ksize", [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 21,
                                   51])
def test_gaussian_kernel_matches_cv2(ksize):
    for sigma in (0, -1, 0.3, 1.5, 3.3):
        np.testing.assert_allclose(gaussian_kernel_1d(ksize, sigma),
                                   cv2.getGaussianKernel(ksize, sigma),
                                   atol=1e-12, rtol=0,
                                   err_msg=str(sigma))


@pytest.mark.parametrize("hw", [(1, 1), (3, 2), (7, 7), (50, 5), (40, 300),
                                (9, 301), (17, 15), (2, 16), (5, 12)])
def test_rgb2gray_matches_cv2(hw):
    """cv2's bits (the Poisson noise's draws hang on them); another dtype
    raises."""
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    img = (rng.random(hw + (3,)) * 1.5 - 0.2).astype(np.float32)
    ref = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    got = rgb2gray(img)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="float32"):
        rgb2gray(img.astype(np.float64))
