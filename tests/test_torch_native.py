"""The port's native MATLAB bicubic (``ciaosr_torch/data/native.py``, the
repository's ``native/bicubic.cpp`` built with g++ at first use) against
the JAX package's binding of the same source:

* bit for bit against JAX's ``bicubic_resize`` (the same source, flags and
  compiler on the same machine; JAX's library built by ``native/Makefile``
  into a temporary directory, never into ``native/build/``), over sizes,
  scales up and down, 1-4 channels and antialiasing on and off;
* within 1e-6 of the port's numpy path, which ``CIAOSR_NATIVE=0`` takes;
* ``imresize_np`` on the native library by default, for 2-D images too,
  and a build failure raising, naming ``CIAOSR_NATIVE=0``;
* NIQE on the default paths of both packages (both resize natively).
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest

from ciaosr_torch.core import metrics as port_metrics
from ciaosr_torch.core import resize as port_resize
from ciaosr_torch.data import native
from ciaosr_tpu.core import metrics as jax_metrics
from ciaosr_tpu.data import native as jax_native
from tests.test_torch_niqe import picture

ROOT = Path(__file__).resolve().parents[1]

# (H, W, C), output (h, w) or None (ceil(scale·in)), scale, antialiasing
CASES = [((48, 40, 3), None, 0.25, True),
         ((37, 29, 3), (9, 7), 0.25, True),
         ((45, 51, 3), (18, 20), 0.4, True),
         ((13, 11, 3), None, 2.5, True),
         ((17, 9, 3), (40, 21), 7 / 3, True),
         ((30, 30, 3), None, 1 / 3, False),
         ((64, 48, 1), None, 0.5, True),
         ((21, 33, 4), None, 0.5, False),
         ((96, 80, 3), None, 4.0, True),
         ((5, 3, 3), None, 1.0, True)]
IDS = ["x1/4", "9x7", "x0.4", "x2.5", "x7/3", "x1/3_noaa", "1ch", "4ch_noaa",
       "x4", "x1"]


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """JAX's binding, loading a library that ``native/Makefile`` builds
    into a temporary directory."""
    build = tmp_path_factory.mktemp("jax_native")
    subprocess.run(["make", "-C", str(ROOT / "native"), f"BUILD={build}"],
                   check=True, capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_SO", str(build / "libciaosr_native.so"))
        mp.setattr(jax_native, "_LIB", None)
        mp.setattr(jax_native, "_TRIED", False)
        assert jax_native.available()
        yield jax_native


def _case(shape, size, scale):
    img = np.random.default_rng(sum(shape)).random(shape, dtype=np.float32)
    oh, ow = size or (int(np.ceil(shape[0] * scale)),
                      int(np.ceil(shape[1] * scale)))
    return img, oh, ow


@pytest.mark.parametrize("shape,size,scale,aa", CASES, ids=IDS)
def test_native_resize_is_jax_native_bit_for_bit(jax_lib, shape, size,
                                                 scale, aa):
    img, oh, ow = _case(shape, size, scale)
    got = native.bicubic_resize(img, oh, ow, scale, aa)
    ref = jax_lib.bicubic_resize(img, oh, ow, scale, aa)
    assert got.dtype == ref.dtype == np.float32
    assert got.shape == ref.shape == (oh, ow, shape[2])
    np.testing.assert_array_equal(got, ref)
    # the thread count changes no bit
    np.testing.assert_array_equal(
        native.bicubic_resize(img, oh, ow, scale, aa, n_threads=8), got)


@pytest.mark.parametrize("shape,size,scale,aa", CASES, ids=IDS)
def test_imresize_np_native_and_numpy_agree(monkeypatch, shape, size, scale,
                                            aa):
    """``imresize_np`` by default (native) and with ``CIAOSR_NATIVE=0``
    (numpy), on the HWC image and on its first channel as a 2-D image."""
    img, oh, ow = _case(shape, size, scale)
    kw = dict(size=size, scale=scale, antialiasing=aa)
    monkeypatch.delenv("CIAOSR_NATIVE", raising=False)
    got = port_resize.imresize_np(img, **kw)
    got2 = port_resize.imresize_np(img[..., 0], **kw)
    np.testing.assert_array_equal(
        got, native.bicubic_resize(img, oh, ow, scale, aa))
    monkeypatch.setenv("CIAOSR_NATIVE", "0")
    ref = port_resize.imresize_np(img, **kw)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got2, port_resize.imresize_np(img[..., 0],
                                                             **kw),
                               atol=1e-6, rtol=0)
    assert got2.shape == (oh, ow)


def test_switch_selects_the_path(monkeypatch):
    """The default takes the native library; ``CIAOSR_NATIVE=0`` never
    calls it."""
    calls = []
    resize = native.bicubic_resize

    def spy(*a, **k):
        calls.append(a[1:3])
        return resize(*a, **k)

    monkeypatch.setattr(native, "bicubic_resize", spy)
    img = np.random.default_rng(1).random((20, 16, 3), dtype=np.float32)
    monkeypatch.delenv("CIAOSR_NATIVE", raising=False)
    port_resize.imresize_np(img, scale=0.5)
    port_resize.imresize_np(img[..., 1], scale=0.5)
    assert calls == [(10, 8), (10, 8)]
    monkeypatch.setenv("CIAOSR_NATIVE", "0")
    port_resize.imresize_np(img, scale=0.5)
    assert len(calls) == 2


def test_build_failure_raises(monkeypatch, tmp_path):
    """A source g++ cannot compile: the default path raises, naming the
    switch, and builds nothing in place; the numpy path still resizes."""
    bad = tmp_path / "bicubic.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.delenv("CIAOSR_NATIVE", raising=False)
    img = np.zeros((8, 8, 3), np.float32)
    with pytest.raises(RuntimeError, match="CIAOSR_NATIVE=0"):
        port_resize.imresize_np(img, scale=0.5)
    assert not native.library_path().exists()
    monkeypatch.setenv("CIAOSR_NATIVE", "0")
    assert port_resize.imresize_np(img, scale=0.5).shape == (4, 4, 3)


@pytest.mark.parametrize("i", range(2))
def test_niqe_default_path_matches_jax_default_path(monkeypatch, jax_lib, i):
    """NIQE resizes its 2-D float64 image by half: both packages' default
    paths cast it to float32 and take the native library."""
    monkeypatch.delenv("CIAOSR_NATIVE", raising=False)
    img = picture(i)
    got = port_metrics.niqe(img, crop_border=4, convert_to="y")
    ref = jax_metrics.niqe(img, crop_border=4, convert_to="y")
    assert np.isfinite(got) and abs(got - ref) <= 1e-6, (got, ref)
