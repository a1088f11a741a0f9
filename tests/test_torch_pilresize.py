"""The port's Pillow bicubic (``ciaosr_torch/core/pilresize.py``) against
Pillow itself, and the ``pillow`` backend of ``RandomDownSampling``
against the JAX package's (which calls Pillow).

* ``resize_bicubic`` bit for bit against ``PIL.Image.resize(...,
  BICUBIC)`` over a seeded sweep of sizes from 1 to 97 pixels a side,
  down and up on each axis, RGB and gray images, and at unchanged sizes
  (a copy); Pillow is the oracle here, the port never imports it;
* the pipeline op, eval and patch mode, bit for bit against JAX's on
  the same image and seed.
"""

import numpy as np
import pytest
from PIL import Image

from ciaosr_torch.core.pilresize import coeffs, resize_bicubic
from ciaosr_torch.data import pipelines as port_pl
from ciaosr_tpu.data import pipelines as jax_pl


def _pil(img, oh, ow):
    return np.asarray(Image.fromarray(img).resize((ow, oh), Image.BICUBIC))


@pytest.mark.parametrize("seed", range(8))
def test_resize_matches_pillow(seed):
    """40 random (in, out) size pairs a seed, each axis 1-97 pixels."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        h, w, oh, ow = (int(v) for v in rng.integers(1, 98, 4))
        shape = (h, w, 3) if seed % 2 == 0 else (h, w)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        got = resize_bicubic(img, oh, ow)
        assert got.dtype == np.uint8 and got.shape == (oh, ow, *shape[2:])
        np.testing.assert_array_equal(got, _pil(img, oh, ow),
                                      err_msg=f"{shape} -> {oh}x{ow}")


@pytest.mark.parametrize("hw,out", [((64, 64), (16, 16)), ((96, 72), (24, 18)),
                                    ((1, 1), (7, 5)), ((97, 1), (1, 97)),
                                    ((30, 40), (30, 13)), ((30, 40), (77, 40)),
                                    ((23, 23), (23, 23))],
                         ids=["x1/4", "x1/4_rect", "1px_up", "line",
                              "width_only", "height_only", "same_size"])
def test_resize_edges_match_pillow(hw, out):
    """Integer factors, one-pixel images, one axis unchanged (one pass
    only) and no change at all (a copy, not the input)."""
    img = np.random.default_rng(sum(hw)).integers(0, 256, (*hw, 3),
                                                  dtype=np.uint8)
    got = resize_bicubic(img, *out)
    np.testing.assert_array_equal(got, _pil(img, *out))
    assert got is not img and not np.shares_memory(got, img)


def test_taps_are_pillow_fixed_point():
    """Each output's taps sum to 2^22 within the rounding of its taps,
    and no tap lies outside its window."""
    for n_in, n_out in ((97, 13), (13, 97), (40, 40), (5, 1)):
        xmin, k = coeffs(n_in, n_out)
        assert xmin.min() >= 0
        assert np.all(np.abs(k.sum(1) - (1 << 22)) <= k.shape[1])
    with pytest.raises(ValueError, match="uint8"):
        resize_bicubic(np.zeros((4, 4), np.float32), 2, 2)


@pytest.mark.parametrize("patch", [None, 12], ids=["eval", "patch"])
def test_pillow_backend_matches_jax(patch):
    """RandomDownSampling(backend="pillow") on a float image in [0, 1]
    with values outside it (clipped on the way in): the same LR, GT and
    scale as JAX's, bit for bit."""
    rng = np.random.default_rng(5)
    gt = (rng.random((53, 61, 3), dtype=np.float32) * 1.2 - 0.1)
    cfg = dict(scale_min=1.5, scale_max=4.0, patch_size=patch,
               backend="pillow")
    out = {}
    for name, mod in (("port", port_pl), ("jax", jax_pl)):
        res = {"gt": gt.copy(), "_rng": np.random.default_rng(11)}
        out[name] = mod.RandomDownSampling(**cfg)(res)
    for key in ("gt", "lq"):
        assert out["port"][key].dtype == out["jax"][key].dtype
        np.testing.assert_array_equal(out["port"][key], out["jax"][key])
    assert out["port"]["lq"].dtype == np.float32
    assert out["port"]["scale"] == out["jax"]["scale"]
