"""The port's matting metrics and ``ycbcr2rgb`` against the JAX package's
(which run on OpenCV): ``sad``, ``matting_mse`` and its alias ``mse``,
``gradient_error`` and ``connectivity`` on seeded mattes, ≤ 1e-9 abs
(``gradient_error`` ≤ 1e-6 relative: cv2 filters its 9² kernels by DFT
and fuses the min-max multiply-add, and the gradients are cast to
float32); a size tie between two components (cv2 takes the lower label,
the first in raster order), a constant prediction, and the input checks.
"""

import numpy as np
import pytest

from ciaosr_torch.core import color as port_color
from ciaosr_torch.core import metrics as port_metrics
from ciaosr_tpu.core import color as jax_color
from ciaosr_tpu.core import metrics as jax_metrics

METRICS = ("sad", "matting_mse", "mse", "gradient_error", "connectivity")


def matte(seed: int, h: int, w: int):
    """(alpha, trimap, pred_alpha): a smooth seeded alpha with a band of
    unknown pixels, a noisy prediction masked by the trimap."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    f = np.sin(2 * np.pi * (rng.uniform(0.5, 2) * y + rng.uniform(0.5, 2)
                            * x) + rng.uniform(0, 6))
    alpha = np.clip(np.round((f + 1) * 160 - 32), 0, 255).astype(np.uint8)
    trimap = np.full((h, w), 128, np.uint8)
    trimap[alpha == 0] = 0
    trimap[alpha == 255] = 255
    grow = rng.random((h, w)) < 0.3          # some known pixels unknown
    trimap[grow] = 128
    pred = np.clip(alpha.astype(int) + rng.integers(-40, 41, (h, w)), 0,
                   255).astype(np.uint8)
    pred[trimap == 0], pred[trimap == 255] = 0, 255
    return alpha, trimap, pred


def close(name, got, ref):
    if name == "gradient_error":
        return abs(got - ref) <= 1e-6 * abs(ref)
    return abs(got - ref) <= 1e-9


@pytest.mark.parametrize("name", METRICS)
@pytest.mark.parametrize("seed,hw", [(0, (60, 80)), (1, (33, 47)),
                                     (2, (120, 96))])
def test_matting_metrics_match_jax(name, seed, hw):
    a, t, p = matte(seed, *hw)
    got = getattr(port_metrics, name)(a, t, p)
    ref = getattr(jax_metrics, name)(a, t, p)
    assert isinstance(got, float) and ref > 0
    assert close(name, got, ref), (got, ref)


@pytest.mark.parametrize("first,second,penalized", [
    ((1, 1), (5, 8), True), ((2, 1), (0, 8), False)])
def test_connectivity_size_tie_takes_the_first_component(first, second,
                                                         penalized):
    """Two 4-pixel components at every threshold up to 0.9, the second's
    prediction 230: the raster-first one counts as the largest. Where
    that is the 255 one, the other's round-down level is 0 and its
    prediction is penalized; where it is the 230 one, nothing is. Against
    cv2's labels (through JAX)."""
    alpha = np.zeros((8, 12), np.uint8)
    alpha[first[0]:first[0] + 2, first[1]:first[1] + 2] = 255
    alpha[second[0]:second[0] + 2, second[1]:second[1] + 2] = 255
    pred = alpha.copy()
    pred[second[0]:second[0] + 2, second[1]:second[1] + 2] = 230
    trimap = np.full_like(alpha, 128)
    got = port_metrics.connectivity(alpha, trimap, pred)
    ref = jax_metrics.connectivity(alpha, trimap, pred)
    assert abs(got - ref) <= 1e-9, (got, ref)
    assert (got > 0) == penalized


@pytest.mark.parametrize("name", METRICS)
def test_constant_prediction_matches_jax(name):
    """A constant prediction normalizes to zeros (cv2's scale 0)."""
    a, _, _ = matte(5, 30, 40)
    t = np.full_like(a, 128)
    p = np.full_like(a, 100)
    got = getattr(port_metrics, name)(a, t, p)
    ref = getattr(jax_metrics, name)(a, t, p)
    assert close(name, got, ref), (got, ref)
    # an empty unknown region: no pixel weighs
    t0 = np.full_like(a, 255)
    p0 = np.full_like(a, 255)
    assert getattr(port_metrics, name)(a, t0, p0) == \
        getattr(jax_metrics, name)(a, t0, p0)


@pytest.mark.parametrize("name", METRICS)
def test_input_checks_raise_as_jax(name):
    a, t, p = matte(3, 20, 24)
    bad_mask = p.copy()
    bad_mask[t == 0] = 7
    for args, match in (((a[..., None], t, p), "2-D"),
                        ((a, t, bad_mask), "masked by trimap")):
        for mod in (port_metrics, jax_metrics):
            with pytest.raises(ValueError, match=match):
                getattr(mod, name)(*args)


def test_mse_is_matting_mse():
    assert port_metrics.mse is port_metrics.matting_mse


def test_ycbcr2rgb_matches_jax():
    rng = np.random.default_rng(9)
    for shape in ((5, 7, 3), (16, 3)):
        img = rng.random(shape, dtype=np.float32)
        got = port_color.ycbcr2rgb(img)
        ref = jax_color.ycbcr2rgb(img)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=1e-9, rtol=0)
