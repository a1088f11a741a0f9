"""Port sampling / neighbourhood ops vs the JAX package (f32, ≤1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciaosr_torch.ops import neighborhood as tn
from ciaosr_torch.ops import sampling as ts
from ciaosr_tpu.ops import neighborhood as jn
from ciaosr_tpu.ops import sampling as js
from tests import test_torch_weights  # noqa: F401 (caps torch's threads)


@pytest.mark.parametrize("shape,out", [((2, 15, 17, 3), (7, 8)),
                                       ((1, 9, 10, 4), (27, 40)),
                                       ((1, 16, 16, 5), (8, 8))])
def test_interpolate_bilinear(rng, shape, out):
    x = rng.standard_normal(shape).astype(np.float32)
    ref = np.asarray(js.interpolate_bilinear(jnp.asarray(x), *out))
    got = ts.interpolate_bilinear(torch.from_numpy(x), *out).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_nearest_index(rng):
    c = rng.uniform(-1, 1, (500,)).astype(np.float32)
    c[:4] = [-1.0, 1.0, 0.0, -0.5]
    for n in (7, 8, 13):
        ref = np.asarray(js.nearest_index(jnp.asarray(c), n))
        got = ts.nearest_index(torch.from_numpy(c), n).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", [(2, 7, 9, 4), (1, 8, 8, 3)])
def test_unfold_nhwc(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    ref = np.asarray(jn.unfold_nhwc(jnp.asarray(x)))
    got = tn.unfold_nhwc(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape,k,s", [((2, 7, 9, 3), 3, 1),
                                       ((1, 15, 17, 2), 3, 2),
                                       ((1, 16, 12, 2), 6, 2)])
def test_extract_patches_same(rng, shape, k, s):
    x = rng.standard_normal(shape).astype(np.float32)
    ref = np.asarray(jn.extract_patches_same(jnp.asarray(x), k, s))
    got = tn.extract_patches_same(torch.from_numpy(x), k, s).numpy()
    np.testing.assert_array_equal(got, ref)


def test_tap_major_perm_matches_converter():
    from ciaosr_tpu.convert.torch_weights import tap_major_perm
    for c in (3, 16, 64):
        np.testing.assert_array_equal(tn.tap_major_perm(c),
                                      tap_major_perm(c))
