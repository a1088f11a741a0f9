"""``core/cvresize.py`` against ``cv2.resize``: every mode enlarging,
shrinking, mixed, at an integer factor, to 1 px and at the same size, on
images in [−0.5, 1.5] (float32 and float64; 2-D, 3-D and 1-channel), the
shapes equal and the values within 1e-5; uint8 in the bicubic mode bit
for bit. Also ``RandomDownSampling(backend='cv2')`` against the JAX
package's op.
"""

import cv2
import numpy as np
import pytest

from ciaosr_torch.core.cvresize import resize
from ciaosr_torch.data import pipelines as port_pl
from ciaosr_tpu.data import pipelines as jax_pl

CV2 = dict(bilinear=cv2.INTER_LINEAR, bicubic=cv2.INTER_CUBIC,
           area=cv2.INTER_AREA, lanczos=cv2.INTER_LANCZOS4)
SIZES = {"enlarge": (80, 72), "shrink": (13, 11), "integer": (20, 18),
         "integer_up": (120, 108), "mixed": (57, 23), "mixed2": (23, 57),
         "one_px": (1, 1), "thin": (3, 100), "near": (41, 35),
         "same": (40, 36)}


@pytest.mark.parametrize("case", sorted(SIZES))
@pytest.mark.parametrize("mode", sorted(CV2))
def test_resize_matches_cv2(mode, case):
    oh, ow = SIZES[case]
    rng = np.random.default_rng(len(case) * 7 + len(mode))
    for ih, iw in ((40, 36), (7, 9), (1, 5)):
        for c in (None, 1, 3):
            for dt in (np.float32, np.float64):
                shape = (ih, iw) if c is None else (ih, iw, c)
                img = (rng.random(shape) * 2 - 0.5).astype(dt)
                ref = cv2.resize(img, (ow, oh), interpolation=CV2[mode])
                got = resize(img, (oh, ow), mode)
                assert got.shape == ref.shape and got.dtype == ref.dtype, (
                    shape, got.shape, ref.shape)
                np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0,
                                           err_msg=str((shape, dt)))


def test_resize_uint8_bicubic_is_cv2_and_others_refuse():
    rng = np.random.default_rng(1)
    for (h, w, oh, ow) in ((64, 64, 16, 16), (100, 80, 25, 20),
                           (50, 50, 13, 17), (40, 36, 80, 72)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(
            resize(img, (oh, ow), "bicubic"),
            cv2.resize(img, (ow, oh), interpolation=cv2.INTER_CUBIC))
    with pytest.raises(TypeError, match="bicubic"):
        resize(img, (10, 10), "bilinear")
    with pytest.raises(ValueError, match="positive"):
        resize(img.astype(np.float32), (0, 4), "area")


@pytest.mark.parametrize("ops", [
    [dict(type="RandomDownSampling", scale_min=1, scale_max=4,
          patch_size=12, backend="cv2")],
    [dict(type="RandomDownSampling", scale_min=3, scale_max=3,
          backend="cv2")]], ids=["patch_float", "eval_uint8"])
def test_random_down_sampling_cv2_backend_matches_jax(ops):
    """The cv2 backend on the same image and seed: JAX's op (cv2's
    INTER_CUBIC) within 1e-5, uint8 bit for bit."""
    rng = np.random.default_rng(7)
    gt = rng.integers(0, 256, (50, 47, 3), dtype=np.uint8)
    if "patch_size" in ops[0]:
        gt = gt.astype(np.float32) / 255.0
    for seed in range(4):
        port, ref = (pl.Compose(ops)({"gt": gt.copy(),
                                      "_rng": np.random.default_rng(seed)})
                     for pl in (port_pl, jax_pl))
        assert port["scale"] == ref["scale"]
        np.testing.assert_array_equal(port["gt"], ref["gt"])
        assert port["lq"].shape == ref["lq"].shape
        assert port["lq"].dtype == ref["lq"].dtype
        np.testing.assert_allclose(port["lq"], ref["lq"], atol=1e-5, rtol=0)
