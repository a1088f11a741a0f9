"""``data/jpeg.py``'s round trip against OpenCV's (libjpeg-turbo) encode
and decode, bit for bit, at qualities 5, 30, 50, 94 and 95 (and the
clamped ends) on 1×1, 7×9, 17×33, 64×64 and 75×100 images (noise, a
smooth picture and a flat one), which cover the edge replication, the
plain 2×2 chroma upsampling of planes ≤ 2 samples wide and the fancy
one."""

import cv2
import numpy as np
import pytest

from chip_smoke import smooth_picture
from ciaosr_torch.data.jpeg import jpeg_roundtrip, quant_tables


def cv2_roundtrip(rgb, quality):
    _, buf = cv2.imencode(".jpg", rgb[..., ::-1],
                          [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    return cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1]


@pytest.mark.parametrize("hw", [(1, 1), (7, 9), (17, 33), (64, 64),
                                (75, 100), (3, 4), (5, 3)], ids=str)
@pytest.mark.parametrize("quality", [5, 30, 50, 94, 95, 0, 100])
def test_roundtrip_is_cv2s(hw, quality):
    rng = np.random.default_rng(hw[0] * 100 + hw[1] + quality)
    images = {"noise": rng.integers(0, 256, hw + (3,), dtype=np.uint8),
              "smooth": smooth_picture(rng, *hw),
              "flat": np.full(hw + (3,), 77, np.uint8)}
    for kind, img in images.items():
        got = jpeg_roundtrip(img, quality)
        assert got.dtype == np.uint8 and got.shape == img.shape
        np.testing.assert_array_equal(got, cv2_roundtrip(img, quality),
                                      err_msg=kind)


def test_quant_tables_and_input_checks():
    luma, chroma = quant_tables(50)
    assert luma[0, 0] == 16 and chroma[0, 0] == 17
    assert (quant_tables(5)[0] == 255).sum() > 0       # force_baseline
    assert (quant_tables(100)[0] == 1).all()
    with pytest.raises(ValueError, match="uint8"):
        jpeg_roundtrip(np.zeros((4, 4, 3), np.float32), 50)
