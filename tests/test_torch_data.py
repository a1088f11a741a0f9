"""The port's host data layer against OpenCV and the JAX package: the
PNG codec bit-equal to ``cv2`` both ways, ``imresize_np`` against JAX's
(numpy and default paths), each eval pipeline op and dataset class
bit-equal to JAX's on the same files and seeds, and the SSIM branch the
card takes (no OpenCV) against JAX's ``ssim``.
"""

import sys

import cv2
import numpy as np
import pytest

from ciaosr_torch.config import Config
from ciaosr_torch.core import metrics as port_metrics
from ciaosr_torch.core.resize import imresize_np
from ciaosr_torch.data import datasets as port_ds
from ciaosr_torch.data import pipelines as port_pl
from ciaosr_torch.data.imageio import imread, imwrite, read_png, write_png
from ciaosr_tpu.core import metrics as jax_metrics
from ciaosr_tpu.core.resize import imresize_np as jax_imresize
from ciaosr_tpu.data import datasets as jax_ds
from ciaosr_tpu.data import pipelines as jax_pl
from chip_smoke import smooth_picture
from tests.test_torch_cli import write_folder
from tests.test_torch_config import CONFIGS_001

# cv2's channel order for C channels of a file in RGB(A) order
_TO_CV2 = {1: [0], 3: [2, 1, 0], 4: [2, 1, 0, 3]}


def _image(c, seed=0, hw=(23, 31)):
    return np.random.default_rng(seed).integers(0, 256, (*hw, c),
                                                dtype=np.uint8)


@pytest.mark.parametrize("c", [1, 3, 4], ids=["gray", "rgb", "rgba"])
@pytest.mark.parametrize("filt", range(5),
                         ids=["none", "sub", "up", "average", "paeth"])
def test_port_png_reads_back_in_cv2(tmp_path, c, filt):
    """Each filter type and colour type the port writes: cv2 reads the
    same pixels, and so does the port."""
    img = _image(c, seed=filt)
    path = str(tmp_path / "x.png")
    write_png(path, img, filter_type=filt)
    np.testing.assert_array_equal(read_png(path), img)
    got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got.reshape(img.shape),
                                  img[..., _TO_CV2[c]])


@pytest.mark.parametrize("c", [1, 3, 4], ids=["gray", "rgb", "rgba"])
@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_cv2_png_reads_in_port(tmp_path, c, kind):
    """PNGs cv2 writes (libpng picks the row filters): ``read_png`` gives
    the file's pixels and ``imread`` gives ``cv2.imread``'s colour pixels
    in RGB and BGR order."""
    img = _image(c) if kind == "noise" else np.concatenate(
        [smooth_picture(np.random.default_rng(1), 40, 36)] * 2, axis=2)[..., :c]
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, img[..., _TO_CV2[c]])
    np.testing.assert_array_equal(read_png(path), img)
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(imread(path, "bgr"), bgr)
    np.testing.assert_array_equal(imread(path),
                                  cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))


def test_other_formats_need_opencv(tmp_path, monkeypatch):
    """A PNG the codec does not take raises; another extension goes
    through OpenCV, and raises without it."""
    deep = str(tmp_path / "deep.png")
    cv2.imwrite(deep, np.zeros((4, 4, 3), np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        read_png(deep)
    img = _image(3)
    path = str(tmp_path / "x.bmp")
    imwrite(path, img)
    np.testing.assert_array_equal(imread(path), img)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ValueError, match="PNG"):
        imread(path)
    with pytest.raises(ValueError, match="PNG"):
        imwrite(str(tmp_path / "y.jpg"), img)


@pytest.mark.parametrize("native", ["0", "1"], ids=["numpy", "default"])
@pytest.mark.parametrize("hw,kw", [
    ((48, 40), dict(scale=0.25)),
    ((37, 29), dict(size=(9, 7), scale=0.25)),
    ((45, 51), dict(size=(18, 20), scale=0.4)),
    ((13, 11), dict(scale=2.5)),
    ((17, 9), dict(size=(40, 21), scale=7 / 3)),
    ((30, 30), dict(scale=1 / 3, antialiasing=False))])
def test_imresize_matches_jax(monkeypatch, native, hw, kw):
    monkeypatch.setenv("CIAOSR_NATIVE", native)
    img = np.random.default_rng(hw[0]).random((*hw, 3), dtype=np.float32)
    got = imresize_np(img, **kw)
    ref = jax_imresize(img, **kw)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(imresize_np(img[..., 0], **kw),
                               jax_imresize(img[..., 0], **kw), atol=1e-5,
                               rtol=0)


def _same(a, b, path=""):
    """Bit-equal nested results (arrays, dicts, tuples, scalars)."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, np.random.Generator):
        pass
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("set")
    write_folder(root, [(48, 40), (50, 37), (36, 36)], seed=2)
    return root


def _ops(results_in, ops_cfg, seed):
    """The ops through the port's Compose and JAX's, each drawing from a
    generator seeded with ``seed``."""
    return [pl.Compose(ops_cfg)(dict(results_in,
                                     _rng=np.random.default_rng(seed)))
            for pl in (port_pl, jax_pl)]


@pytest.mark.parametrize("ops", [
    [dict(type="LoadImageFromFile", key="gt")],
    [dict(type="LoadImageFromFile", key="gt", channel_order="bgr")],
    [dict(type="LoadImageFromFile", key="gt"),
     dict(type="RescaleToZeroOne", keys=["gt"]),
     dict(type="ImageToTensor", keys=["gt"])],
    [dict(type="LoadImageFromFile", key="gt"),
     dict(type="RandomDownSampling", scale_min=4, scale_max=4),
     dict(type="RescaleToZeroOne", keys=["lq", "gt"])],
    [dict(type="LoadImageFromFile", key="gt"),
     dict(type="RescaleToZeroOne", keys=["gt"]),
     dict(type="RandomDownSampling", scale_min=1, scale_max=4,
          patch_size=8)],
    [dict(type="LoadImageFromFile", key="gt"),
     dict(type="RescaleToZeroOne", keys=["gt"]),
     dict(type="RandomDownSampling", scale_min=3, scale_max=3),
     dict(type="GenerateCoordinateAndCell", scale=3),
     dict(type="Collect", keys=["lq", "gt", "coord", "cell"],
          meta_keys=["gt_path"])],
    [dict(type="LoadImageFromFile", key="gt"),
     dict(type="RescaleToZeroOne", keys=["gt"]),
     dict(type="GenerateCoordinateAndCell", sample_quantity=50)],
    [dict(type="LoadImageFromFile", key="gt"),
     dict(type="RescaleToZeroOne", keys=["gt"]),
     dict(type="GenerateCoordinateAndCell", sample_quantity=50,
          is_shuffle=False)],
    [dict(type="LoadImageFromFile", key="lq"),
     dict(type="RescaleToZeroOne", keys=["lq"]),
     dict(type="GenerateCoordinateAndCell", scale=2.5)],
    [dict(type="LoadImageFromFile", key="lq"),
     dict(type="GenerateCoordinateAndCell", target_size=(30, 21))]],
    ids=["load", "load_bgr", "rescale_totensor", "downsample_eval",
         "downsample_patch", "coords_eval", "coords_shuffle", "coords_run",
         "coords_scale", "coords_target"])
def test_pipeline_ops_match_jax(folder, ops):
    """Each op on the same file and seed: bit-equal to JAX's."""
    res = {"gt_path": str(folder / "gt" / "im1.png"),
           "lq_path": str(folder / "lq" / "im1.png")}
    port, ref = _ops(res, ops, seed=9)
    _same(port, ref)


def test_ops_without_a_generator_raise():
    op = port_pl.RandomDownSampling(scale_min=1, scale_max=4)
    with pytest.raises(KeyError, match="_rng"):
        op({"gt": np.zeros((16, 16, 3), np.float32)})
    with pytest.raises(ValueError, match="'matlab', 'pillow' or 'cv2'"):
        port_pl.RandomDownSampling(backend="area")
    for backend in ("pillow", "cv2"):
        op = port_pl.RandomDownSampling(scale_min=1, scale_max=4,
                                        backend=backend)
        with pytest.raises(KeyError, match="_rng"):
            op({"gt": np.zeros((16, 16, 3), np.float32)})


@pytest.mark.parametrize("name", sorted(CONFIGS_001))
@pytest.mark.parametrize("split", ["test", "val"])
def test_config_datasets_match_jax(folder, name, split):
    """The 001 configs' test (paired folders) and val (gt only, LQ made by
    MATLAB bicubic) datasets on the same folder: the same order and the
    same samples, bit for bit."""
    cfg = Config.fromfile(CONFIGS_001[name]).data[split]
    cfg = dict(cfg, gt_folder=str(folder / "gt"))
    if split == "test":
        cfg["lq_folder"] = str(folder / "lq")
    port, ref = port_ds.build_dataset(cfg), jax_ds.build_dataset(cfg)
    assert len(port) == len(ref) == 3
    for i in range(3):
        _same(port[i], ref[i])
    assert [port[i]["meta"]["gt_path"] for i in range(3)] == \
        sorted(str(p) for p in (folder / "gt").iterdir())


def test_seeded_gt_dataset_and_repeat_match_jax(folder):
    """A seeded SRFolderGTDataset draws sample i from (seed, i), as JAX's
    does; RepeatDataset cycles it."""
    pipeline = [dict(type="LoadImageFromFile", key="gt"),
                dict(type="RescaleToZeroOne", keys=["gt"]),
                dict(type="RandomDownSampling", scale_min=1, scale_max=4,
                     patch_size=8),
                dict(type="GenerateCoordinateAndCell", sample_quantity=32),
                dict(type="Collect", keys=["lq", "gt", "coord", "cell"],
                     meta_keys=["gt_path"])]
    cfg = dict(type="RepeatDataset", times=2,
               dataset=dict(type="SRFolderGTDataset", seed=5, scale=4,
                            gt_folder=str(folder / "gt"), pipeline=pipeline))
    port, ref = port_ds.build_dataset(cfg), jax_ds.build_dataset(cfg)
    assert len(port) == len(ref) == 6
    for i in (0, 4):
        _same(port[i], ref[i])
    _same(port[1], port[4])


def test_paired_dataset_stems(tmp_path):
    """filename_tmpl maps each gt stem to its lq file; a missing one
    raises, in both packages."""
    for d, names in (("gt", ["b", "a"]), ("lq", ["a_x4", "b_x4", "c_x4"])):
        (tmp_path / d).mkdir()
        for n in names:
            write_png(str(tmp_path / d / f"{n}.png"), _image(3, hw=(4, 4)))
    kw = dict(lq_folder=str(tmp_path / "lq"), gt_folder=str(tmp_path / "gt"),
              pipeline=[], filename_tmpl="{}_x4")
    port, ref = port_ds.SRFolderDataset(**kw), jax_ds.SRFolderDataset(**kw)
    assert port.pairs == ref.pairs and port.pairs[0][0].endswith("a_x4.png")
    kw["filename_tmpl"] = "{}_x3"
    for ds in (port_ds, jax_ds):
        with pytest.raises(FileNotFoundError, match="_x3"):
            ds.SRFolderDataset(**kw)


@pytest.mark.parametrize("convert_to,crop", [(None, 0), ("y", 4)])
def test_ssim_without_opencv_matches_jax(monkeypatch, convert_to, crop):
    """The card's machine has no OpenCV: the port's SSIM filters with
    core/filters.py everywhere, and must give JAX's (OpenCV) SSIM."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)
    b = np.clip(a + rng.integers(-20, 21, a.shape), 0, 255).astype(np.uint8)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = port_metrics.ssim(a, b, crop_border=crop, convert_to=convert_to)
    ref = jax_metrics.ssim(a, b, crop_border=crop, convert_to=convert_to)
    assert abs(got - ref) <= 1e-9, (got, ref)
