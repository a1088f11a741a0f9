"""The port's training data layer against the JAX package's, on seeded
folders: every training pipeline op and the 001 configs' train pipelines
bit-equal to JAX's given the same ``_rng``; the loader's batches for a
seed bit-equal to JAX's ``DataLoader(worker_mode="process")`` (order and
content), in thread and in process mode; a worker's error raises in the
consumer and closing the loader joins its threads.

JAX resizes with its numpy MATLAB bicubic (``CIAOSR_NATIVE=0``), as
``tests/test_torch_data.py::test_pipeline_ops_match_jax`` runs it. No
pytest-timeout plugin is installed: each loader test bounds its own wait
(``bounded``).
"""

import threading

import numpy as np
import pytest

import tests.test_torch_weights  # noqa: F401  (caps torch's CPU threads)
from chip_smoke import smooth_picture
from ciaosr_torch.config import Config
from ciaosr_torch.data import datasets as port_ds
from ciaosr_torch.data import loader as port_loader
from ciaosr_torch.data import pipelines as port_pl
from ciaosr_torch.data.imageio import write_png
from ciaosr_tpu.data import datasets as jax_ds
from ciaosr_tpu.data import loader as jax_loader
from ciaosr_tpu.data import pipelines as jax_pl
from tests.test_torch_config import CONFIGS_001
from tests.test_torch_data import _same

# a wait no loader test should come near (seconds)
WAIT = 60.0


@pytest.fixture(autouse=True)
def numpy_bicubic(monkeypatch):
    """JAX's numpy MATLAB bicubic (its C++ one differs by up to 1e-5);
    forked workers inherit the environment."""
    monkeypatch.setenv("CIAOSR_NATIVE", "0")


@pytest.fixture(scope="module")
def hr_folder(tmp_path_factory):
    """Four seeded smooth GT pictures, each large enough for a ×4 patch of
    48 (192²) as the 001 train pipelines crop."""
    root = tmp_path_factory.mktemp("hr")
    rng = np.random.default_rng(11)
    for i, hw in enumerate([(200, 196), (192, 210), (204, 192),
                            (196, 200)]):
        write_png(str(root / f"im{i}.png"), smooth_picture(rng, *hw))
    return root


def bounded(fn, secs: float = WAIT):
    """fn() in a daemon thread: its result, its exception re-raised, or a
    failure if it has not returned within ``secs``."""
    out: dict = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(secs)
    assert not t.is_alive(), f"no result within {secs} s: a hang"
    if "error" in out:
        raise out["error"]
    return out["value"]


LOAD = dict(type="LoadImageFromFile", key="gt")
SCALE01 = dict(type="RescaleToZeroOne", keys=["gt"])
# gt at ×2 of an lq made by the eval downsampling (pairs for the crops)
PAIRED = [LOAD, SCALE01, dict(type="RandomDownSampling", scale_min=2,
                              scale_max=2)]
# a ×2.5 pair of 190 × 180 and 76 × 72 (a float scale for the continuous
# crops)
PAIRED_25 = [LOAD, SCALE01, dict(type="Crop", keys=["gt"],
                                 crop_size=(190, 180), random_crop=False),
             dict(type="RandomDownSampling", scale_min=2.5, scale_max=2.5)]
OP_CASES = {
    "flip_h": [LOAD, SCALE01, dict(type="RandomDownSampling", scale_min=1,
                                   scale_max=4, patch_size=12),
               dict(type="Flip", keys=["lq", "gt"], flip_ratio=0.5)],
    "flip_v": [LOAD, dict(type="Flip", keys=["gt"], flip_ratio=0.5,
                          direction="vertical")],
    "transpose": [LOAD, SCALE01, dict(type="RandomDownSampling", scale_min=1,
                                      scale_max=4, patch_size=12),
                  dict(type="RandomTransposeHW", keys=["lq", "gt"])],
    "bicubic_sampling": [LOAD, SCALE01, dict(type="RandomBicubicSampling",
                                             scale_min=1, scale_max=4,
                                             patch_size=16)],
    "bicubic_sampling_eval": [LOAD, SCALE01, dict(
        type="RandomBicubicSampling", scale_min=3, scale_max=3)],
    "coords1": [LOAD, SCALE01, dict(type="CopyValues", src_keys=["gt"],
                                    dst_keys=["gt_unsharp"]),
                dict(type="GenerateCoordinateAndCell1", sample_quantity=40)],
    "coords2": [LOAD, SCALE01, dict(type="GenerateCoordinateAndCell2",
                                    sample_quantity=40, scale=2, scale1=2)],
    "coords2_rescaled": [LOAD, SCALE01, dict(type="GenerateCoordinateAndCell2",
                                             scale=3, scale1=2)],
    "coords2_no_gt": [dict(type="LoadImageFromFile", key="lq"), dict(
        type="GenerateCoordinateAndCell2", target_size=(3, 30, 21))],
    "random_crop": [LOAD, dict(type="RandomCrop", patch_size=17)],
    "random_crop_pair": PAIRED + [dict(type="RandomCrop", patch_size=9,
                                       keys=["lq", "gt"])],
    "continuous_crop": PAIRED_25 + [dict(type="ContinuousPairedRandomCrop",
                                         lq_patch_size=10)],
    "crop": [LOAD, dict(type="Crop", keys=["gt"], crop_size=(13, 21))],
    "crop_centre": [LOAD, dict(type="Crop", keys=["gt"], crop_size=(13, 21),
                               random_crop=False)],
    "modcrop": [LOAD, SCALE01, dict(type="RandomDownSampling", scale_min=3,
                                    scale_max=3), dict(type="ModCrop")],
    "paired_crop": PAIRED + [dict(type="PairedRandomCrop", gt_patch_size=16)],
    "paired_crop_wscale": PAIRED_25 + [dict(type="PairedRandomCropwScale",
                                            lq_patch_size=10)],
    "copy_values": [LOAD, dict(type="CopyValues", src_keys=["gt", "gt_path"],
                               dst_keys=["x", "y"])],
    "quantize": [LOAD, SCALE01, dict(type="RandomDownSampling", scale_min=3,
                                     scale_max=3),
                 dict(type="Quantize", keys=["lq", "gt"])],
}
OP_CASES.update({f"train_pipeline_001_{name}": Config.fromfile(
    path).data["train"]["dataset"]["pipeline"]
    for name, path in sorted(CONFIGS_001.items())})


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_train_ops_match_jax(hr_folder, case, seed):
    """Each op (and each 001 train pipeline, whole) on the same file and
    the same generator: bit-equal to JAX's, every key and every draw."""
    path = str(hr_folder / f"im{seed}.png")
    got, ref = (pl.Compose(OP_CASES[case])(
        {"gt_path": path, "lq_path": path,
         "_rng": np.random.default_rng(seed)})
        for pl in (port_pl, jax_pl))
    _same(got, ref)


def test_ops_refuse_what_jax_refuses():
    """The same errors as the JAX ops: a bad flip direction, a gt / lq pair
    whose scales differ in H and W, an lq smaller than the patch."""
    with pytest.raises(ValueError):
        port_pl.Flip(keys=["gt"], direction="diagonal")
    op = port_pl.PairedRandomCropwScale(lq_patch_size=4)
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="Scale mismatches"):
        op({"lq": np.zeros((8, 8, 3)), "gt": np.zeros((16, 24, 3)),
            "_rng": rng})
    with pytest.raises(ValueError, match="smaller than patch"):
        op({"lq": np.zeros((3, 3, 3)), "gt": np.zeros((6, 6, 3)),
            "_rng": rng})


# ------------------------------------------------------------------ loader --
def train_dataset_cfg(hr_folder, name="rdn", seed=None):
    """A 001 config's train dataset (RepeatDataset of SRFolderGTDataset,
    its own pipeline: ×1-4 MATLAB bicubic, flips, transpose, 2304 queries)
    on the seeded folder."""
    cfg = Config.fromfile(CONFIGS_001[name]).data["train"]
    inner = dict(cfg["dataset"], gt_folder=str(hr_folder))
    if seed is not None:
        inner["seed"] = seed
    return dict(cfg, times=2, dataset=inner)


def take(loader, n):
    """The first n batches of a loader, closing its iterator."""
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


@pytest.mark.parametrize("seed", [None, 5], ids=["unseeded", "seeded"])
def test_loader_batches_match_jax_process_mode(hr_folder, seed):
    """Three batches of 3 (the index stream wraps the epoch of 8): the
    port's thread and process modes both equal JAX's process mode, bit
    for bit, and the batches differ from each other. A dataset seed keeps
    its per-sample generators (sample i of batch j is dataset[i])."""
    cfg = train_dataset_cfg(hr_folder, seed=seed)
    kw = dict(batch_size=3, num_workers=2, seed=7)
    ref = bounded(lambda: take(jax_loader.DataLoader(
        jax_ds.build_dataset(cfg), worker_mode="process", **kw), 3))
    ds = port_ds.build_dataset(cfg)
    for mode in ("thread", "process"):
        got = bounded(lambda: take(port_loader.DataLoader(
            ds, worker_mode=mode, **kw), 3))
        assert len(got) == 3
        for g, r in zip(got, ref):
            _same(g, r)
    assert got[0]["lq"].shape == (3, 48, 48, 3)
    assert got[0]["gt"].shape == (3, 2304, 3)
    assert not np.array_equal(got[0]["lq"], got[1]["lq"])
    if seed is not None:
        idx = np.random.default_rng(7).permutation(len(ds))[:3]
        for j, i in enumerate(idx):
            np.testing.assert_array_equal(got[0]["lq"][j], ds[int(i)]["lq"])


class Numbers:
    """Sample i: [i] and a draw of its generator; sample ``fail_at``
    raises."""

    def __init__(self, n=16, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.load(i)

    def load(self, i, rng=None):
        if i == self.fail_at:
            raise ValueError(f"broken sample {i}")
        draw = rng.random() if rng is not None else -1.0
        return {"x": np.array([i, draw]), "meta": {"idx": i}}


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_loader_single_pass_and_generators(mode):
    """A single pass without drop_last covers the dataset once; batch seq
    draws from default_rng((seed, seq)) in sample order."""
    loader = port_loader.DataLoader(Numbers(10), batch_size=4, num_workers=3,
                                    seed=2, infinite=False, drop_last=False,
                                    worker_mode=mode)
    batches = bounded(lambda: list(loader))
    assert [len(b["meta"]) for b in batches] == [4, 4, 2]
    seen = np.concatenate([b["x"][:, 0] for b in batches]).astype(int)
    assert sorted(seen.tolist()) == list(range(10))
    for seq, b in enumerate(batches):
        want = np.random.default_rng((2, seq)).random(len(b["meta"]))
        np.testing.assert_array_equal(b["x"][:, 1], want)


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_loader_worker_error_raises(mode):
    """A failing sample reaches the consumer as RuntimeError (its cause
    the sample's error) within the bound, in both modes."""
    loader = port_loader.DataLoader(Numbers(16, fail_at=5), batch_size=4,
                                    num_workers=2, shuffle=False,
                                    infinite=False, worker_mode=mode)
    with pytest.raises(RuntimeError, match="worker failed") as ei:
        bounded(lambda: list(loader))
    assert isinstance(ei.value.__cause__, ValueError)


def test_loader_close_joins_threads():
    """Closing an infinite thread-mode iterator joins its feeder and its
    workers before close() returns."""
    def loader_threads():
        return [t for t in threading.enumerate()
                if t.name.startswith("loader-") and t.is_alive()]

    assert not loader_threads()
    loader = port_loader.DataLoader(Numbers(64), batch_size=4, num_workers=4,
                                    prefetch=2)
    it = iter(loader)
    bounded(lambda: next(it))
    assert len(loader_threads()) == 5
    bounded(it.close)
    assert not loader_threads()
