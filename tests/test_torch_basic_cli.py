"""The fixed-scale ``BasicRestorer`` through the port's entry points on the
CPU, on ``chip_smoke.py``'s phase-"basic" configs and folders with the
nets cut to test widths (mid 8, 2 blocks; RDN 2 layers, growth 4):

* both configs read by the port's ``Config.fromfile`` as JAX's reads
  them, and built by both packages' ``build_model``;
* ``tools.test`` with random weights (the metrics of the same restorer
  evaluated in process; ``--out``), ``tools.inference`` with ``--tile 0``
  and an image inside the tile (the PNG at the net's scale), and the
  ValueError naming ``--tile 0`` for a larger one;
* ``tools.train`` (2 iterations), then ``tools.test`` on the run's
  work_dir, on 'None' and on its newest file: the trained restorer's
  metrics; the checkpoint loads strictly, while a reference-layout
  ``.pth`` of the same tensors raises.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from ciaosr_torch.config import Config
from ciaosr_torch.convert.load import load_torch_checkpoint
from ciaosr_torch.data.datasets import build_dataset
from ciaosr_torch.data.imageio import imread
from ciaosr_torch.eval.evaluator import evaluate_dataset
from ciaosr_torch.models.builder import build_model
from ciaosr_torch.models.restorers import BasicRestorer
from ciaosr_torch.tools import inference as port_inference
from ciaosr_torch.tools import test as port_test
from ciaosr_torch.tools import train as port_train
from ciaosr_torch.train.checkpoint import list_steps
from ciaosr_tpu.config.config import Config as JaxConfig
from ciaosr_tpu.models.builder import build_model as jax_build_model
import ciaosr_tpu.models.restorers  # noqa: F401  (registers the models)

SMALL_NETS = {
    "rdn": (dict(type="RDNNet", in_channels=3, out_channels=3,
                 mid_channels=8, num_blocks=2, num_layers=2,
                 channel_growth=4, upscale_factor=4), 4, 1),
    "edsr": (dict(type="EDSRNet", in_channels=3, out_channels=3,
                  mid_channels=8, num_blocks=2, upscale_factor=3,
                  res_scale=1.0), 3, 8)}


def write_basic(root) -> dict:
    """phase basic's folders and configs under ``root`` with SMALL_NETS,
    small pictures and 2 iterations of batch 2 (data paths relative to
    ``root``): {name: config path}."""
    mp = pytest.MonkeyPatch()
    mp.setattr(chip_smoke, "BASIC_NETS", SMALL_NETS)
    mp.setattr(chip_smoke, "BASIC_SET5", (("baby", (36, 48)),
                                          ("woman", (24, 36))))
    mp.setattr(chip_smoke, "BASIC_HR", ((48, 48), (36, 60)))
    mp.setattr(chip_smoke, "BASIC_TRAIN", dict(batch=2, patch=24, iters=2,
                                               interval=1))
    try:
        chip_smoke.write_basic_data(root)
        return {name: chip_smoke.write_basic_config(root, name, workers=2)
                for name in SMALL_NETS}
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def basic_root(tmp_path_factory):
    """(root, {name: config path}) of ``write_basic`` in a temporary
    directory."""
    root = tmp_path_factory.mktemp("basic")
    return root, write_basic(root)


@pytest.mark.parametrize("name", sorted(SMALL_NETS))
def test_basic_config_reads_and_builds_as_in_jax(basic_root, name):
    _, paths = basic_root
    port, ref = Config.fromfile(paths[name]), JaxConfig.fromfile(paths[name])
    assert sorted(port.keys()) == sorted(ref.keys())
    assert port.model.generator.type == ref.model.generator.type
    assert port.test_cfg["window_size"] == ref.test_cfg["window_size"] == \
        SMALL_NETS[name][2]
    res = build_model(port.model, test_cfg=port.test_cfg, device="cpu")
    jax_res = jax_build_model(ref.model, test_cfg=ref.test_cfg)
    assert isinstance(res, BasicRestorer)
    assert type(jax_res).__name__ == "BasicRestorer"
    assert res.generator.upscale_factor == \
        jax_res.generator.upscale_factor == SMALL_NETS[name][1]


@pytest.mark.parametrize("name", sorted(SMALL_NETS))
def test_tools_test_and_inference(basic_root, monkeypatch, tmp_path, name):
    root, paths = basic_root
    monkeypatch.chdir(root)
    path = paths[name]
    out = tmp_path / "m.json"
    got = port_test.main([path, "random", "--device", "cpu", "--out",
                          str(out)])
    cfg = Config.fromfile(path)
    want = evaluate_dataset(build_model(cfg.model, test_cfg=cfg.test_cfg,
                                        device="cpu"),
                            build_dataset(cfg.data["test"]))
    assert {k: got[k] for k in ("PSNR", "SSIM")} == \
        {k: want[k] for k in ("PSNR", "SSIM")}
    assert all(np.isfinite(got[k]) for k in ("PSNR", "SSIM"))
    assert json.loads(out.read_text())["n_images"] == 2

    scale = SMALL_NETS[name][1]
    src = f"data/Set5/LRbicx{scale}/woman.png"
    h, w = imread(src).shape[:2]
    for tile in (["--tile", "0"], []):      # untiled; inside the tile
        (png,) = port_inference.main(
            [path, "random", "--img", src, "--scale", str(scale), "--out",
             str(tmp_path / "sr.png"), "--device", "cpu"] + tile)
        assert imread(png).shape == (h * scale, w * scale, 3)
    with pytest.raises(ValueError, match="--tile 0"):
        port_inference.main([path, "random", "--img", src, "--scale",
                             str(scale), "--tile", "4", "--device", "cpu"])


def test_tools_train_then_test(basic_root, monkeypatch, tmp_path):
    root, paths = basic_root
    monkeypatch.chdir(root)
    path = paths["rdn"]
    work = tmp_path / "work"
    trainer = port_train.main([path, "--device", "cpu", "--work-dir",
                               str(work), "--deterministic"])
    assert trainer.state.step == 2
    assert list_steps(str(work / "checkpoints")) == [1, 2]
    before = build_model(Config.fromfile(path).model,
                         device="cpu").generator.state_dict()
    after = trainer.restorer.generator.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in before)

    cfg = Config.fromfile(path)
    cfg_path = tmp_path / "basic_rdn_none.py"
    cfg_path.write_text(open(path).read() + f"\ntest_checkpoint_path = "
                        f"{str(work / 'latest')!r}\n")
    want = evaluate_dataset(trainer.restorer,
                            build_dataset(cfg.data["test"]))
    newest = str(work / "checkpoints" / "iter_2.pth")
    for cfg_file, ckpt in ((path, str(work)), (str(cfg_path), "None"),
                           (path, newest)):
        got = port_test.main([cfg_file, ckpt, "--device", "cpu"])
        assert {k: got[k] for k in ("PSNR", "SSIM")} == \
            {k: want[k] for k in ("PSNR", "SSIM")}, ckpt

    sd = load_torch_checkpoint(newest, cfg.model, strict=True)
    fresh = build_model(cfg.model, device="cpu", seed=5)
    fresh.generator.load_state_dict(sd, strict=True)
    lq = build_dataset(cfg.data["test"])[0]["lq"]
    np.testing.assert_array_equal(fresh.predict(lq),
                                  trainer.restorer.predict(lq))

    # the same tensors as a reference (mmcv) .pth: no converter, as in JAX
    ref_pth = tmp_path / "reference.pth"
    raw = torch.load(newest, weights_only=False)
    torch.save({"meta": {"iter": 2}, "state_dict": raw["state_dict"]},
               str(ref_pth))
    with pytest.raises(KeyError, match="not loadable"):
        load_torch_checkpoint(str(ref_pth), cfg.model)
    with pytest.raises(KeyError, match="not loadable"):
        port_test.main([path, str(ref_pth), "--device", "cpu"])
