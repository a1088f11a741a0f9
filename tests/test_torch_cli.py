"""The port's CLIs against the JAX package's: ``ciaosr_torch.tools.test
--device cpu`` and JAX's ``tools/test.py`` on one small config, one
three-image folder and one ``.pth`` give the same PSNR and SSIM; 'None'
and 'random' resolve as in JAX; ``ciaosr_torch.tools.inference`` writes
the image its restorer gives.

The tier-1 config has no CSA (``non_local_attn=False``), so that JAX's
grid decode runs no interpret-mode Pallas kernel; the case with CSA is
marked slow.
"""

import importlib.util
import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import tests.test_torch_weights  # noqa: F401  (caps torch's CPU threads)
from chip_smoke import smooth_picture
from ciaosr_torch.config import Config
from ciaosr_torch.core.color import tensor2img
from ciaosr_torch.core.resize import imresize_np
from ciaosr_torch.data.datasets import build_dataset
from ciaosr_torch.data.imageio import read_png, write_png
from ciaosr_torch.models.builder import build_generator, build_model
from ciaosr_torch.tools import inference as port_inference
from ciaosr_torch.tools import test as port_test

ROOT = tests.test_torch_weights.ROOT

CONFIG = textwrap.dedent("""\
    model = dict(
        type='CiaoSR',
        generator=dict(
            type='LocalImplicitSREDSR',
            encoder=dict(type='EDSR', in_channels=3, out_channels=3,
                         mid_channels=8, num_blocks=1),
            imnet_q=dict(type='MLPRefiner', out_dim=3, hidden_list=[16]),
            imnet_k=dict(type='MLPRefiner', out_dim=8, hidden_list=[16]),
            imnet_v=dict(type='MLPRefiner', out_dim=8, hidden_list=[16]),
            feat_unfold=True, non_local_attn={nla}, eval_bsize=4096),
        rgb_mean=(0.4488, 0.4371, 0.4040), rgb_std=(1., 1., 1.),
        pixel_loss=dict(type='L1Loss', loss_weight=1.0, reduction='mean'))
    train_cfg = None
    test_cfg = dict(metrics=['PSNR', 'SSIM'], crop_border=4, scale=4,
                    tile=16, tile_overlap=4, convert_to='y')
    test_pipeline = [
        dict(type='LoadImageFromFile', io_backend='disk', key='gt',
             flag='color', channel_order='rgb'),
        dict(type='LoadImageFromFile', io_backend='disk', key='lq',
             flag='color', channel_order='rgb'),
        dict(type='RescaleToZeroOne', keys=['lq', 'gt']),
        dict(type='ImageToTensor', keys=['lq', 'gt']),
        dict(type='GenerateCoordinateAndCell', scale=4),
        dict(type='Collect', keys=['lq', 'gt', 'coord', 'cell'],
             meta_keys=['gt_path'])]
    data = dict(
        test=dict(type='SRFolderDataset', lq_folder='{root}/lq',
                  gt_folder='{root}/gt', pipeline=test_pipeline, scale=4,
                  filename_tmpl='{{}}'))
    test_checkpoint_path = '{root}/gen.pth'
""")


def write_folder(root, shapes, seed=0):
    """gt/ and lq/ folders of smooth images; each LR is the MATLAB-bicubic
    ×1/4 of its GT, rounded to uint8."""
    rng = np.random.default_rng(seed)
    (root / "gt").mkdir()
    (root / "lq").mkdir()
    for i, (h, w) in enumerate(shapes):
        gt = smooth_picture(rng, h, w)
        lq = imresize_np(gt.astype(np.float32) / 255.0, scale=0.25)
        lq = np.clip(np.round(lq * 255), 0, 255).astype(np.uint8)
        write_png(str(root / "gt" / f"im{i}.png"), gt)
        write_png(str(root / "lq" / f"im{i}.png"), lq)


def make_case(root, nla: bool):
    write_folder(root, [(96, 80)] * 3)
    cfg_path = root / "cfg.py"
    cfg_path.write_text(CONFIG.format(nla=nla, root=str(root)))
    gen = build_generator(Config.fromfile(str(cfg_path)).model["generator"],
                          device="cpu", seed=1)
    torch.save({"meta": {"note": "seeded"},
                "state_dict": {f"generator.{k}": v
                               for k, v in gen.state_dict().items()}},
               str(root / "gen.pth"))
    return str(cfg_path), str(root / "gen.pth")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return make_case(tmp_path_factory.mktemp("cli"), nla=False)


def jax_test_main(monkeypatch, argv):
    """JAX's tools/test.py ``main`` in this process (no compilation cache
    on disk); returns the metrics it writes with ``--out``."""
    monkeypatch.setenv("CIAOSR_COMPILATION_CACHE", "0")
    spec = importlib.util.spec_from_file_location("jax_tools_test",
                                                  ROOT / "tools" / "test.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr("sys.argv", ["tools/test.py"] + argv)
    mod.main()
    out = argv[argv.index("--out") + 1]
    with open(out) as f:
        return json.load(f)


def check_same_metrics(monkeypatch, tmp_path, cfg, ckpt):
    port = port_test.main([cfg, ckpt, "--device", "cpu", "--out",
                           str(tmp_path / "port.json")])
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == port
    ref = jax_test_main(monkeypatch, [cfg, ckpt, "--out",
                                      str(tmp_path / "jax.json")])
    assert port["n_images"] == ref["n_images"] == 3
    assert np.isfinite(port["PSNR"]) and np.isfinite(port["SSIM"])
    assert abs(port["PSNR"] - ref["PSNR"]) <= 1e-4, (port, ref)
    assert abs(port["SSIM"] - ref["SSIM"]) <= 1e-6, (port, ref)


def test_cli_metrics_match_jax(case, monkeypatch, tmp_path):
    check_same_metrics(monkeypatch, tmp_path, *case)


@pytest.mark.slow
def test_cli_metrics_match_jax_with_csa(tmp_path_factory, monkeypatch,
                                        tmp_path):
    cfg, ckpt = make_case(tmp_path_factory.mktemp("cli_csa"), nla=True)
    check_same_metrics(monkeypatch, tmp_path, cfg, ckpt)


def test_cli_checkpoint_resolution(case, tmp_path):
    """'None' reads the config's test_checkpoint_path; 'random' keeps the
    seeded weights of build_model; a directory (JAX's orbax format)
    raises; --shard-tiles in one process changes nothing."""
    cfg, ckpt = case
    by_path = port_test.main([cfg, ckpt, "--device", "cpu"])
    by_none = port_test.main([cfg, "None", "--device", "cpu"])
    assert {k: by_none[k] for k in ("PSNR", "SSIM")} == \
        {k: by_path[k] for k in ("PSNR", "SSIM")}
    rand = port_test.main([cfg, "random", "--device", "cpu", "--seed", "3",
                           "--save-path", str(tmp_path / "sr")])
    assert rand["PSNR"] != by_path["PSNR"]
    # 'random' is build_model's seeded generator
    c = Config.fromfile(cfg)
    model = build_model(c.model, test_cfg=c.test_cfg, device="cpu", seed=3)
    saved = read_png(str(tmp_path / "sr" / "im0.png"))
    sample = build_dataset(c.data["test"])[0]
    want = tensor2img(model.forward_test(sample["lq"], scale=4), bgr=False)
    np.testing.assert_array_equal(saved, want)
    with pytest.raises(ValueError, match="orbax"):
        port_test.main([cfg, str(tmp_path), "--device", "cpu"])
    sharded = port_test.main([cfg, ckpt, "--device", "cpu", "--shard-tiles"])
    assert {k: sharded[k] for k in ("PSNR", "SSIM", "n_images")} == \
        {k: by_path[k] for k in ("PSNR", "SSIM", "n_images")}


def test_inference_writes_expected_image(case, tmp_path):
    """One image at ×4 (tiled: wider than --tile) and at ×2.5 (a
    full-image predict): the PNG has the target size and holds the
    restorer's output, rounded as the JAX CLI rounds it."""
    cfg, ckpt = case
    c = Config.fromfile(cfg)
    model = build_model(c.model, test_cfg=c.test_cfg, device="cpu")
    port_test.load_weights(model, ckpt, c)
    src = str(tmp_path / "lq_im0.png")
    lr = read_png(c.data["test"]["lq_folder"] + "/im0.png")
    write_png(src, lr)
    lq = lr.astype(np.float32) / 255.0
    for scale, extra, want in (
            ("4", ["--tile", "16", "--tile-overlap", "4"],
             model.predict_tiled(lq, 4, 16, 4)),
            ("2.5", [], model.predict(lq, (60, 50)))):
        out = str(tmp_path / f"sr_x{scale}.png")
        written = port_inference.main([cfg, ckpt, "--img", src, "--scale",
                                       scale, "--out", out, "--device",
                                       "cpu"] + extra)
        assert written == [out]
        got = read_png(out)
        assert got.shape == (round(24 * float(scale)),
                             round(20 * float(scale)), 3)
        np.testing.assert_array_equal(
            got, np.clip(want * 255.0 + 0.5, 0, 255).astype(np.uint8))
    # the default name, next to the input
    port_inference.main([cfg, ckpt, "--img", src, "--device", "cpu"])
    assert read_png(src[:-4] + "_x4.png").shape == (96, 80, 3)


def test_entry_points_import_no_jax():
    """The CLIs and everything they import leave JAX and the JAX package
    out (the card's machine has neither)."""
    code = ("import sys, ciaosr_torch.tools.test, "
            "ciaosr_torch.tools.inference, ciaosr_torch.models.restorers\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'ciaosr_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
