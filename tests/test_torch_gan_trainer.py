"""The port's GAN training loop, its checkpoints, the staged ``load_from``
and the entry points on ``RealCiaoSR`` configs, f32 on the CPU.

* ``GANTrainer`` on a small SwinIR-CiaoSR GAN (UNet-SN discriminator of 8
  channels, synthetic VGG19 perceptual, vanilla GAN) with an in-memory
  loader: the checkpoints' keys (``generator.``, ``generator_ema.``,
  ``discriminator.`` with the spectral norms' ``u`` and ``sigma``; both
  optimizers and schedules), strict loading of the EMA copy through
  ``load_torch_checkpoint(..., ema=True)``, pruning to ``max_to_keep``,
  and a run resumed at 2 bit-equal at 4 to one that was not interrupted.
* ``load_staged_generator`` from a port GAN checkpoint, a port classical
  one and a reference-layout ``.pth``, each path form ``resolve_checkpoint``
  takes; ``GANTrainer`` seeds the generator and its EMA copy from
  ``load_from``.
* ``build_model`` on both shipped 002 ``model`` dicts on the CPU: the
  generator's and discriminator's parameters shaped as the JAX package's
  ``build_model`` builds them, the losses and ``train_cfg`` the same.
* ``tools.train`` on RealCiaoSR config copies whose data use ported ops:
  stage 1 (wogan), then stage 2 (GAN) loading stage 1; ``--autoscale-lr``
  refuses per-module optimizers. ``tools.test`` evaluates the EMA copy.
  The shipped 002 train pipelines raise, naming the degradation item.
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_weights as tw
from chip_smoke import smooth_picture
from ciaosr_torch.config import Config
from ciaosr_torch.convert.from_jax import discriminator_state_dict_from_jax
from ciaosr_torch.convert.load import load_torch_checkpoint
from ciaosr_torch.core.coords import make_coord_cell
from ciaosr_torch.data.datasets import build_dataset
from ciaosr_torch.data.imageio import write_png
from ciaosr_torch.eval.evaluator import evaluate_dataset
from ciaosr_torch.models.builder import build_model
from ciaosr_torch.models.real_restorer import RealCiaoSRRestorer
from ciaosr_torch.models.restorers import CiaoSRRestorer
from ciaosr_torch.tools import test as port_test
from ciaosr_torch.tools import train as port_train
from ciaosr_torch.train import checkpoint as port_ckpt
from ciaosr_torch.train.gan_trainer import GANTrainer
from ciaosr_torch.train.trainer import Trainer
from ciaosr_tpu.config.config import Config as JaxConfig
from ciaosr_tpu.convert.torch_weights import convert_generator
from ciaosr_tpu.models.builder import build_model as jax_build_model
import ciaosr_tpu.models.real_restorer  # noqa: F401  (registers RealCiaoSR)

ADAM = dict(type="Adam", lr=1e-4, betas=(0.9, 0.99))
GAN_MODEL = dict(
    type="RealCiaoSR", generator=tw.SWIN_SMALL,
    discriminator=dict(type="UNetDiscriminatorWithSpectralNorm",
                       mid_channels=8),
    pixel_loss=dict(type="L1Loss", loss_weight=1.0),
    perceptual_loss=dict(type="PerceptualLoss", layer_weights={"2": 0.1},
                         perceptual_weight=1.0, style_weight=0,
                         norm_img=False, pretrained="synthetic"),
    gan_loss=dict(type="GANLoss", gan_type="vanilla", loss_weight=0.1),
    is_use_sharpened_gt_in_pixel=True, is_use_ema=True)
SHIPPED = {name: glob.glob(str(tw.ROOT / "configs" /
                               f"002_real_{name}_*.py"))[0]
           for name in ("wogan", "gan")}


def quiet(*_):
    pass


def gan_batches(n: int, seed: int = 4) -> list[dict]:
    """B = 2, 16² LR; 256 contiguous queries (rows of the 64² grid) with
    gt and gt_unsharp."""
    coord, cell = (t.numpy() for t in make_coord_cell((64, 64)))
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        starts = rng.integers(0, 64 * 64 - 256, size=2)
        out.append(dict(
            lq=rng.random((2, 16, 16, 3), dtype=np.float32),
            gt=rng.random((2, 256, 3), dtype=np.float32),
            gt_unsharp=rng.random((2, 256, 3), dtype=np.float32),
            coord=np.stack([coord[s:s + 256] for s in starts]),
            cell=np.stack([cell[s:s + 256] for s in starts])))
    return out


def gan_cfg(**kw) -> Config:
    return Config(dict(dict(
        model=GAN_MODEL, train_cfg=dict(ema_momentum=0.9),
        optimizers=dict(generator=ADAM, discriminator=dict(ADAM, lr=2e-4)),
        lr_config=dict(policy="Step", by_epoch=False, step=[3], gamma=0.5),
        checkpoint_config=dict(interval=1, max_to_keep=2),
        log_config=dict(interval=1)), **kw))


def gan_restorer(cfg) -> RealCiaoSRRestorer:
    model = dict(cfg.model)
    del model["type"]
    return RealCiaoSRRestorer(**model, train_cfg=cfg.get("train_cfg"),
                              device="cpu", seed=0)


def run_gan(cfg, work, loader, total) -> GANTrainer:
    trainer = GANTrainer(gan_restorer(cfg), cfg, str(work), progress=quiet)
    trainer.run(loader, total_iters=total)
    return trainer


def same_state(a: dict, b: dict) -> None:
    """Two (nested) checkpoint dicts hold equal tensors, bit for bit."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            if k != "meta":
                same_state(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same_state(x, y)
    else:
        assert a == b


# ----------------------------------------------------------- GANTrainer --
@pytest.fixture(scope="module")
def gan_runs(tmp_path_factory):
    """4 iterations straight, and 2 then resumed to 4 (the resumed loop's
    loader starts again at its first batch: it is given batches 2 and 3)."""
    root = tmp_path_factory.mktemp("gan")
    bs = gan_batches(4)
    cfg = gan_cfg()
    straight = run_gan(cfg, root / "straight", bs, 4)
    run_gan(cfg, root / "cut", bs[:2], 2)
    resumed = run_gan(cfg, root / "cut", bs[2:], 4)
    return root, cfg, straight, resumed


def test_gan_checkpoint_layout_and_pruning(gan_runs):
    root, cfg, straight, _ = gan_runs
    ckpt_dir = root / "straight" / "checkpoints"
    assert port_ckpt.list_steps(str(ckpt_dir)) == [3, 4]   # max_to_keep 2
    ckpt = port_ckpt.read_checkpoint(str(ckpt_dir / "iter_4.pth"))
    sd = ckpt["state_dict"]
    res = straight.restorer
    for name, mod in (("generator", res.generator),
                      ("generator_ema", res.generator_ema),
                      ("discriminator", res.discriminator)):
        keys = {k[len(name) + 1:] for k in sd if k.startswith(name + ".")}
        assert keys == set(mod.state_dict()), name
    assert {"conv_1.u", "conv_1.sigma", "conv_8.u"} <= {
        k[len("discriminator."):] for k in sd}
    assert set(ckpt["optimizer"]) == set(ckpt["scheduler"]) == {
        "generator", "discriminator"}
    assert ckpt["step"] == 4 and ckpt["meta"]["iter"] == 4
    # the discriminator's own optimizer config (lr 2e-4), both scheduled
    assert ckpt["optimizer"]["discriminator"]["param_groups"][0][
        "initial_lr"] == 2e-4
    # the EMA copy loads strictly through the .pth loader, and differs
    ema = load_torch_checkpoint(str(ckpt_dir / "iter_4.pth"), cfg.model,
                                ema=True, strict=True)
    res.generator_ema.load_state_dict(ema, strict=True)
    assert all(torch.equal(v, res.generator_ema.state_dict()[k])
               for k, v in ema.items())
    gen = load_torch_checkpoint(str(ckpt_dir / "iter_4.pth"), cfg.model,
                                strict=True)
    assert any(not torch.equal(gen[k], ema[k]) for k in gen)
    logged = open(root / "straight" / "train_log.jsonl").read()
    for key in ("loss_pix", "loss_perceptual", "loss_gan", "loss_d_real",
                "loss_d_fake"):
        assert key in logged


def test_gan_resume_is_bit_equal(gan_runs):
    root, _, straight, resumed = gan_runs
    assert straight.state.step == resumed.state.step == 4
    a = port_ckpt.read_checkpoint(str(root / "straight" / "checkpoints"
                                      / "iter_4.pth"))
    b = port_ckpt.read_checkpoint(str(root / "cut" / "checkpoints"
                                      / "iter_4.pth"))
    same_state(a, b)
    for mod in ("generator", "generator_ema", "discriminator"):
        sa = getattr(straight.restorer, mod).state_dict()
        sb = getattr(resumed.restorer, mod).state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa), mod


def test_gan_resume_from_and_wogan_have_no_discriminator(tmp_path):
    cfg = gan_cfg(model=dict(GAN_MODEL, discriminator=None, gan_loss=None,
                             perceptual_loss=None),
                  optimizers=dict(generator=ADAM))
    bs = gan_batches(3, seed=6)
    first = run_gan(cfg, tmp_path / "a", bs, 2)
    assert first.d_optimizer is None
    ckpt = port_ckpt.read_checkpoint(str(tmp_path / "a" / "checkpoints"
                                         / "iter_2.pth"))
    assert set(ckpt["optimizer"]) == {"generator"}
    assert not any(k.startswith("discriminator.")
                   for k in ckpt["state_dict"])
    again = GANTrainer(gan_restorer(cfg), cfg, str(tmp_path / "b"),
                       resume_from=str(tmp_path / "a"), progress=quiet)
    again.run(bs[2:], total_iters=3)
    assert again.state.step == 3
    assert port_ckpt.list_steps(str(tmp_path / "b" / "checkpoints")) == [3]


# ------------------------------------------------- load_staged_generator --
def test_load_staged_generator_from_each_source(gan_runs, tmp_path):
    root, cfg, straight, _ = gan_runs
    res = straight.restorer
    g_want, e_want = res.generator.state_dict(), res.generator_ema.state_dict()

    def check(path, g_ref, e_ref):
        g, e = port_ckpt.load_staged_generator(str(path), cfg.model)
        assert all(torch.equal(g[k], g_ref[k]) for k in g_ref), path
        assert all(torch.equal(e[k], e_ref[k]) for k in e_ref), path

    work = root / "straight"
    for path in (work, work / "checkpoints", work / "latest",
                 work / "checkpoints" / "iter_4.pth"):
        check(path, g_want, e_want)

    # a classical run of the port: its generator seeds both
    classical = Trainer(CiaoSRRestorer(tw.SWIN_SMALL, device="cpu"),
                        Config(dict(optimizers=ADAM,
                                    checkpoint_config=dict(interval=1),
                                    log_config=dict(interval=1))),
                        str(tmp_path / "classical"), progress=quiet)
    classical.run([{k: v for k, v in b.items() if k != "gt_unsharp"}
                   for b in gan_batches(1)], total_iters=1)
    g_cls = classical.restorer.generator.state_dict()
    check(tmp_path / "classical", g_cls, g_cls)

    # a reference-layout .pth (mmcv meta dict, EMA and discriminator)
    ref = {"meta": {"iter": 7}, "state_dict": {
        **{f"generator.{k}": v for k, v in g_cls.items()},
        **{f"generator_ema.{k}": v * 0.5 for k, v in g_cls.items()},
        "discriminator.conv0.weight": torch.zeros(8, 3, 3, 3)}}
    torch.save(ref, tmp_path / "reference.pth")
    check(tmp_path / "reference.pth", g_cls,
          {k: v * 0.5 for k, v in g_cls.items()})

    # GANTrainer's load_from seeds the generator and its EMA copy
    staged = GANTrainer(gan_restorer(cfg), gan_cfg(load_from=str(work)),
                        str(tmp_path / "stage2"), progress=quiet)
    staged._maybe_resume()
    assert staged.state.step == 0
    for mod, want in (("generator", g_want), ("generator_ema", e_want)):
        got = getattr(staged.restorer, mod).state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want), mod


# ------------------------------------------- the shipped 002 model dicts --
def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _shapes(tree) -> dict:
    return {jax.tree_util.keystr(p): tuple(np.shape(v)) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", ["wogan", "gan"])
@torch.no_grad()
def test_build_model_on_the_shipped_002_model_dicts(name):
    cfg = JaxConfig.fromfile(SHIPPED[name])
    port = build_model(_plain(cfg.model), train_cfg=cfg.train_cfg,
                       test_cfg=cfg.test_cfg, device="cpu")
    ref = jax_build_model(cfg.model, cfg.train_cfg, cfg.test_cfg)
    assert isinstance(port, RealCiaoSRRestorer)
    assert not port.generator.use_kernels   # the CPU: the plain route
    params = jax.eval_shape(lambda: ref.init_params(jax.random.PRNGKey(0)))
    got = convert_generator(
        {k: v.numpy() for k, v in port.generator.state_dict().items()},
        strict=True, feat_dim=180, n_hidden=4, encoder="swinir",
        non_local_attn=False)
    assert _shapes(got) == _shapes(params)
    assert set(port.generator_ema.state_dict()) == set(
        port.generator.state_dict())
    assert (port.discriminator is None) == (ref.discriminator is None) \
        == (name == "wogan")
    if port.discriminator is not None:
        d_vars = jax.eval_shape(lambda: ref.discriminator.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
        want = discriminator_state_dict_from_jax(
            jax.tree.map(lambda s: np.zeros(s.shape, np.float32), d_vars))
        assert {k: tuple(v.shape) for k, v in want.items()} == {
            k: tuple(v.shape) for k, v in
            port.discriminator.state_dict().items()}
        assert port.gan_loss.__dict__ == ref.gan_loss.__dict__
        pl, rl = port.perceptual_loss, ref.perceptual_loss
        assert (pl.layer_weights, pl.perceptual_weight, pl.style_weight,
                pl.norm_img, pl.criterion) == (
            rl.layer_weights, rl.perceptual_weight, rl.style_weight,
            rl.norm_img, rl.criterion)
        assert pl.vgg.layer_name_list == tuple(sorted(rl.layer_weights))
    assert port.pixel_loss.__dict__ == ref.pixel_loss.__dict__
    for attr in ("use_sharp_pixel", "use_sharp_percep", "use_sharp_gan",
                 "is_use_ema", "disc_steps", "disc_init_steps",
                 "ema_momentum", "ema_start_iter"):
        assert getattr(port, attr) == getattr(ref, attr), attr


@pytest.mark.parametrize("name", ["wogan", "gan"])
def test_shipped_002_train_pipeline_names_the_degradation_item(name):
    cfg = Config.fromfile(SHIPPED[name])
    with pytest.raises(NotImplementedError,
                       match=r"item 7 \(data/degradations\.py\)"):
        build_dataset(cfg.data["train"])


# --------------------------------------------------- tools.train / .test --
STAGE_CONFIG = """
model = dict(
    type='RealCiaoSR',
    generator=dict(
        type='LocalImplicitSRSWINIR', window_size=8,
        encoder=dict(type='SwinIR', embed_dim=12, depths=(2, 2),
                     num_heads=(3, 3)),
        imnet_q=dict(type='MLPRefiner', out_dim=3, hidden_list=[32, 32]),
        imnet_k=dict(type='MLPRefiner', out_dim=1, hidden_list=[32, 32]),
        imnet_v=dict(type='MLPRefiner', out_dim=1, hidden_list=[32, 32]),
        non_local_attn=False),
    pixel_loss=dict(type='L1Loss', loss_weight=1.0, reduction='mean'),
    {gan}
    is_use_sharpened_gt_in_pixel=True,
    is_use_ema=True)
train_cfg = dict(disc_steps=1, disc_init_steps=0, ema_momentum=0.9)
test_cfg = dict(metrics=['PSNR'], crop_border=4, scale=4)
train_pipeline = [
    dict(type='LoadImageFromFile', io_backend='disk', key='gt'),
    dict(type='RandomDownSampling', scale_min=4, scale_max=4,
         patch_size=16),
    dict(type='RescaleToZeroOne', keys=['lq', 'gt']),
    dict(type='ImageToTensor', keys=['lq', 'gt']),
    dict(type='GenerateCoordinateAndCell', sample_quantity=256,
         is_shuffle=False),
    dict(type='Collect', keys=['lq', 'gt', 'coord', 'cell'],
         meta_keys=['gt_path'])]
valid_pipeline = [
    dict(type='LoadImageFromFile', io_backend='disk', key='gt'),
    dict(type='RandomDownSampling', scale_min=4, scale_max=4),
    dict(type='RescaleToZeroOne', keys=['lq', 'gt']),
    dict(type='ImageToTensor', keys=['lq', 'gt']),
    dict(type='GenerateCoordinateAndCell', scale=4),
    dict(type='Collect', keys=['lq', 'gt', 'coord', 'cell'],
         meta_keys=['gt_path'])]
val = dict(type='SRFolderGTDataset', gt_folder='{root}/val',
           pipeline=valid_pipeline, scale=4)
data = dict(
    workers_per_gpu=2,
    train_dataloader=dict(samples_per_gpu=2, drop_last=True),
    train=dict(type='RepeatDataset', times=2,
               dataset=dict(type='SRFolderGTDataset', gt_folder='{root}/hr',
                            pipeline=train_pipeline, scale=4)),
    val=val, test=val)
optimizers = dict(generator=dict(type='Adam', lr=2e-4, betas=(0.9, 0.99)),
                  discriminator=dict(type='Adam', lr=1e-4,
                                     betas=(0.9, 0.99)))
total_iters = 1000
lr_config = dict(policy='Step', by_epoch=False, step=[200], gamma=1)
checkpoint_config = dict(interval=2, save_optimizer=True, by_epoch=False)
evaluation = dict(interval=1000, save_image=False)
log_config = dict(interval=1)
work_dir = '{root}/{name}'
load_from = {load_from}
test_checkpoint_path = '{root}/{name}/latest'
"""
GAN_PART = """discriminator=dict(type='UNetDiscriminatorWithSpectralNorm',
                       in_channels=3, mid_channels=8, skip_connection=True),
    perceptual_loss=dict(type='PerceptualLoss', layer_weights={{'2': 0.1}},
                         vgg_type='vgg19', perceptual_weight=1.0,
                         style_weight=0, norm_img=False,
                         pretrained='synthetic'),
    gan_loss=dict(type='GANLoss', gan_type='vanilla', loss_weight=1e-1,
                  real_label_val=1.0, fake_label_val=0),"""


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    """Seeded folders and the two stage configs (ported ops only)."""
    root = tmp_path_factory.mktemp("stages")
    rng = np.random.default_rng(12)
    for sub, shapes in (("hr", [(72, 80), (80, 72)]), ("val", [(32, 32)])):
        (root / sub).mkdir()
        for i, hw in enumerate(shapes):
            write_png(str(root / sub / f"im{i}.png"),
                      smooth_picture(rng, *hw))
    paths = {}
    for name, gan, load_from in (
            ("wogan", "", "None"),
            ("gan", GAN_PART.format(), f"'{root}/wogan'")):
        text = STAGE_CONFIG.format(root=root, name=name, load_from=load_from,
                                   gan=gan)
        paths[name] = root / f"{name}.py"
        paths[name].write_text(text)
    return root, paths


def test_tools_train_runs_both_stages_and_tools_test_takes_the_ema(stages,
                                                                   capsys):
    root, paths = stages
    one = port_train.main([str(paths["wogan"]), "--device", "cpu",
                           "--total-iters", "2"])
    assert isinstance(one, GANTrainer) and one.d_optimizer is None
    stage1 = port_ckpt.read_checkpoint(str(root / "wogan" / "checkpoints"
                                           / "iter_2.pth"))
    two = port_train.main([str(paths["gan"]), "--device", "cpu",
                           "--total-iters", "2", "--deterministic"])
    # the run's deterministic mode ends with it
    assert not torch.are_deterministic_algorithms_enabled()
    assert not torch.backends.cudnn.deterministic
    assert "[load_from] generator and its EMA copy" in capsys.readouterr().out
    assert isinstance(two, GANTrainer) and two.state.step == 2
    stage2 = port_ckpt.read_checkpoint(str(root / "gan" / "checkpoints"
                                           / "iter_2.pth"))
    assert any(k.startswith("discriminator.") for k in stage2["state_dict"])
    # stage 2 trained from stage 1's weights: its EMA copy after two steps
    # (momentum 0.9) is stage 1's EMA blended with the trained generator
    s1e = {k[len("generator_ema."):]: v for k, v in
           stage1["state_dict"].items() if k.startswith("generator_ema.")}
    s2e = {k[len("generator_ema."):]: v for k, v in
           stage2["state_dict"].items() if k.startswith("generator_ema.")}
    drift = max(float((s2e[k] - s1e[k]).abs().max()) for k in s1e)
    assert 0 < drift < 1e-2

    # tools.test on the stage-2 work_dir evaluates the EMA copy
    got = port_test.main([str(paths["gan"]), str(root / "gan"),
                          "--device", "cpu"])
    cfg = Config.fromfile(str(paths["gan"]))
    res = build_model(cfg.model, test_cfg=cfg.test_cfg, device="cpu")
    res.generator_ema.load_state_dict(s2e, strict=True)
    want = evaluate_dataset(res, build_dataset(cfg.data["test"]))
    assert got["PSNR"] == want["PSNR"]
    res.generator_ema.load_state_dict(load_torch_checkpoint(
        str(root / "gan" / "checkpoints" / "iter_2.pth"), cfg.model),
        strict=True)
    assert evaluate_dataset(res, build_dataset(cfg.data["test"]))[
        "PSNR"] != got["PSNR"]


def test_autoscale_lr_refuses_per_module_optimizers(stages):
    _, paths = stages
    with pytest.raises(ValueError, match="per-module optimizers"):
        port_train.main([str(paths["gan"]), "--device", "cpu",
                         "--autoscale-lr", "--total-iters", "1"])
