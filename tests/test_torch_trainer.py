"""The port's training loop against the JAX package's, f32 on the CPU.

* ``Trainer``: 4 iterations of a small 001-rdn-shaped generator (CSA and
  the unfold; 2 RDBs, 16 channels) from JAX's initial weights
  (``state_dict_from_jax``) against JAX's ``make_train_step`` and
  ``build_optimizer`` on the same batches: losses within 1e-5 relative,
  the logged lr equal to JAX's schedule.
* Checkpoints: the files kept after a run equal the steps JAX's orbax
  manager keeps after the same saves, with and without
  ``keep_best_metric``; every file loads strictly through the port's
  ``.pth`` loader.
* Resume: auto-resume and ``resume_from`` (a work_dir, its checkpoints
  dir, one file) restore the generator, Adam's moments, the scheduler and
  the step bit-equal; ``auto_resume=False`` starts again at 0.
* The eval hook: a SwinIR + CSA generator on its kernel route (plain
  versions on the CPU; the Swin blocks' packs made under inference mode
  by the eval) trains, evaluates and trains again with exactly the losses
  and weights of a run without the eval.
* The train CLI: its flags, dumps and log lines; ``tools.test`` reads
  its checkpoints; the entry points import no JAX.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_weights as tw
from chip_smoke import smooth_picture
from ciaosr_torch.config import Config
from ciaosr_torch.convert.from_jax import state_dict_from_jax
from ciaosr_torch.convert.load import load_torch_checkpoint
from ciaosr_torch.core.coords import make_coord_cell
from ciaosr_torch.data.imageio import write_png
from ciaosr_torch.models.restorers import CiaoSRRestorer
from ciaosr_torch.tools import test as port_test
from ciaosr_torch.tools import train as port_train
from ciaosr_torch.train import checkpoint as port_ckpt
from ciaosr_torch.train.trainer import Trainer
from ciaosr_tpu.models.restorers import CiaoSRRestorer as JaxRestorer
from ciaosr_tpu.train import checkpoint as jax_ckpt
from ciaosr_tpu.train import optim as jax_optim
from ciaosr_tpu.train import trainer as jax_trainer
from tests.test_torch_swinir_csa import _cut as swin001_cut

ADAM = dict(type="Adam", lr=1e-4)
LR_CFG = dict(policy="Step", by_epoch=False, step=[2], gamma=0.5)


def batches(n: int, b: int = 2, lr: int = 16, q: int = 64, seed: int = 5):
    """Seeded numpy batches as the 001 pipeline gives them: LR patches,
    and per sample q random queries of the ×4 HR grid with their gt."""
    coord, cell = (t.numpy() for t in make_coord_cell((4 * lr, 4 * lr)))
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        sel = [rng.permutation(len(coord))[:q] for _ in range(b)]
        out.append(dict(lq=rng.random((b, lr, lr, 3), dtype=np.float32),
                        gt=rng.random((b, q, 3), dtype=np.float32),
                        coord=np.stack([coord[s] for s in sel]),
                        cell=np.stack([cell[s] for s in sel])))
    return out


def train_cfg(interval=100, log=1, **ckpt) -> Config:
    return Config(dict(optimizers=ADAM, lr_config=LR_CFG,
                       checkpoint_config=dict(interval=interval, **ckpt),
                       log_config=dict(interval=log)))


def small_restorer(init=None, cfg=tw.SMALL) -> CiaoSRRestorer:
    res = CiaoSRRestorer(cfg, device="cpu")
    if init is not None:
        res.generator.load_state_dict(state_dict_from_jax(
            init, feat_dim=16, n_hidden=2), strict=True)
    return res


def logged(work_dir, key="loss_pix") -> list:
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        return [r[key] for r in map(json.loads, f) if key in r]


def quiet(*_):
    pass


# ------------------------------------------------------ Trainer vs JAX --
@pytest.fixture(scope="module")
def jax_run():
    """JAX's initial weights and 4 steps of its make_train_step."""
    _, params = tw.generator_params(tw.SMALL, seed=8)
    init = jax.tree.map(np.array, params)
    tx, schedule = jax_optim.build_optimizer(dict(ADAM), LR_CFG)
    step = jax_trainer.make_train_step(JaxRestorer(tw.SMALL), tx)
    state = jax_trainer.TrainState(step=jnp.asarray(0), params=params,
                                   opt_state=tx.init(params))
    losses = []
    for b in batches(4):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss_pix"]))
    return init, losses, [float(schedule(k)) for k in range(1, 5)]


def test_trainer_matches_jax_train_steps(jax_run, tmp_path):
    init, ref_losses, ref_lrs = jax_run
    trainer = Trainer(small_restorer(init), train_cfg(), str(tmp_path),
                      auto_resume=False, progress=quiet)
    state = trainer.run(batches(4), total_iters=4)
    assert state.step == 4 and trainer.scheduler.last_epoch == 4
    for got, ref in zip(logged(tmp_path), ref_losses, strict=True):
        assert abs(got - ref) <= 1e-5 * abs(ref)
    # the lr logged after step k is the schedule at k (optax: f32)
    for got, ref in zip(logged(tmp_path, "lr"), ref_lrs, strict=True):
        assert abs(got - ref) <= 1e-6 * ref


# ---------------------------------------------------------- checkpoints --
def jax_kept(tmp_path, saves, max_to_keep, best):
    """The steps JAX's orbax manager keeps after ``saves`` (step,
    metrics or None for the final save), as its Trainer makes them."""
    mgr = jax_ckpt.CheckpointManager(str(tmp_path / "jax"),
                                     max_to_keep=max_to_keep, interval=2,
                                     keep_best_metric=best)
    state = {"w": np.zeros(2, np.float32)}
    for step, metrics in saves:
        if metrics is None:
            mgr.save(step, state)
        else:
            mgr.maybe_save(step, state, metrics)
    mgr.wait()
    kept = sorted(mgr.mgr.all_steps())
    mgr.mgr.close()
    return kept


# PSNR of the evals at steps 2, 4, 6 and 8 (not monotonic)
EVALS = {2: 30.0, 4: 32.0, 6: 31.0, 8: 29.5}


@pytest.mark.parametrize("best", [None, "PSNR"], ids=["latest", "best"])
def test_checkpoints_kept_match_jax(tmp_path, best):
    """Saves every 2 iterations to 9 and a final one, max_to_keep 2, evals
    every 2: the same files as JAX's manager keeps. Every kept file loads
    strictly through convert/load.py and holds its step's state."""
    init = jax.tree.map(np.array, tw.generator_params(tw.SMALL, seed=8)[1])
    trainer = Trainer(small_restorer(init),
                      train_cfg(interval=2, log=2, max_to_keep=2,
                                keep_best_metric=best),
                      str(tmp_path / "port"), auto_resume=False,
                      progress=quiet)
    trainer.run(batches(9, b=1, lr=8, q=16), total_iters=9,
                eval_fn=lambda: {"PSNR": EVALS[trainer.state.step]},
                eval_interval=2)
    got = port_ckpt.list_steps(trainer.ckpt.dir)
    saves = [(s, {"PSNR": EVALS[s]}) for s in (2, 4, 6, 8)] + [(9, None)]
    assert got == jax_kept(tmp_path, saves, 2, best)
    assert got == ([8, 9] if best is None else [4, 6])
    model = dict(type="CiaoSR", generator=tw.SMALL)
    for s in got:
        path = trainer.ckpt.path(s)
        sd = load_torch_checkpoint(path, model, strict=True)
        ckpt = port_ckpt.read_checkpoint(path)
        assert ckpt["step"] == ckpt["meta"]["iter"] == s
        assert ckpt["scheduler"]["last_epoch"] == s
        assert set(sd) == set(trainer.state.generator.state_dict())
    assert not [f for f in os.listdir(trainer.ckpt.dir)
                if not f.startswith("iter_")]   # no temporary file left


def _snapshot(trainer):
    """Copies of the generator's tensors, Adam's state, the scheduler's
    state and the step."""
    opt = trainer.optimizer.state_dict()
    return ({k: v.clone() for k, v in
             trainer.state.generator.state_dict().items()},
            {i: {k: v.clone() for k, v in s.items()}
             for i, s in opt["state"].items()},
            dict(trainer.scheduler.state_dict()), trainer.state.step)


def _same_snapshot(a, b):
    gen_a, opt_a, sch_a, step_a = a
    gen_b, opt_b, sch_b, step_b = b
    assert step_a == step_b and sch_a == sch_b
    assert set(gen_a) == set(gen_b) and set(opt_a) == set(opt_b)
    for k in gen_a:
        assert torch.equal(gen_a[k], gen_b[k]), k
    for i in opt_a:
        for k in opt_a[i]:
            assert torch.equal(opt_a[i][k], opt_b[i][k]), (i, k)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A run to iteration 4 with checkpoints at 2 and 4, and its state."""
    work = str(tmp_path_factory.mktemp("run"))
    trainer = Trainer(small_restorer(), train_cfg(interval=2), work,
                      progress=quiet)
    trainer.run(batches(4, b=1, lr=8, q=16), total_iters=4)
    return work, _snapshot(trainer)


def _resumed(work_dir, **kw):
    """A new Trainer on a fresh restorer (other seeded weights), after the
    resume its run() starts with."""
    res = CiaoSRRestorer(tw.SMALL, device="cpu", seed=7)
    trainer = Trainer(res, train_cfg(interval=2), work_dir, progress=quiet,
                      **kw)
    trainer._maybe_resume()
    return trainer


@pytest.mark.parametrize("how", ["auto", "work_dir", "checkpoints_dir",
                                 "file"])
def test_resume_restores_state_bit_equal(trained, tmp_path, how):
    work, saved = trained
    if how == "auto":
        trainer = _resumed(work)
    else:
        src = {"work_dir": work,
               "checkpoints_dir": os.path.join(work, "checkpoints"),
               "file": os.path.join(work, "checkpoints", "iter_4.pth")}[how]
        trainer = _resumed(str(tmp_path), resume_from=src)
    _same_snapshot(_snapshot(trainer), saved)
    assert trainer.optimizer.param_groups[0]["lr"] == 0.5e-4


def test_no_auto_resume_starts_at_zero(trained, tmp_path):
    work, saved = trained
    trainer = _resumed(work, auto_resume=False)
    fresh = CiaoSRRestorer(tw.SMALL, device="cpu", seed=7)
    assert trainer.state.step == 0 and trainer.scheduler.last_epoch == 0
    for k, v in fresh.generator.state_dict().items():
        assert torch.equal(trainer.state.generator.state_dict()[k], v)
    with pytest.raises(FileNotFoundError):
        _resumed(str(tmp_path / "b"), resume_from=str(tmp_path / "none"))


def test_resumed_run_continues_from_the_saved_step(trained, tmp_path):
    """Resumed at 4 and run to 6: two more updates (the loader starts
    again from its first batch, as in JAX), saves at 6."""
    work, _ = trained
    res = CiaoSRRestorer(tw.SMALL, device="cpu", seed=7)
    trainer = Trainer(res, train_cfg(interval=2), str(tmp_path),
                      resume_from=work, progress=quiet)
    seen = []
    trainer.run((seen.append(b) or b for b in batches(9, b=1, lr=8, q=16)),
                total_iters=6)
    assert trainer.state.step == 6 and len(seen) == 2
    assert port_ckpt.list_steps(trainer.ckpt.dir) == [6]
    assert logged(tmp_path, "step") == [5, 6]


# ------------------------------------------------------------ eval hook --
SWIN_CSA = dict(swin001_cut(12, (2,), (3,), [32, 32]), use_kernels=True)


class TinyVal:
    """Two LR / GT pairs at ×2 for evaluate_dataset."""
    scale = 2

    def __len__(self):
        return 2

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        return {"lq": rng.random((16, 16, 3), dtype=np.float32),
                "gt": rng.random((32, 32, 3), dtype=np.float32),
                "meta": {"scale": 2, "target_size": (32, 32)}}


def test_eval_hook_leaves_training_unchanged(tmp_path, monkeypatch):
    """Evals after every iteration (Swin packs made under inference mode,
    reused by the next training forward): the losses and the weights equal
    a run without them, bit for bit."""
    from ciaosr_torch.eval.evaluator import evaluate_dataset
    from ciaosr_torch.ops.kernels import swin_block as sb

    # the packs the training forward (SwinBlockFunction) runs on: made
    # under inference mode or not
    packs = []
    real = sb.swin_block
    monkeypatch.setattr(sb, "swin_block", lambda x, pk, *a: packs.append(
        pk["wqkv"].is_inference()) or real(x, pk, *a))
    runs = []
    for with_eval in (False, True):
        packs.clear()
        res = CiaoSRRestorer(SWIN_CSA, device="cpu",
                             test_cfg=dict(metrics=["PSNR"], crop_border=2))
        work = str(tmp_path / str(with_eval))
        trainer = Trainer(res, train_cfg(), work, progress=quiet)
        evals = []
        trainer.run(batches(4, b=1, lr=16, q=32), total_iters=4,
                    eval_fn=lambda: evals.append(evaluate_dataset(
                        res, TinyVal(), progress=quiet)) or evals[-1],
                    eval_interval=1 if with_eval else None)
        assert len(evals) == (4 if with_eval else 0)
        assert all(np.isfinite(e["PSNR"]) for e in evals)
        runs.append((logged(work), res.generator.state_dict()))
        # 4 steps of 2 blocks; after an eval, the next step's packs are the
        # eval's (inference tensors)
        assert len(packs) == 8 and sum(packs) == (6 if with_eval else 0)
    (l0, w0), (l1, w1) = runs
    assert l0 == l1 and len(l0) == 4
    assert logged(tmp_path / "True", "val_PSNR") == [e["PSNR"]
                                                     for e in evals]
    for k in w0:
        assert torch.equal(w0[k], w1[k]), k


# ------------------------------------------------------------ train CLI --
CLI_CONFIG = textwrap.dedent("""\
    model = dict(
        type='{mtype}',
        generator=dict(
            type='LocalImplicitSRRDN',
            encoder=dict(type='RDN', in_channels=3, out_channels=3,
                         mid_channels=16, num_blocks=2, num_layers=3,
                         channel_growth=8),
            imnet_q=dict(type='MLPRefiner', out_dim=3, hidden_list=[32]),
            imnet_k=dict(type='MLPRefiner', out_dim=16, hidden_list=[32]),
            imnet_v=dict(type='MLPRefiner', out_dim=16, hidden_list=[32]),
            feat_unfold=True, eval_bsize=30000),
        rgb_mean=(0.4488, 0.4371, 0.4040), rgb_std=(1., 1., 1.),
        pixel_loss=dict(type='L1Loss', loss_weight=1.0, reduction='mean'))
    train_cfg = None
    test_cfg = dict(metrics=['PSNR', 'SSIM'], crop_border=4, scale=4,
                    convert_to='y')
    train_pipeline = [
        dict(type='LoadImageFromFile', io_backend='disk', key='gt'),
        dict(type='RandomDownSampling', scale_min=1, scale_max=4,
             patch_size=8),
        dict(type='RescaleToZeroOne', keys=['lq', 'gt']),
        dict(type='Flip', keys=['lq', 'gt'], flip_ratio=0.5,
             direction='horizontal'),
        dict(type='Flip', keys=['lq', 'gt'], flip_ratio=0.5,
             direction='vertical'),
        dict(type='RandomTransposeHW', keys=['lq', 'gt'],
             transpose_ratio=0.5),
        dict(type='ImageToTensor', keys=['lq', 'gt']),
        dict(type='GenerateCoordinateAndCell', sample_quantity=64),
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
                   dataset=dict(type='SRFolderGTDataset',
                                 gt_folder='{root}/hr',
                                 pipeline=train_pipeline, scale=4)),
        val=val, test=val)
    optimizers = dict(type='Adam', lr=1.e-4)
    total_iters = 1000
    lr_config = dict(policy='Step', by_epoch=False, step=[200], gamma=0.5)
    checkpoint_config = dict(interval=1, save_optimizer=True, by_epoch=False)
    evaluation = dict(interval=2, save_image=False)
    log_config = dict(interval=1)
    work_dir = '{root}/work'
    test_checkpoint_path = '{root}/work/latest'
""")


@pytest.fixture(scope="module")
def cli_config(tmp_path_factory):
    """A tiny config (RDN + CSA, 16 channels) on seeded folders: 3 HR
    pictures to train on, 2 GT pictures to evaluate on."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(2)
    for sub, shapes in (("hr", [(40, 36), (36, 44), (48, 40)]),
                        ("val", [(32, 32), (24, 40)])):
        (root / sub).mkdir()
        for i, hw in enumerate(shapes):
            write_png(str(root / sub / f"im{i}.png"), smooth_picture(rng,
                                                                     *hw))

    def write(mtype="CiaoSR"):
        path = root / f"{mtype}.py"
        path.write_text(CLI_CONFIG.format(root=root, mtype=mtype))
        return str(path)

    return root, write


def test_train_cli_trains_resumes_and_tools_test_reads_it(cli_config):
    """2 iterations with --autoscale-lr (lr/8 on one device), then 3:
    auto-resume at 2. The dumps, the log lines, the eval at 2 and the
    checkpoints are written; tools.test on the work_dir, on 'None' (the
    config's <work_dir>/latest) and on the newest file gives the metrics
    of the run's own restorer on the same split."""
    from ciaosr_torch.data.datasets import build_dataset
    from ciaosr_torch.eval.evaluator import evaluate_dataset

    root, write = cli_config
    cfg = write()
    work = root / "work"
    args = [cfg, "--device", "cpu", "--seed", "3", "--autoscale-lr"]
    trainer = port_train.main(args + ["--total-iters", "2"])
    assert trainer.scheduler.base_lrs == [1e-4 / 8]
    assert trainer.state.step == 2
    assert (work / "config_dump.py").read_text() == open(cfg).read()
    env = json.loads((work / "env.json").read_text())
    assert env["torch"] == torch.__version__ and env["devices"] == ["cpu"]
    assert logged(work, "step") == [1, 2, 2]
    assert len(logged(work, "val_PSNR")) == 1
    assert port_ckpt.list_steps(str(work / "checkpoints")) == [1, 2]

    c = Config.fromfile(cfg)
    want = evaluate_dataset(trainer.restorer, build_dataset(c.data["test"]))
    for ckpt in (str(work), "None", str(work / "checkpoints" / "iter_2.pth")):
        got = port_test.main([cfg, ckpt, "--device", "cpu"])
        assert {k: got[k] for k in ("PSNR", "SSIM")} == \
            {k: want[k] for k in ("PSNR", "SSIM")}, ckpt

    again = port_train.main(args + ["--total-iters", "3"])
    assert again.state.step == 3
    assert logged(work, "step") == [1, 2, 2, 3]
    assert port_ckpt.list_steps(str(work / "checkpoints")) == [1, 2, 3]


def test_train_cli_bf16_and_what_is_not_ported(cli_config, tmp_path,
                                               monkeypatch):
    """--bf16 trains the generator in bf16; a BasicRestorer config
    (chip_smoke.py phase basic's, its net cut) trains an iteration in
    bf16; a RealCiaoSR config with the shipped 002 train pipeline
    (degradation chain, a narrow generator, 2 process workers) trains an
    iteration; --launcher pytorch with torchrun's environment for one
    process on the CPU (a gloo group) trains as --launcher none does and
    destroys its group; an unknown launcher is refused."""
    _, write = cli_config
    cfg = write()
    trainer = port_train.main([cfg, "--device", "cpu", "--bf16",
                               "--total-iters", "1", "--work-dir",
                               str(tmp_path / "bf16")])
    assert trainer.restorer.generator.dtype == torch.bfloat16
    assert np.isfinite(logged(tmp_path / "bf16")).all()
    for mtype, item in (("RealCiaoSR", "item 7"), ("BasicRestorer",
                                                   "item 5")):
        if mtype == "RealCiaoSR":   # item 7 is closed: it trains
            from tests.test_torch_degradations import (NARROW_002,
                                                       derived_002,
                                                       write_df2k)
            write_df2k(tmp_path, n=2)
            path = derived_002("wogan", tmp_path, NARROW_002 + (
                "data.update(workers_per_gpu=2)\n"
                "data['train_dataloader']['samples_per_gpu'] = 2\n"
                "log_config = dict(interval=1)\n"))
            trainer = port_train.main([path, "--device", "cpu",
                                       "--total-iters", "1", "--work-dir",
                                       str(tmp_path / mtype)])
            assert trainer.state.step == 1
            assert Config.fromfile(path).data["worker_mode"] == "process"
            assert np.isfinite(logged(tmp_path / mtype, "loss_pix")).all()
            continue
        # item 5 is closed: it trains
        from tests.test_torch_basic_cli import write_basic
        (tmp_path / "basic").mkdir()
        path = write_basic(tmp_path / "basic")["rdn"]
        monkeypatch.chdir(tmp_path / "basic")
        trainer = port_train.main([path, "--device", "cpu", "--bf16",
                                   "--total-iters", "1", "--work-dir",
                                   str(tmp_path / mtype)])
        assert trainer.state.step == 1
        assert trainer.restorer.generator.dtype == torch.bfloat16
        assert np.isfinite(logged(tmp_path / mtype, "loss_pix")).all()
    plain = port_train.main([cfg, "--device", "cpu", "--total-iters", "2",
                             "--work-dir", str(tmp_path / "plain")])
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="localhost", MASTER_PORT="0").items():
        monkeypatch.setenv(k, v)
    launched = port_train.main([cfg, "--device", "cpu", "--total-iters", "2",
                                "--launcher", "pytorch", "--work-dir",
                                str(tmp_path / "launched")])
    assert not torch.distributed.is_initialized()
    assert launched.mesh.world == 1 and launched.mesh.group is not None
    assert logged(tmp_path / "launched") == logged(tmp_path / "plain")
    for k, v in plain.restorer.generator.state_dict().items():
        assert torch.equal(launched.restorer.generator.state_dict()[k], v), k
    with pytest.raises(SystemExit):
        port_train.main([cfg, "--launcher", "tpu"])


def test_entry_points_import_no_jax():
    code = ("import sys, ciaosr_torch.tools.train, ciaosr_torch.tools.test, "
            "ciaosr_torch.data.loader, ciaosr_torch.train.checkpoint\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'orbax', 'ciaosr_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=tw.ROOT, check=True,
                   timeout=120)
