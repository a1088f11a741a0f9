"""The port's several-GPU surface (parallel/mesh.py) on the CPU: two gloo
ranks, spawned by ``torch.multiprocessing`` (tests/torch_parallel_worker.py,
one spawn for the whole file, a 240 s limit, collectives that give up
after 60 s), against one process and against the JAX package.

* Classical training: the small 001-rdn-shaped generator (CSA) from JAX's
  weights (``state_dict_from_jax``), 20 Adam steps of a global batch of
  4 (2 a rank) through ``Trainer``, an eval hook (a collective) at 10 and
  20, then 2 steps auto-resumed from the shared work_dir: both ranks log
  the same losses and end with the same weights, bit for bit; the losses
  and weights equal one process at the batch of 4 (≤ 1e-5 relative and
  ≤ 1e-6 absolute: the ranks' mean of two batch-2 gradients rounds
  otherwise than one batch-4 gradient, in f32, and Adam carries that over
  the steps); the first equals JAX's
  ``make_train_step`` (≤ 1e-5 relative, tests/test_torch_trainer.py's
  bound); rank 0 alone wrote the log and the checkpoints.
* Ragged eval: 3 images over 2 ranks, strided and gathered, and with the
  tiles sharded instead: every rank's summary is the same and equals JAX's
  single-process ``tools/test.py`` within 1e-5.
* Sharded and batched tiles: ``predict_tiled`` under the 2-rank mesh at
  ``tile_batch`` 2, 3 and 4, ×2 and ×4 (one case leaves a rank no tile)
  against the JAX composition oracle of tests/test_torch_restorer.py at
  1e-5, both ranks the same bits; ``tile_batch`` in one process against
  the same oracle; in the slow lane, against JAX's own ``predict_tiled``
  under a 2-device mesh at the same ``tile_batch``.
* GAN: 3 steps of ``make_gan_train_step`` (pixel, perceptual and GAN
  losses, the EMA re-seed at step 2) on 2 ranks against one process at the
  global batch of 2: the losses and weights within 1e-5; the generator,
  EMA copy and discriminator (the spectral norms' ``u`` and ``sigma``
  among its tensors) bit-equal on both ranks.
* ``shard_batch``, and ``--launcher pytorch`` of ``tools.test`` and
  ``tools.inference`` with torchrun's environment for one process.
* The launch helpers refuse a tensor off the current device.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_weights as tw
from ciaosr_torch.config import Config
from ciaosr_torch.convert.from_jax import state_dict_from_jax
from ciaosr_torch.data.imageio import read_png, write_png
from ciaosr_torch.models.real_restorer import (GANTrainState,
                                               RealCiaoSRRestorer)
from ciaosr_torch.models.restorers import CiaoSRRestorer
from ciaosr_torch.ops.kernels import _build
from ciaosr_torch.parallel.mesh import Mesh, shard_batch
from ciaosr_torch.tools import inference as port_inference
from ciaosr_torch.tools import test as port_test
from ciaosr_torch.train.optim import build_optimizer
from ciaosr_torch.train.trainer import Trainer
from ciaosr_tpu.models.restorers import CiaoSRRestorer as JaxRestorer
from ciaosr_tpu.train import optim as jax_optim
from ciaosr_tpu.train import trainer as jax_trainer
from tests import torch_parallel_worker as worker
from tests.test_torch_cli import jax_test_main, make_case
from tests.test_torch_gan_step import OPT, TRAIN_CFG, model_cfg
from tests.test_torch_gan_step import batches as gan_batches
from tests.test_torch_perceptual import vgg_file  # noqa: F401  (fixture)
from tests.test_torch_restorer import jax_composition
from tests.test_torch_trainer import ADAM, LR_CFG, batches

ITERS, MORE = 20, 2
LOSS_REL = 1e-5      # 2 ranks against one process, 20 Adam steps
WEIGHT_TOL = 1e-6    # their weights after the 20 steps
JAX_REL = 1e-5       # the first step against JAX's
EVAL_TOL = 1e-5      # the JAX package's own bound on a gathered eval
TILE_TOL = 1e-5
GAN_TOL = 1e-5
TRAIN_CFG_DICT = dict(optimizers=ADAM, lr_config=LR_CFG,
                      checkpoint_config=dict(interval=ITERS // 2),
                      log_config=dict(interval=1))
# (lq shape, seed, scale, tile, overlap, tile_batch): 4 tiles of 16 on
# 24 × 20; 2 tiles on 16 × 20, which tile_batch 4 gives rank 0 alone
TILE_CASES = [((24, 20), 2, 2, 16, 4, 2), ((24, 20), 4, 4, 16, 4, 4),
              ((24, 20), 2, 2, 16, 4, 3), ((16, 20), 5, 2, 16, 4, 4)]


@pytest.fixture(scope="module")
def jax_small():
    """The small generator's JAX params (seed 8) and the port's state
    dict of them."""
    jnet, params = tw.generator_params(tw.SMALL, seed=8)
    return jnet, params, state_dict_from_jax(
        jax.tree.map(np.array, params), feat_dim=16, n_hidden=2)


def tile_inputs():
    return [(np.random.default_rng(seed).random((*hw, 3), dtype=np.float32),
             s, t, o, tb) for hw, seed, s, t, o, tb in TILE_CASES]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_small, vgg_file):  # noqa: F811
    """Both ranks' results of every task, and their inputs."""
    _, _, sd = jax_small
    tmp = tmp_path_factory.mktemp("ranks")
    cfg, ckpt = make_case(tmp_path_factory.mktemp("eval"), nla=False)
    eval_cfg = dict(Config.fromfile(cfg).data["test"])
    vgg = str(vgg_file / "vgg19.pth")
    inputs = dict(
        train=dict(sd=sd, cfg=dict(generator=tw.SMALL,
                                   test_cfg=dict(metrics=["PSNR"]),
                                   train=TRAIN_CFG_DICT),
                   batches=batches(ITERS, b=4), work_dir=str(tmp / "work"),
                   eval_cfg=eval_cfg, iters=ITERS, more=MORE),
        evaluate=dict(config=cfg, checkpoint=ckpt),
        tiles=dict(generator=tw.SMALL, sd=sd, cases=tile_inputs()),
        gan=dict(model=model_cfg("gan", vgg), train_cfg=TRAIN_CFG["gan"],
                 opt=OPT, batches=gan_batches()))
    return worker.spawn(str(tmp), inputs), inputs


def same_tensors(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k, v in a.items():
        assert torch.equal(v, b[k]), k


# ------------------------------------------------------------- training --
def test_two_rank_training_matches_one_process_and_jax(ranks, jax_small):
    (r0, r1), inputs = ranks
    kw = inputs["train"]
    t0, t1 = r0["train"], r1["train"]
    losses = [[r["loss_pix"] for r in t["records"] if "loss_pix" in r]
              for t in (t0, t1)]
    assert len(losses[0]) == ITERS + MORE
    assert losses[0] == losses[1]                  # the same bits
    same_tensors(t0["weights"], t1["weights"])
    same_tensors(t0["resumed"], t1["resumed"])
    # the eval hook ran on both ranks and gathered the same summary
    vals = [[r["val_PSNR"] for r in t["records"] if "val_PSNR" in r]
            for t in (t0, t1)]
    assert len(vals[0]) == 2 and vals[0] == vals[1]
    assert np.isfinite(vals[0]).all()

    # one process at the global batch
    res = CiaoSRRestorer(tw.SMALL, device="cpu")
    res.generator.load_state_dict(kw["sd"], strict=True)
    work = kw["work_dir"] + "_one"
    one = Trainer(res, Config(TRAIN_CFG_DICT), work, auto_resume=False,
                  progress=lambda *_: None)
    one.run(kw["batches"], total_iters=ITERS)
    with open(os.path.join(work, "train_log.jsonl")) as f:
        ref = [json.loads(line)["loss_pix"] for line in f]
    for got, want in zip(losses[0], ref, strict=False):
        assert abs(got - want) <= LOSS_REL * abs(want), (got, want)
    for k, v in res.generator.state_dict().items():
        np.testing.assert_allclose(t0["weights"][k].numpy(), v.numpy(),
                                   atol=WEIGHT_TOL, rtol=0, err_msg=k)

    # the first step against JAX's make_train_step on the same batch
    jnet, params, _ = jax_small
    tx, _ = jax_optim.build_optimizer(dict(ADAM), LR_CFG)
    step = jax_trainer.make_train_step(JaxRestorer(tw.SMALL), tx)
    state = jax_trainer.TrainState(step=jnp.asarray(0), params=params,
                                   opt_state=tx.init(params))
    _, m = step(state, {k: jnp.asarray(v)
                        for k, v in kw["batches"][0].items()})
    assert abs(losses[0][0] - float(m["loss_pix"])) <= \
        JAX_REL * abs(float(m["loss_pix"]))

    # rank 0 alone wrote: one record a step (and one an eval), and the
    # checkpoints of both runs
    with open(os.path.join(kw["work_dir"], "train_log.jsonl")) as f:
        assert len(f.readlines()) == ITERS + MORE + 2
    assert sorted(os.listdir(os.path.join(kw["work_dir"], "checkpoints"))) \
        == [f"iter_{n}.pth" for n in (ITERS // 2, ITERS, ITERS + MORE)]


# ----------------------------------------------------------------- eval --
def test_ragged_eval_gathers_jax_summary(ranks, monkeypatch, tmp_path):
    (r0, r1), inputs = ranks
    kw = inputs["evaluate"]
    ref = jax_test_main(monkeypatch, [kw["config"], kw["checkpoint"],
                                      "--out", str(tmp_path / "jax.json")])
    for mode in ("strided", "tiles"):
        a, b = r0["evaluate"][mode], r1["evaluate"][mode]
        assert {k: v for k, v in a.items() if k != "elapsed_s"} == \
            {k: v for k, v in b.items() if k != "elapsed_s"}, mode
        assert a["n_images"] == ref["n_images"] == 3
        for k in ("PSNR", "SSIM"):
            assert abs(a[k] - ref[k]) <= EVAL_TOL, (mode, k, a[k], ref[k])


# ---------------------------------------------------------------- tiles --
@pytest.fixture(scope="module")
def oracles(jax_small):
    jnet, params, _ = jax_small
    return [jax_composition(jnet, params, lq, s, t, o)
            for lq, s, t, o, _ in tile_inputs()]


def test_sharded_tiles_match_jax_oracle(ranks, oracles):
    (r0, r1), _ = ranks
    for got0, got1, ref in zip(r0["tiles"], r1["tiles"], oracles,
                               strict=True):
        np.testing.assert_array_equal(got0, got1)
        assert got0.shape == ref.shape
        np.testing.assert_allclose(got0, ref, atol=TILE_TOL, rtol=0)


@pytest.mark.slow
def test_sharded_tiles_match_jax_sharded_predict_tiled(ranks, jax_small):
    """JAX's own ``predict_tiled`` under a 2-device mesh with the same
    ``tile_batch`` (its tile groups widened and sharded over the devices;
    its grid decode's CSA in Pallas interpret mode on the CPU) against the
    port's 2-rank sharded tiles."""
    from ciaosr_tpu.parallel.mesh import make_mesh
    (r0, _), _ = ranks
    _, params, _ = jax_small
    for (lq, s, t, o, tb), got in zip(tile_inputs(), r0["tiles"],
                                      strict=True):
        jres = JaxRestorer(tw.SMALL, test_cfg=dict(tile_batch=tb))
        ref = np.asarray(jres.predict_tiled(params, lq, s, tile=t,
                                            tile_overlap=o,
                                            mesh=make_mesh(2)))
        np.testing.assert_allclose(got, ref, atol=TILE_TOL, rtol=0)


def test_tile_batch_matches_jax_oracle(jax_small, oracles):
    _, _, sd = jax_small
    res = CiaoSRRestorer(tw.SMALL, device="cpu")
    res.generator.load_state_dict(sd, strict=True)
    for (lq, s, t, o, tb), ref in zip(tile_inputs(), oracles, strict=True):
        res.test_cfg = {"tile_batch": tb}
        np.testing.assert_allclose(res.predict_tiled(lq, s, t, o), ref,
                                   atol=TILE_TOL, rtol=0)


# ------------------------------------------------------------------ GAN --
def test_two_rank_gan_steps_match_one_process(ranks):
    (r0, r1), inputs = ranks
    kw = inputs["gan"]
    g0, g1 = r0["gan"], r1["gan"]
    for name in ("generator", "generator_ema", "discriminator"):
        same_tensors(g0[name], g1[name])
    assert any(k.endswith(".u") for k in g0["discriminator"])
    assert g0["losses"] == g1["losses"]

    res = RealCiaoSRRestorer(**kw["model"], train_cfg=kw["train_cfg"],
                             device="cpu")
    g_opt, g_sched = build_optimizer(res.generator.parameters(), kw["opt"])
    d_opt, d_sched = build_optimizer(res.discriminator.parameters(),
                                     kw["opt"])
    state = GANTrainState(0, g_opt, d_opt, g_sched, d_sched)
    step = res.make_gan_train_step(g_opt, d_opt, (g_sched, d_sched))
    for b, got in zip(kw["batches"], g0["losses"], strict=True):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        for k, v in m.items():
            assert abs(got[k] - float(v)) <= GAN_TOL * max(abs(float(v)),
                                                           1.0), k
    for name, mod in (("generator", res.generator),
                      ("generator_ema", res.generator_ema),
                      ("discriminator", res.discriminator)):
        for k, v in mod.state_dict().items():
            np.testing.assert_allclose(g0[name][k].numpy(), v.numpy(),
                                       atol=GAN_TOL, rtol=0,
                                       err_msg=f"{name}.{k}")


# ------------------------------------------------------ helpers and CLIs --
def test_shard_batch_rows_and_refusal():
    batch = {"lq": np.arange(12).reshape(6, 2), "meta": list("abcdef"),
             "scale": 4}
    got = shard_batch(Mesh(rank=1, world=3), batch)
    np.testing.assert_array_equal(got["lq"], batch["lq"][2:4])
    assert got["meta"] == ["c", "d"] and got["scale"] == 4
    assert shard_batch(Mesh(), batch) is batch
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(Mesh(rank=0, world=4), batch)


@pytest.fixture
def torchrun_env(monkeypatch):
    """torchrun's environment for one process; the store on a free port."""
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="localhost", MASTER_PORT="0").items():
        monkeypatch.setenv(k, v)


def test_eval_clis_under_the_pytorch_launcher(tmp_path_factory, tmp_path,
                                              torchrun_env):
    cfg, ckpt = make_case(tmp_path_factory.mktemp("cli"), nla=False)
    plain = port_test.main([cfg, ckpt, "--device", "cpu"])
    for extra in ([], ["--shard-tiles"]):
        got = port_test.main([cfg, ckpt, "--device", "cpu", "--launcher",
                              "pytorch", "--gpu-collect", "--tmpdir",
                              str(tmp_path)] + extra)
        assert not torch.distributed.is_initialized()
        assert {k: got[k] for k in ("PSNR", "SSIM", "n_images")} == \
            {k: plain[k] for k in ("PSNR", "SSIM", "n_images")}
    src = str(tmp_path / "lq.png")
    write_png(src, read_png(Config.fromfile(cfg).data["test"]["lq_folder"]
                            + "/im0.png"))
    outs = []
    for extra in ([], ["--launcher", "pytorch", "--shard-tiles"]):
        out = str(tmp_path / f"sr{len(outs)}.png")
        assert port_inference.main([cfg, ckpt, "--img", src, "--out", out,
                                    "--tile", "16", "--device", "cpu"]
                                   + extra) == [out]
        outs.append(read_png(out))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_launch_refuses_a_tensor_off_the_current_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="one process per GPU"):
        _build.stream_ptr(torch.device("cuda", 1))

    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda d: 1234 + d, raising=False)
    assert _build.stream_ptr(torch.device("cuda", 0)).value == 1234
