"""One rank of the port's 2-process gloo runs on the CPU, for
tests/test_torch_parallel.py (imports no JAX: the ranks are spawned, and
import only this module and the port).

``spawn(tmp, tasks)`` starts the ranks with ``torch.multiprocessing``'s
spawn context; they meet through a ``file://`` store in ``tmp`` (no port),
run every task of ``tasks`` (name → inputs) on their mesh in order, and
each saves {name: result} to ``tmp/rank_<r>.pt``.
"""

from __future__ import annotations

import os
import time
import traceback
from datetime import timedelta

import numpy as np
import torch

WORLD = 2
TIMEOUT_S = 240   # the whole spawn; one collective waits at most 60 s


def spawn(tmp: str, tasks: dict) -> list[dict]:
    """Each rank's results; raises if a rank fails or outlives the
    timeout (the ranks are killed then)."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, tmp, tasks))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = [open(os.path.join(tmp, f"rank_{r}.err")).read()
              for r in range(WORLD)
              if os.path.exists(os.path.join(tmp, f"rank_{r}.err"))]
    codes = [p.exitcode for p in procs]
    if errors or codes != [0] * WORLD:
        raise AssertionError(f"ranks ended with {codes} (None: killed at "
                             f"{TIMEOUT_S} s):\n" + "\n".join(errors))
    return [torch.load(os.path.join(tmp, f"rank_{r}.pt"),
                       weights_only=False) for r in range(WORLD)]


def rank_main(rank: int, tmp: str, tasks: dict) -> None:
    from ciaosr_torch.parallel.mesh import close_mesh, init_mesh

    torch.set_num_threads(2)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank))
    try:
        mesh = init_mesh("pytorch", device="cpu",
                         init_method=f"file://{tmp}/store",
                         timeout=timedelta(seconds=60))
        try:
            out = {name: TASKS[name](mesh, **kw) for name, kw in
                   tasks.items()}
        finally:
            close_mesh(mesh)
        torch.save(out, os.path.join(tmp, f"rank_{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank_{rank}.err"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise


def train(mesh, sd: dict, cfg: dict, batches: list, work_dir: str,
          eval_cfg: dict, iters: int, more: int) -> dict:
    """``iters`` Trainer steps from ``sd`` on the global ``batches`` with an
    eval hook at every ``iters // 2`` on ``eval_cfg``'s dataset, then a
    second Trainer that auto-resumes from the work_dir and runs ``more``
    steps: the logged records and the weights after each run."""
    from ciaosr_torch.config import Config
    from ciaosr_torch.data.datasets import build_dataset
    from ciaosr_torch.eval.evaluator import evaluate_dataset
    from ciaosr_torch.models.restorers import CiaoSRRestorer
    from ciaosr_torch.train.trainer import Trainer

    res = CiaoSRRestorer(cfg["generator"], test_cfg=cfg["test_cfg"],
                         device="cpu")
    res.generator.load_state_dict(sd, strict=True)
    ds = build_dataset(eval_cfg)
    out = {"records": []}

    def run(total, auto_resume):
        trainer = Trainer(res, Config(cfg["train"]), work_dir,
                          auto_resume=auto_resume, progress=_quiet,
                          mesh=mesh)
        log = trainer.logger.log

        def keep(step, metrics, extra=None):
            rec = log(step, metrics, extra)
            if rec is not None:
                out["records"].append(rec)
            return rec

        trainer.logger.log = keep
        trainer.run(batches, total_iters=total,
                    eval_fn=lambda: evaluate_dataset(res, ds, mesh=mesh),
                    eval_interval=iters // 2)
        return {k: v.clone() for k, v in res.generator.state_dict().items()}

    out["weights"] = run(iters, False)
    out["resumed"] = run(iters + more, True)
    return out


def evaluate(mesh, config: str, checkpoint: str) -> dict:
    """``config``'s test split through the eval CLI's restorer and weights:
    strided over the ranks and gathered, then with the tiles sharded."""
    from ciaosr_torch.config import Config
    from ciaosr_torch.data.datasets import build_dataset
    from ciaosr_torch.eval.evaluator import evaluate_dataset
    from ciaosr_torch.models.builder import build_model
    from ciaosr_torch.tools.test import load_weights

    cfg = Config.fromfile(config)
    model = build_model(cfg.model, test_cfg=cfg.test_cfg, device="cpu")
    load_weights(model, checkpoint, cfg)
    ds = build_dataset(cfg.data["test"])
    return {"strided": evaluate_dataset(model, ds, mesh=mesh),
            "tiles": evaluate_dataset(model, ds, mesh=mesh,
                                      shard_tiles=True)}


def tiles(mesh, generator: dict, sd: dict, cases: list) -> list:
    """``predict_tiled`` under the mesh for each (lq, scale, tile,
    overlap, tile_batch)."""
    from ciaosr_torch.models.restorers import CiaoSRRestorer

    res = CiaoSRRestorer(generator, device="cpu")
    res.generator.load_state_dict(sd, strict=True)
    outs = []
    for lq, scale, tile, overlap, tb in cases:
        res.test_cfg = {"tile_batch": tb}
        outs.append(res.predict_tiled(lq, scale, tile, overlap, mesh=mesh))
    return outs


def gan(mesh, model: dict, train_cfg: dict, opt: dict,
        batches: list) -> dict:
    """``make_gan_train_step`` on this rank's rows of each global batch:
    every step's losses (averaged over the ranks) and the modules'
    tensors after the last step."""
    from ciaosr_torch.models.real_restorer import (GANTrainState,
                                                   RealCiaoSRRestorer)
    from ciaosr_torch.parallel.mesh import all_reduce_sum_, shard_batch
    from ciaosr_torch.train.optim import build_optimizer

    res = RealCiaoSRRestorer(**model, train_cfg=train_cfg, device="cpu")
    g_opt, g_sched = build_optimizer(res.generator.parameters(), opt, None)
    d_opt, d_sched = build_optimizer(res.discriminator.parameters(), opt,
                                     None)
    state = GANTrainState(0, g_opt, d_opt, g_sched, d_sched)
    step = res.make_gan_train_step(g_opt, d_opt, (g_sched, d_sched), mesh)
    losses = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(np.ascontiguousarray(v))
                                for k, v in shard_batch(mesh, b).items()})
        losses.append({k: float(all_reduce_sum_(mesh, v.clone()))
                       / mesh.world for k, v in m.items()})
    return {"losses": losses, **{
        name: {k: v.clone() for k, v in mod.state_dict().items()}
        for name, mod in (("generator", res.generator),
                          ("generator_ema", res.generator_ema),
                          ("discriminator", res.discriminator))}}


def _quiet(*_) -> None:
    pass


TASKS = {"train": train, "evaluate": evaluate, "tiles": tiles, "gan": gan}
