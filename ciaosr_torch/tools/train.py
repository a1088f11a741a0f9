"""Training CLI, the port's twin of tools/train.py:

    python3 -m ciaosr_torch.tools.train CONFIG [--work-dir D]
        [--resume-from CKPT] [--no-auto-resume] [--seed N] [--deterministic]
        [--autoscale-lr] [--total-iters N] [--bf16] [--device cpu]

Training of a ``CiaoSR`` config (classical, L1: the ``Trainer`` loop) or
a ``RealCiaoSR`` config (real-world GAN: the ``GANTrainer`` loop, with the
staged ``load_from``): the config's train pipeline through the threaded
loader, the loop with its log, eval (``data.val`` every
``evaluation.interval``) and checkpoint hooks, auto-resume from the
work_dir's newest checkpoint. The run writes ``config_dump.py``,
``env.json``, ``train_log.jsonl`` and ``checkpoints/iter_N.pth`` under
the work_dir, which ``python3 -m ciaosr_torch.tools.test CONFIG
WORK_DIR`` evaluates. The model runs on the CUDA device through the
port's kernels unless ``--device cpu`` asks for the plain PyTorch path.
``BasicRestorer`` configs are not ported yet and raise. Both shipped 002
configs train as they are (their train pipelines run the degradation
chain of ``ciaosr_torch.data.degradations`` in the loader's workers).
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import random

import numpy as np
import torch

from ciaosr_torch.config.config import Config
from ciaosr_torch.data.datasets import build_dataset
from ciaosr_torch.data.loader import build_dataloader
from ciaosr_torch.eval.evaluator import evaluate_dataset
from ciaosr_torch.models.builder import build_model
from ciaosr_torch.train.gan_trainer import GANTrainer
from ciaosr_torch.train.trainer import Trainer

# the processes of one run, each training on one device: several GPUs are
# not ported yet (ROADMAP queue 1 item 8(b))
N_DEVICES = 1


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ciaosr_torch train")
    p.add_argument("config")
    p.add_argument("--work-dir", help="override config work_dir")
    p.add_argument("--resume-from", help="a training work_dir, its "
                   "checkpoints dir or one checkpoint file to resume from")
    p.add_argument("--no-auto-resume", action="store_true",
                   help="disable auto-resume from the work_dir's newest "
                        "checkpoint")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--deterministic", action="store_true",
                   help="seed Python, numpy and torch and make cuDNN and "
                        "every op that has a deterministic implementation "
                        "use it (the others warn), for the run")
    p.add_argument("--autoscale-lr", action="store_true",
                   help="linear LR scaling: lr x (devices trained on) / 8")
    p.add_argument("--total-iters", type=int, default=None,
                   help="override config total_iters")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute (f32 params): generator dtype 'bf16'")
    p.add_argument("--launcher", default="none", choices=["none"],
                   help="one process; several GPUs are not ported yet")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; 'cpu' "
                        "runs the plain PyTorch path)")
    return p.parse_args(argv)


def environment(device: torch.device) -> dict:
    """The run's environment record (env.json)."""
    cuda = device.type == "cuda"
    return {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": str(device),
        "devices": [torch.cuda.get_device_name(device) if cuda else "cpu"],
        "n_devices": N_DEVICES,
    }


def main(argv=None) -> Trainer:
    args = parse_args(argv)
    if not args.deterministic:
        return train(args)
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    # cuBLAS is deterministic on one stream only with a fixed workspace
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # an op with a deterministic implementation takes it (the per-query
    # decoder's gather backward sums in a fixed order); one without warns
    # and runs as it is, so that no config stops at its first backward
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return train(args)
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = saved[2:]


def train(args) -> Trainer:
    """The run of parsed ``args`` (``main``'s, after its seeding)."""
    cfg = Config.fromfile(args.config)
    work_dir = args.work_dir or cfg.work_dir
    os.makedirs(work_dir, exist_ok=True)
    with open(os.path.join(work_dir, "config_dump.py"), "w") as f:
        f.write(cfg.text)

    if args.autoscale_lr:
        if "lr" not in cfg.optimizers:
            # the JAX CLI reads the same flat key and has no rule for
            # per-module optimizers either
            raise ValueError(
                "--autoscale-lr scales the flat optimizers['lr']; this "
                "config has per-module optimizers "
                f"({sorted(cfg.optimizers)}), for which no scaling rule "
                "is defined")
        cfg.optimizers = dict(cfg.optimizers,
                              lr=cfg.optimizers["lr"] * N_DEVICES / 8)
    if args.bf16:
        cfg.model = dict(cfg.model, generator=dict(cfg.model["generator"],
                                                   dtype="bf16"))
    model = build_model(cfg.model, train_cfg=cfg.get("train_cfg"),
                        test_cfg=cfg.get("test_cfg"), device=args.device,
                        seed=args.seed)

    env = environment(model.device)
    print("Environment:", env, flush=True)
    with open(os.path.join(work_dir, "env.json"), "w") as f:
        json.dump(env, f, indent=2)

    train_ds = build_dataset(cfg.data["train"])
    loader_cfg = cfg.data.get("train_dataloader") or {}
    loader = build_dataloader(
        train_ds, samples_per_gpu=loader_cfg.get("samples_per_gpu", 16),
        workers_per_gpu=cfg.data.get("workers_per_gpu", 4),
        worker_mode=cfg.data.get("worker_mode", "thread"), seed=args.seed)

    eval_fn = None
    eval_interval = (cfg.get("evaluation") or {}).get("interval")
    if "val" in cfg.data:
        val_ds = build_dataset(cfg.data["val"])

        def eval_fn():
            return evaluate_dataset(model, val_ds)

    mtype = cfg.model["type"]
    cls = GANTrainer if (mtype if isinstance(mtype, str)
                         else mtype.__name__) == "RealCiaoSR" else Trainer
    trainer = cls(restorer=model, cfg=cfg, work_dir=work_dir,
                  resume_from=args.resume_from,
                  auto_resume=not args.no_auto_resume)
    trainer.run(loader, total_iters=args.total_iters or cfg.total_iters,
                eval_fn=eval_fn, eval_interval=eval_interval)
    return trainer


if __name__ == "__main__":
    main()
