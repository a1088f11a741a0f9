"""Evaluation CLI, the port's twin of tools/test.py:

    python3 -m ciaosr_torch.tools.test CONFIG CHECKPOINT [--out M.json]
        [--save-path DIR] [--split {test,val}] [--device cpu]
        [--launcher {none,pytorch}] [--shard-tiles]

CHECKPOINT is a reference ``.pth`` / ``.pt`` file (the mmcv meta dict, a
full restorer checkpoint or a raw SwinIR-family one); a training run of
``ciaosr_torch.tools.train``: its work_dir, its ``checkpoints``
directory, one of its ``iter_N.pth`` files or ``<work_dir>/latest`` (the
newest checkpoint); ``None`` (the config's ``test_checkpoint_path``,
``<work_dir>/latest`` in the shipped configs); or ``random`` (seeded
random weights, a smoke run). The model runs on the CUDA device through the port's
kernels unless ``--device cpu`` asks for the plain PyTorch path.

On N GPUs, one process each (``python3 -m torch.distributed.run
--standalone --nproc_per_node N -m ciaosr_torch.tools.test ...
--launcher pytorch``), the images are strided over the ranks and their
metrics gathered; with ``--shard-tiles`` every rank takes every image and
the tiles of each are sharded over the ranks. Rank 0 prints and writes
``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import random

import numpy as np
import torch

from ciaosr_torch.config.config import Config
from ciaosr_torch.data.datasets import build_dataset
from ciaosr_torch.eval.evaluator import evaluate_dataset
from ciaosr_torch.models.builder import build_model
from ciaosr_torch.parallel.mesh import (add_launcher_args, close_mesh,
                                        mesh_from_args)
from ciaosr_torch.train.checkpoint import (load_staged_generator,
                                           resolve_checkpoint)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ciaosr_torch test")
    p.add_argument("config")
    p.add_argument("checkpoint", help=".pth/.pt file; a training work_dir, "
                   "its checkpoints dir or <work_dir>/latest (the newest "
                   "checkpoint); 'None' (config test_checkpoint_path); or "
                   "'random' (smoke)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--deterministic", action="store_true",
                   help="seed Python, numpy and torch (0 without --seed) "
                        "and make cuDNN pick deterministic algorithms")
    p.add_argument("--out", help="write metrics JSON here")
    p.add_argument("--save-path", help="save predicted PNGs here")
    add_launcher_args(p)
    p.add_argument("--gpu-collect", action="store_true",
                   help="accepted for reference-CLI parity; the results "
                        "are always gathered by a collective")
    p.add_argument("--tmpdir", help="accepted for reference-CLI parity; "
                   "unused")
    p.add_argument("--split", default="test", choices=["test", "val"])
    p.add_argument("--shard-tiles", action="store_true",
                   help="shard each image's tiles over the ranks (with one "
                        "process it changes nothing)")
    p.add_argument("--pallas", action="store_true",
                   help="accepted for parity with the JAX CLI and changes "
                        "nothing: on a CUDA device the port always runs "
                        "its kernels")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; 'cpu' "
                        "runs the plain PyTorch path)")
    return p.parse_args(argv)


def load_weights(restorer, checkpoint: str, cfg) -> None:
    """Put ``checkpoint``'s weights into ``restorer``'s generator, as the
    JAX CLI resolves it: 'None' means the config's
    ``test_checkpoint_path``, 'random' keeps the seeded random weights, a
    training run's work_dir, checkpoints dir or ``latest`` is its newest
    checkpoint (train/checkpoint.py), and a ``.pth`` / ``.pt`` file is
    loaded (convert/load.py). A ``RealCiaoSR`` restorer's EMA copy, which
    its ``forward_test`` evaluates with ``is_use_ema``, takes the file's
    ``generator_ema.`` tensors (the generator's where it has none)."""
    ckpt = cfg.get("test_checkpoint_path") if checkpoint == "None" \
        else checkpoint
    if ckpt == "random":
        print("[warn] evaluating RANDOM weights (smoke mode)", flush=True)
        return
    if not os.path.isfile(ckpt):
        try:
            ckpt = resolve_checkpoint(ckpt)
        except FileNotFoundError as e:
            raise ValueError(
                f"checkpoint {ckpt!r}: no .pth/.pt file and no training run "
                "of the port there (an orbax directory is the JAX "
                "package's training format)") from e
        print(f"[ckpt] {ckpt}", flush=True)
    elif not str(ckpt).endswith((".pth", ".pt")):
        raise ValueError(
            f"checkpoint {ckpt!r}: the port loads .pth/.pt files and its "
            "own training runs; an orbax checkpoint is the JAX package's "
            "training format")
    gen, ema_sd = load_staged_generator(ckpt, cfg.model)
    restorer.generator.load_state_dict(gen, strict=True)
    ema = getattr(restorer, "generator_ema", None)
    if ema is not None:
        ema.load_state_dict(ema_sd, strict=True)
        print("[ckpt] EMA copy from " + (
            "the generator (the file has no EMA copy)" if ema_sd is gen
            else "generator_ema.*"), flush=True)


def main(argv=None) -> dict:
    args = parse_args(argv)
    mesh = mesh_from_args(args)
    try:
        return evaluate(args, mesh)
    finally:
        close_mesh(mesh)


def evaluate(args, mesh) -> dict:
    """The eval of parsed ``args`` on this process's ``mesh``."""
    cfg = Config.fromfile(args.config)
    seed = args.seed or 0
    if args.seed is not None or args.deterministic:
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)
    if args.deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

    dataset = build_dataset(cfg.data[args.split])
    model = build_model(cfg.model, test_cfg=cfg.test_cfg,
                        device=mesh.device, seed=seed)
    load_weights(model, args.checkpoint, cfg)
    results = evaluate_dataset(model, dataset, save_path=args.save_path,
                               mesh=mesh, shard_tiles=args.shard_tiles)
    if not mesh.is_main:
        return results
    print("Eval results:")
    for k, v in results.items():
        print(f"  {k}: {v:.4f}" if isinstance(v, float) else f"  {k}: {v}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
