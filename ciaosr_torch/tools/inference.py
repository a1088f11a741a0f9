"""Single-image / folder SR inference CLI, the port's twin of
tools/inference.py:

    python3 -m ciaosr_torch.tools.inference CONFIG CHECKPOINT --img LQ.png
        --scale 4 [--out SR.png] [--tile 192] [--tile-overlap 32]
        [--device cpu] [--launcher {none,pytorch}] [--shard-tiles]

CHECKPOINT is handled as by ``ciaosr_torch.tools.test``. An integer scale
on an image larger than the tile runs the overlap-average tiling; any
other scale (integer or not) a full-image ``predict`` at
round(H·s) × round(W·s). A ``BasicRestorer`` config upscales by its
generator's own factor, full-image only: ``--tile 0``, or an image that
fits in the tile (a larger one raises). Without OpenCV the images are
PNG files. Under ``--launcher pytorch`` (one process per GPU, started by
``python3 -m torch.distributed.run``) every rank upscales every image,
``--shard-tiles`` shards the tiles over the ranks, and rank 0 writes.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ciaosr_torch.config.config import Config
from ciaosr_torch.data.imageio import imread, imwrite
from ciaosr_torch.models.builder import build_model
from ciaosr_torch.parallel.mesh import (add_launcher_args, close_mesh,
                                        mesh_from_args)
from ciaosr_torch.tools.test import load_weights

_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ciaosr_torch single-image SR")
    p.add_argument("config")
    p.add_argument("checkpoint", help=".pth/.pt file, 'None' (config "
                   "test_checkpoint_path), or 'random' (smoke)")
    p.add_argument("--img", required=True,
                   help="LQ image file, or a directory of images")
    p.add_argument("--out", help="output file (or directory for --img DIR; "
                   "default: <input>_x<scale>.png)")
    p.add_argument("--scale", type=float, default=4.0,
                   help="upscaling factor (non-integer allowed)")
    p.add_argument("--tile", type=int, default=192,
                   help="LR tile size for integer scales (0 = untiled)")
    p.add_argument("--tile-overlap", type=int, default=32)
    p.add_argument("--shard-tiles", action="store_true",
                   help="shard each image's tiles over the ranks (with one "
                        "process it changes nothing)")
    add_launcher_args(p)
    p.add_argument("--pallas", action="store_true",
                   help="accepted for parity with the JAX CLI and changes "
                        "nothing: on a CUDA device the port always runs "
                        "its kernels")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; 'cpu' "
                        "runs the plain PyTorch path)")
    return p.parse_args(argv)


def _iter_images(path):
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            if name.lower().endswith(_EXTS):
                yield os.path.join(path, name)
    else:
        yield path


def main(argv=None) -> list[str]:
    """Upscale each image; returns the paths written (rank 0's)."""
    args = parse_args(argv)
    mesh = mesh_from_args(args)
    try:
        return upscale(args, mesh)
    finally:
        close_mesh(mesh)


def upscale(args, mesh) -> list[str]:
    """The images of parsed ``args`` on this process's ``mesh``."""
    cfg = Config.fromfile(args.config)
    model = build_model(cfg.model, test_cfg=cfg.get("test_cfg"),
                        device=mesh.device)
    load_weights(model, args.checkpoint, cfg)

    scale = args.scale
    int_scale = scale == int(scale)
    out_dir_mode = os.path.isdir(args.img)
    if out_dir_mode and args.out and mesh.is_main:
        os.makedirs(args.out, exist_ok=True)

    # every rank lists the images before rank 0 writes next to them
    images = list(_iter_images(args.img))
    mesh.barrier()
    written = []
    for path in images:
        lq = imread(path).astype(np.float32) / 255.0
        h, w = lq.shape[:2]
        if int_scale and args.tile and (h > args.tile or w > args.tile):
            if not hasattr(model, "predict_tiled"):
                raise ValueError(
                    f"{type(model).__name__} has no tiled predict: a "
                    f"{h}x{w} image exceeds --tile {args.tile}; run with "
                    "--tile 0 for a full-image predict")
            sr = model.predict_tiled(lq, int(scale), args.tile,
                                     args.tile_overlap,
                                     mesh=mesh if args.shard_tiles else None)
        else:
            sr = model.predict(lq, (int(round(h * scale)),
                                    int(round(w * scale))))
        if not mesh.is_main:
            continue
        sr8 = np.clip(np.asarray(sr) * 255.0 + 0.5, 0, 255).astype(np.uint8)
        if args.out:
            out = (os.path.join(args.out, os.path.basename(path))
                   if out_dir_mode else args.out)
        else:
            stem, _ = os.path.splitext(path)
            tag = int(scale) if int_scale else scale
            out = f"{stem}_x{tag}.png"
        imwrite(out, sr8)
        written.append(out)
        print(f"{path} ({h}x{w}) -> {out} ({sr8.shape[0]}x{sr8.shape[1]})",
              flush=True)
    return written


if __name__ == "__main__":
    main()
