#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ciaosr_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It
  1. prints the card (torch and nvidia-smi: name, power limit);
  2. builds the CUDA kernels from ciaosr_torch/csrc with nvcc; checks the
     host code this machine runs without OpenCV, Pillow or tensorboard:
     the native MATLAB bicubic (native/bicubic.cpp built with g++, taken
     by ``imresize_np`` by default, within 1e-6 of its numpy path, both
     timed) and ``RandomDownSampling(backend="pillow")``;
  3. holds each kernel (bf16) against its plain PyTorch version (f32, same
     inputs) at the flagship shapes (the decode kernel's rational mode at
     ×2.5 on a 192 tile: 25 phases of 96²; its integer mode once more at
     the odd-width request's shapes; the CSA kernels of rows 5-8 at the
     geometries of the CSA paths below), max|Δ|/max|ref| ≤ 1e-2 (the
     decode kernel's rows, both modes, K2's and row 8's also the same bits
     on two launches; K2's wt and ck each; row 5 the same bits as K4;
     row 8's paste alone ≤ 1e-6), and times both with CUDA events
     (median of several runs
     after warm-up),
     next to the roofline bound and, where one PyTorch call computes the
     same function, that call's time;
  4. drives the flagship RDN-CiaoSR restorer (config 001 rdn, bf16
     compute, seeded random weights, full width) through the kernel
     route, path by path, with every launch counter set to 0 just before
     each path and read just after: ×4 (predict_tiled of a 256×256 image,
     192 tiles, overlap 32: 4 tiles, and two single-tile grid_predict
     requests); rational (predict_tiled at ×2.5 and ×7/3, a full-image
     ×2.5 predict); the per-query decoder (a target with more than 4096
     phases); an odd width at ×4; then the CSA geometries where the JAX
     package picks another CSA kernel than K4's counterpart (Set5-shaped
     predict_tiled at ×4 and ×2.5: csa_attention; full-image predict at
     192×512 and 40×1024: csa_fused; at 48×1024: csa_stencil). It checks
     each output and which kernels each path ran, and holds the kernel
     route against the plain f32 route on small inputs at ×4, ×2.5, ×7/3,
     the odd width and three streaming CSA geometries;
  5. times the full-image requests warm;
  6. the SwinIR-CiaoSR generator of the 002 configs (180 channels, 6 × 6
     Swin blocks, no CSA; bf16, seeded random weights, full width and
     depth): the Swin block kernel (row 11, a shifted and an unshifted
     block on a 256² tile's tokens and on the 70² request's 72² tile, y
     and the increment y - x, reproducible) and the decode kernels at
     C = 180 held against their plain versions; ``forward_test`` at ×4
     with tile 256, overlap 32 on a 384² image (4 tiles), on a 70² image
     (one tile), and the 70² image at ×2.5, each with its exact launch
     counts (the Swin block 36 × tiles, K1-K3 once per tile, no CSA
     kernel); the kernel route against the plain f32 route on 48² and 70²
     at ×4; then config 001 swinir (SwinIR-CiaoSR with CSA: Cr = 90,
     C = 180, zero-padded to the kernels' 96 and 192; bf16, seeded random
     weights, full width and depth): K4 and row 7 at (Cr, C) = (96, 192),
     K1, K2 and K3 at (C, DC) = (192, 192) (K3 also at the 70² request's odd
     width; its rational mode, row 10, at ×2.5 on the 192² tile and on
     72²), and rows 6 and 5 on the 192×512 and 48×1024 full images (the
     wide pair over row blocks of at most 2 GiB of scores; row 6 also at 1
     GiB and in one block, the same bits) held against their plain
     versions at the real widths; ``forward_test`` of its own test_cfg
     (×4, tile 192, overlap 32) on the five Set5 ×4 LR shapes and on a
     256² image (4 tiles), each with its exact launch counts; then its
     other protocols, each request with the launches its tiling, CSA
     route and block plan give, its peak memory and its output against
     the plain f32 route: ×2.5 through the same test_cfg (256², 72²), ×6
     with the config's test_cfg for val_scale > 4 (no tile: full-image
     ``predict``, 85² and 170×128), full-image ×4 ``predict`` of 192×512
     (row 6) and 48×1024 (row 5); its kernel route against its plain f32
     route (a 192² tile's encoder, CSA and output, the 72² request); then
     config 001 edsr (EDSR-CiaoSR, C = 64, 16 blocks, CSA; bf16, seeded
     random weights, full width and depth) through its test_cfg (tile
     192, overlap 32 up to ×4, no tile above), as shipped (×4 on 256², the
     Set5 ×4 shapes 72² and 57×86, ×2.5 on 256², ×6 on 85²: the
     flagship's kernels) and without the unfold (feat_unfold=False: ×4 on
     256², ×4 on 60×47, ×2.5 on 256² and 72², and one f32-model request on
     a 192² tile: the one-tap instances of K1, K2, K3, row 9 and row 10,
     each also held against its plain version; K1 also the same bits on
     two launches, and its device time by torch.profiler beside its
     batched event time and its matmul's), every request with its
     exact launches and against the plain f32 route; then phase
     swinir_u1, the SwinIR generators without the unfold (the 002
     generator and config 001 swinir's, full width and depth, bf16): the
     one-tap instances at C = 192 (K1, K2 and K3 at (C, DC) = (192, 0) and
     (192, 192), row 9 at 47², row 10 at x2.5) held against their plain
     versions at 180 channels (K1 as at C = 64: same bits, device time),
     and ``forward_test`` through each config's
     test_cfg (002: x4 and x2.5 on 384², 4 tiles of 256; 001: x4 and x2.5
     on 256², 4 tiles of 192, x4 on 60 x 47), each with its exact
     launches and against the plain f32 route; f32
     models (no dtype in their config, as every shipped config) through
     their kernels against their plain f32 route: a flagship ×4 192² tile,
     the SwinIR 70² request and the 001 swinir 72² request at ×4 and
     ×2.5; the stage
     breakdown of one 256 tile and the warm time of the 384² request; then
     the ``time_kernels`` line: K1 and K3 at all three widths, K3 at the
     odd widths, row 7 and K4 at both, row 6, row 11 (shifted and
     unshifted, and at the training batch's shape) (the kernels redesigned
     for Hopper), K3's rational mode at both of its widths, rows 5, 8 and
     12, the one-tap instances, and one tile of each generator (the
     flagship's and edsr_u1's also at ×2.5);
  7. trains that generator as the 002 recipe does (batch 6 of 64² LR
     patches, 4096 queries a sample, Adam 2e-4, betas (0.9, 0.99), the
     classical L1 objective): the Swin block (row 11, ``swin_block@
     6x64x64``) and its backward (row 12), shifted and unshifted, on the
     batch's tokens, held against their f32 plain versions (row 12: against
     autograd) and checked reproducible, row 12's sum kernel also timed
     against ``pw.sum(0)`` and ``pd.sum(0)`` on its partials (and in
     alternation, 5 rounds each, at 6×64×64 and 10×48×48); 5 steps of
     ``make_train_step`` with exact launch counts (rows 11 and 12 and its
     two reduction kernels 36 times a step, nothing else), finite losses
     and every parameter with a gradient changed; the warm step time,
     samples/s, a stage split and the peak memory; one step's gradients,
     kernel route against the plain f32 route, on a small batch;
  8. phase "cli", the eval entry points as a user runs them: a
     Set5-shaped folder (seeded smooth GTmod12 pictures of Set5's shapes,
     LRbicx4 by the port's MATLAB bicubic, PNGs by the port's codec) in a
     temporary working directory and, for each shipped 001 config (rdn,
     edsr, swinir; f32 params, its own test_cfg), a ``.pth`` of a seeded
     generator (mmcv meta dict, EMA copy and discriminator beside it):
     ``ciaosr_torch.tools.test``'s ``main`` with exact launches, its PSNR
     and SSIM equal (≤ 1e-6) to the same restorer's (the .pth loaded
     strictly) on the same samples, whose outputs hold to the plain f32
     route; the flagship's command again as a shell command; and
     ``ciaosr_torch.tools.inference`` on the 57×86 LR image at ×4 (tiled)
     and ×2.5, each PNG within one level of ``forward_test``. Its launches
     add to the kernel rows (``launches_cli``);
  9. phase "train_cli", classical training through
     ``ciaosr_torch.tools.train`` on seeded DIV2K- and Set5-shaped
     folders in a temporary working directory, the shipped 001 configs
     (f32 params) unchanged but for one derived copy of 001 rdn's with
     checkpoints and evals every 2 iterations and a log line every one:
     001 rdn trains 4 iterations (evals at 2 and 4 with exact launches,
     checkpoints at 2 and 4), then again to 6, auto-resumed at 4 with the
     step, lr and Adam state saved, and ``ciaosr_torch.tools.test`` on the
     work_dir gives the PSNR and SSIM (≤ 1e-6) of a restorer loaded from
     the newest checkpoint; 001 swinir trains 3 iterations at its batch of
     10 × 48² (rows 11 and 12 first held against their plain versions at
     those tokens, shifted and unshifted, and timed: rows
     ``swin_block@10x48x48``, ``swin_block_bwd@10x48x48``,
     ``swin_block_wgrad@10x48x48``), with exactly 36 × 3 launches of rows
     11 and 12 and both reduction kernels and no other; 001 edsr trains 2
     iterations under ``--deterministic``, no kernel; 001 rdn's ``tb/``
     TensorBoard events read back by the port's reader equal to its JSONL
     means; finite losses and every parameter with a
     gradient changed; per config the warm time an iteration, samples/s,
     the peak memory, the loader's share of the loop and the loader alone
     (batches/s); one step's gradients of 001 swinir's generator, kernel
     route against the plain f32 route. Its launches add to the kernel
     rows (``launches_train_cli``);
 10. phase "gan", the real-world GAN stack of the 002 configs (the
     generator, its EMA copy, the UNet-SN discriminator, VGG19 perceptual
     and vanilla GAN losses; f32 params, the kernel route, VGG19 on the
     explicit synthetic opt-in): 5 GAN steps of the shipped gan model at
     the 002 batch with exact launches (rows 11 and 12 and both reduction
     kernels 36 times a step), the warm step, samples/s, peak memory and
     the stage split (G forward + backward, its optimizer, the D step,
     the EMA update; VGG19 alone); one G step's gradients, kernel route
     against the plain f32 route; stage 1 (wogan, 2 iterations) and stage
     2 (GAN, load_from stage 1: 4 iterations straight, and 2 then resumed
     to 4, bit-equal) through ``ciaosr_torch.tools.train`` on config
     copies with a fixed crop; ``ciaosr_torch.tools.test`` on the
     stage-1 work_dir (×4, tile 128) on the Set5-shaped folder, its
     outputs those of the EMA copy's own ``forward_test``; part
     gan_shipped: both shipped configs through ``tools.train`` with their
     own train pipeline (the degradation chain) and loader (6 forked
     workers), 6 iterations each, exact launches, finite losses, every
     parameter with a gradient changed, the warm iteration, the loader's
     wait share, the loader alone and the chain's per-op times. Its
     launches add to the kernel rows (``launches_gan``);
 11. phase "basic", the fixed-scale BasicRestorer (EDSRNet, RDNNet) as a
     user runs it, f32 with TF32 off, on seeded Set5- and DIV2K-shaped
     folders in a temporary working directory and two configs modelled on
     the 001 ones (RDN's published ×4 net; EDSR's at ×3 with a window of
     8, so the reflect pad runs): ``tools.test`` with random weights on
     each (finite PSNR and SSIM, equal to the same restorer's), the warm
     ms a picture, MP/s and peak memory beside the f32 bound, the card
     against the CPU on one picture (≤ 1e-4 relative), a profile by
     kernel; ``tools.inference --tile 0`` (the PNG's size) and ``--tile
     192`` on a larger picture (its ValueError); ``tools.train
     --deterministic`` on the rdn config (batch 16 of 48² LR, 6
     iterations, checkpoints at 3 and 6): finite losses, every parameter
     changed, ``iter_6.pth`` loaded strictly, ``tools.test`` on the
     work_dir equal to the trained restorer in memory and its outputs bit
     for bit, the iteration, a warm step, the loader's share and peak
     memory; NIQE and the matting metrics in a Python where ``import
     cv2`` fails. No launch count moves in any of it;
 12. phase "aux", the JAX package's last public pieces in the port, plain
     PyTorch on the card, f32 with TF32 off: ``imresize_torch`` (the
     MATLAB bicubic on the device) of a seeded 256² RGB picture at ×1/4,
     ×1/3 and ×2.5 against the same call on the CPU (max|Δ| ≤ 1e-5) and
     ``imresize_np`` (≤ 1e-4); ``grid_sample_nearest`` on a (2, 192, 192,
     64) map at 4096 queries, exact half-pixel ties and coords off the map
     among them, the same bits as the CPU and ``F.grid_sample``; a
     ``PosMLPRefiner`` and a registry-built ``MLPRefiner`` (act sin) on
     (16, 4096, 64) against the same weights on the CPU (max|Δ|/max|ref| ≤
     1e-5); every generator config of configs/ with its encoder from
     ``BACKBONES`` on the meta device, its parameter shapes those of the
     encoder's class. Each with its warm ms; no launch count moves;
 13. phase "dist", several GPUs (ciaosr_torch/parallel/mesh.py) as one
     card allows: (c) the flagship's predict_tiled of the 256² picture at
     ×4 and ×2.5 with tile_batch 1, 2 and 4 in this process (exact
     launches a tile group, each picture within 1e-2 max|Δ|/max|ref| of
     tile_batch 1's, K1, K2, K3, row 10 and K4 at B = 2 and 4 against
     their plain versions at ≤ 1e-2, the ms a tile split into host and
     device time, the peak memory); then, each part its own command
     (``--dist-worker`` under ``python3 -m torch.distributed.run
     --standalone``, on seeded DIV2K-, Set5- and DF2K-shaped folders in a
     temporary working directory): (a) one rank over NCCL, against the
     same command without a launcher, bit for bit: ``tools.train`` on 001
     rdn (batch 16 × 48², 4 iterations, --deterministic; its losses,
     evals and weights) and ``tools.test --shard-tiles`` (its summary);
     (b) two ranks sharing cuda:0 over gloo: the same training at 8
     samples a rank (both ranks' weights bit for bit; losses ≤ 1e-4
     relative and weights ≤ 4·lr from one process at 16), ``tools.test``
     of the 5 pictures strided and gathered (both ranks' summaries equal,
     ≤ 1e-6 from one process), the flagship's predict_tiled at tile_batch
     4 (both ranks bit for bit, ≤ 1e-2 from tile_batch 1) and the shipped
     002 gan config for 2 iterations at a global batch of 6 (its
     degradation chain and forked workers, VGG19 synthetic; generator,
     EMA copy and discriminator bit for bit on both ranks); every command
     with its exact launches, its iterations and each rank's peak memory.
     Its launches add to the kernel rows (``launches_dist``);
 14. prints the script's total time, the kernels line (each row with its
     achieved TFLOP/s: the function's own FLOPs over its time), the card
     line, and the result line last.
The f32 references run with TF32 off in matmuls and cuDNN.
``python3 chip_smoke.py --full-image`` builds the kernels and only times
the full-image requests; ``--kernel-times`` builds them and only prints
the ``time_kernels`` line; ``--train-cli`` builds them and only runs
phase "train_cli"; ``--gan`` builds them and only runs phase "gan";
``--basic`` only runs phase "basic", without a build; ``--aux`` only
runs phase "aux", without a build; ``--dist`` builds
them and only runs phase "dist" (none prints a result line). Copied into
another checkout (e.g. the parent commit from ``git archive``), either
times that tree the same way, in the same call.
Any failure exits non-zero. Without CUDA, or without the repository's
ciaosr_torch next to it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from fractions import Fraction
from pathlib import Path

import numpy as np
import torch

try:
    from ciaosr_torch.config import Config
except ImportError as e:
    sys.exit(f"chip_smoke: cannot import the port ({e}); run from the "
             "repository root")

# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
REL_TOL = 1e-2
BATCH = 10  # calls a timing sample spans where one call is under 1 ms

# the generators of the shipped configs, read by the port's Config.fromfile,
# on the kernel route in bf16
KERNEL_ROUTE = dict(dtype="bf16", use_kernels=True)


def config_path(prefix: str) -> str:
    """The one file configs/{prefix}*.py of this checkout."""
    (path,) = (Path(__file__).resolve().parent / "configs").glob(
        prefix + "*.py")
    return str(path)


def config_generator(prefix: str) -> dict:
    """The ``generator`` dict of configs/{prefix}*.py on the kernel route."""
    return dict(Config.fromfile(config_path(prefix)).model["generator"],
                **KERNEL_ROUTE)


# config 001 rdn: RDN-CiaoSR, C = 64, 16 RDBs, imnet [256]x4, CSA at scale 2
FLAGSHIP = config_generator("001_localimplicitsr_rdn_")
# the main path's request: an IMG × IMG image in TILE × TILE LR tiles
IMG, TILE, OVERLAP = 256, 192, 32
# LR shapes of the smaller requests (H, W). Each CSA geometry is one
# where the JAX package's fused_admission (ciaosr_tpu/models/csa.py)
# picks csa_stencil_fused, K4's TPU counterpart: an even height and a
# (reflect-padded) width that is a multiple of 16. ODD's width, 47, pads
# to 48 in the CSA and keeps the decode at W % 8 != 0, where the TPU
# runs its stacked decode kernel instead of the halo one.
SMALL, FULL, ODD = (48, 48), (96, 80), (60, 47)
# The geometries where the JAX package picks another CSA kernel than K4's
# counterpart. Set5-shaped images at ×4 are one square tile of their short
# side (72², 70², 57² → 58² in the CSA: widths not a multiple of 16), where
# it picks streaming (row 7, csa_attention). Full images of a seeded
# 192×1024 picture: 192×512 windowed, 40×1024 resident (both row 6,
# csa_fused), 48×1024 the two-kernel stencil (row 5, csa_stencil).
SET5 = ((72, 72), (70, 70), (57, 86))
CSA_FULL = (("windowed", (192, 512), "csa_fused"),
            ("resident", (40, 1024), "csa_fused"),
            ("stencil", (48, 1024), "csa_stencil"))
CSA_KERNELS = ("csa_stencil_fused", "csa_stencil", "csa_fused",
               "csa_attention", "csa_attention_overlap_add",
               "plane_overlap_add")
TEST_CFG = dict(metrics=["PSNR", "SSIM"], crop_border=4, scale=4, tile=TILE,
                tile_overlap=32, convert_to="y")
RGB_MEAN = (0.4488, 0.4371, 0.4040)
# the generator of configs/002_real_{gan,wogan}_localimplicitsr_swinir_*:
# SwinIR-CiaoSR without CSA. Its published eval: x4, tile 256, overlap 32.
SWIN_002 = config_generator("002_real_wogan_localimplicitsr_swinir_")
SWIN_TEST_CFG = dict(metrics=[], crop_border=4, scale=4, tile=256,
                     tile_overlap=32)
# the generator of configs/001_localimplicitsr_swinir_*: SwinIR-CiaoSR
# with CSA (Cr = 90, C = 180: the kernels run it zero-padded to 96 and
# 192). Its published eval (the config's test_cfg): x4, tile 192, overlap 32.
SWIN_001 = config_generator("001_localimplicitsr_swinir_")
SWIN_001_TEST_CFG = dict(metrics=[], crop_border=4, scale=4, tile=192,
                         tile_overlap=32)
# its requests: a SWIN_001_IMG² image (4 tiles of 192), and the five Set5
# x4 LR shapes (baby, bird, butterfly, head, woman) in two requests: those
# whose tiles have a width divisible by 8 (K3's halo mode) and the others
# (K3's odd-width mode, row 9), so that each mode's launches are counted.
# The tiling is the config's: tile = min(192, H, W), so 57 x 86 is three
# 57² tiles (columns 0, 25, 29) and the odd-width request four tiles. CSA
# routes: 192², 128² and 64² take K4, 72², 70² and 57² (58² in the CSA)
# row 7. Exact launches of each request:
SWIN_001_IMG, SWIN_001_TILE = 256, 192
SET5_X4_EVEN = ((128, 128), (72, 72), (64, 64))
SET5_X4_ODD = ((70, 70), (57, 86))
SWIN_001_LAUNCHES = {
    "set5": {"csa_stencil_fused": 2, "csa_attention": 1, "f3p_build": 3,
             "wt_hoist": 3, "grid_decode": 3, "swin_block": 36 * 3},
    "set5_odd": {"csa_attention": 4, "f3p_build": 4, "wt_hoist": 4,
                 "grid_decode": 4, "swin_block": 36 * 4},
    "x4": {"csa_stencil_fused": 4, "f3p_build": 4, "wt_hoist": 4,
           "grid_decode": 4, "swin_block": 36 * 4}}
# its other protocols, each request's launches computed from its tiling,
# csa_route and csa_stencil.wide_blocks (swin001_expected): the arbitrary
# scale x2.5 through the same test_cfg (the SWIN_001_IMG² image's tiles of
# 192: K4, K1, K2, row 10; the 72² Set5 tile: row 7, row 10); the
# config's protocol for val_scale > 4, whose test_cfg has no tile (a
# full-image predict): x6 on the Set5 x6 LR shape 85² (row 7, K3 at 36
# phases and an odd width) and the Urban100 x6 shape 170 x 128 (K4); and
# full-image x4 predicts of crops of the seeded 192 x 1024 picture on the
# wide pair over row blocks of at most 2 GiB of scores: 192 x 512 (row 6,
# 5 blocks) and 48 x 1024 (row 5, 2 blocks)
SWIN_001_X25 = ((SWIN_001_IMG, SWIN_001_IMG), SET5_X4_EVEN[1])
SWIN_001_X6_TEST_CFG = dict(metrics=[], crop_border=6, scale=6)
SWIN_001_X6 = ((85, 85), (170, 128))
SWIN_001_FULL = (((192, 512), "csa_fused"), ((48, 1024), "csa_stencil"))
# the CSA middle's kernel per csa_route mode
CSA_MODE_KERNEL = {"stencil_fused": "csa_stencil_fused",
                   "stencil": "csa_stencil", "resident": "csa_fused",
                   "windowed": "csa_fused", "streaming": "csa_attention"}
# the SwinIR requests: a SWIN_IMG² image in SWIN_TILE² tiles, one
# SWIN_ODD image (one tile; the encoder pads it to a window multiple), and
# the route checks' SWIN_SMALL and SWIN_ODD images
SWIN_IMG, SWIN_TILE, SWIN_SMALL, SWIN_ODD = 384, 256, (48, 48), (70, 70)
# the generator of configs/001_localimplicitsr_edsr_*: EDSR-CiaoSR at
# C = 64, 16 residual blocks, imnet [256]x4, CSA at scale 2, which the
# flagship's compiled kernels take as they are. Its test_cfg: x4 with tile
# 192, overlap 32 (val_scale <= 4), no tile above (a full-image predict).
EDSR_001 = config_generator("001_localimplicitsr_edsr_")
EDSR_TEST_CFG = dict(metrics=[], crop_border=4, scale=4, tile=192,
                     tile_overlap=32)
EDSR_X6_TEST_CFG = dict(metrics=[], crop_border=6, scale=6)
# the same generator without the unfold (feat_unfold=False, LIIF's "-u"
# ablation): keys, values and queries are the feature pixel, and K1, K2,
# K3 (row 9 at odd widths) and row 10 run their one-tap instances
EDSR_U1 = dict(EDSR_001, feat_unfold=False)
# their requests, (name, LR shape, scale, how): "tiled" is forward_test
# through the test_cfg, "full" a full-image predict (the x6 test_cfg, or
# the x4 odd-width request). Each takes the launches expected_launches
# counts: edsr x4 on 256² (4 tiles: K4, K1, K2, K3), the Set5 x4 LR
# shapes 72² (row 7, K3) and 57 x 86 (three 57² tiles: row 7, row 9),
# x2.5 on 256² (K4, row 10), x6 on the Set5 x6 LR shape 85² (row 7, row 9
# at 36 phases); edsr_u1 x4 on 256² (the one-tap K1, K2, K3), x4 on 60 x 47
# (K4 at 60 x 48, one-tap row 9), x2.5 on 256² and 72² (one-tap row 10)
EDSR_REQUESTS = (("x4", (256, 256), 4, "tiled"),
                 ("x4", (72, 72), 4, "tiled"),
                 ("x4", (57, 86), 4, "tiled"),
                 ("x2.5", (256, 256), 2.5, "tiled"),
                 ("x6", (85, 85), 6, "full"))
U1_REQUESTS = (("x4", (256, 256), 4, "tiled"),
               ("x4", (60, 47), 4, "full"),
               ("x2.5", (256, 256), 2.5, "tiled"),
               ("x2.5", (72, 72), 2.5, "tiled"))
# the SwinIR generators without the unfold (LIIF's "-u" ablation at 180
# channels): the 002 generator (one-tap K1, K2, K3 at (C, DC) = (192, 0))
# and config 001 swinir's (CSA at Cr = 90; one-tap K1, K3 at (192, 192)),
# full width and depth, each through its config's test_cfg (forward_test,
# tiles of 256 and 192, overlap 32). Their requests, (generator, name, LR
# shape, scale): 002 x4 and x2.5 on SWIN_IMG² (4 tiles of 256: K3, row 10);
# 001 x4 and x2.5 on SWIN_001_IMG² (4 tiles of 192: K4, K3, row 10) and x4
# on 60 x 47 (two 47² tiles: row 9's odd width). The kernel rows are held
# on the first tile of each request (SWIN_U1_TILES)
SWIN_002_U1 = dict(SWIN_002, feat_unfold=False)
SWIN_001_U1 = dict(SWIN_001, feat_unfold=False)
SWIN_U1_ODD = (60, 47)
SWIN_U1_REQUESTS = (("002", "x4", (SWIN_IMG, SWIN_IMG), 4),
                    ("002", "x2.5", (SWIN_IMG, SWIN_IMG), 2.5),
                    ("001", "x4", (SWIN_001_IMG, SWIN_001_IMG), 4),
                    ("001", "x4", SWIN_U1_ODD, 4),
                    ("001", "x2.5", (SWIN_001_IMG, SWIN_001_IMG), 2.5))

# the 002 recipe's training (configs/002_real_wogan_*: samples_per_gpu 6,
# lq_patch_size 64, sample_quantity 4096 (a 64 × 64 block of one HR grid,
# the √ns reshape real_restorer.py needs); Adam 2e-4, betas (0.9, 0.99);
# Step policy with gamma 1): 5 classical L1 steps on seeded batches
TRAIN_B, TRAIN_LR, TRAIN_QSIDE, TRAIN_STEPS = 6, 64, 64, 5
TRAIN_OPT = dict(type="Adam", lr=2e-4, betas=(0.9, 0.99))
TRAIN_LR_CFG = dict(policy="Step", by_epoch=False,
                    step=[200000, 400000, 600000, 800000], gamma=1)
BWD_KERNELS = ("swin_block_bwd", "swin_block_wgrad", "swin_block_gsum")
# row 12's three kernels by their names in a profiler's trace
BWD_KERNEL_NAMES = ("swin_bwd_sm90", "swin_wgrad_sm90", "swin_gsum_kernel")
# calls of a path that log_launch_split profiles, and its profiles at most
SPLIT_CALLS, SPLIT_TRIES = 3, 3
# row 12 against its f32 plain version: dx - dy (the increment) and each
# packed parameter gradient; the kernel rounds dq, dk, dv, dl, dz1 and dx1
# to bf16 as the TPU kernel does, then sums over every token
BWD_TOL_DX, BWD_TOL_PARAM = 1e-2, 2e-2
# row 12's weight-gradient kernel alone against its plain version on the
# same bf16 pairs: both sum bf16 products in f32, in another order
WGRAD_TOL = 1e-3
# row 8's paste against its plain version: both add the same f32 values in
# the same order
PASTE_TOL = 1e-6
# one step's gradients, kernel route (bf16) against the plain f32 route:
# each parameter tensor's ||Δ||/||ref|| within the JAX package's bound for
# its fused block's gradients, or within TRAIN_ROUTE_FACTOR times the
# plain bf16 route's own distance from f32 where bf16 alone goes further
# (the decoder's imnet_k and the relative-position tables: bf16 gradients
# of sums that cancel)
TRAIN_ROUTE_TOL, TRAIN_ROUTE_FACTOR = 5e-2, 2.0


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 5, warm: int = 2) -> float:
    """Median CUDA-event time of one fn() in ms, after warm-up. Where one
    call takes under 1 ms, each sample spans BATCH calls enqueued back to
    back, divided by BATCH: the path enqueues its kernels behind each
    other, so the host's dispatch (argument checks, tensor maps) overlaps
    the device's work, which a lone call between two events would not
    show. The choice reads a batched sample: a lone call's time carries
    the dispatch, so a call just under 1 ms would read over it in some
    runs and be timed alone in those."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()

    def sample(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    n = BATCH if sample(1) < 2.0 and sample(BATCH) < 1.0 else 1
    return statistics.median(sample(n) for _ in range(reps))


def tflops(flops: float, ms: float) -> float:
    """The function's own FLOPs over a measured time, in TFLOP/s."""
    return flops / ms / 1e9


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def errors(got, ref) -> tuple[float, float]:
    """(max|Δ|, max|Δ|/max|ref|) over all outputs."""
    got = [g.float() for g in (got if isinstance(got, tuple) else (got,))]
    ref = [r.float() for r in (ref if isinstance(ref, tuple) else (ref,))]
    num = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    return num, num / max(float(r.abs().max()) for r in ref)


def f32(x):
    """f32 copies of the floating tensors in a tensor, tuple or dict (None
    stays None)."""
    if isinstance(x, dict):
        return {k: f32(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(f32(v) for v in x)
    return x.float() if x is not None and x.is_floating_point() else x


def kernel_row(name, source, replaces, kern, plain, flops, nbytes,
               library, reps: int = 5, crop=None,
               same_bits: bool = False, each: bool = False) -> dict:
    """One row of the kernels line: the kernel (bf16) against its plain
    version (f32, same values), max|Δ|/max|ref| ≤ REL_TOL, with CUDA-event
    times of both (the plain version: median of 3, its reference call
    above the warm-up),
    the bound from ``flops`` and ``nbytes``, and ``library``'s time where
    one PyTorch call computes the same function. ``crop`` takes a kernel
    on zero-padded maps to the plain version's real widths; ``same_bits``
    also holds a second launch to the first one's bits (every output);
    ``each`` holds every output of a tuple to REL_TOL on its own
    (``max_rel_err_each``)."""
    with torch.inference_mode():
        got = kern()
        same = None
        if same_bits:
            again = kern()
            pairs = zip(got, again) if isinstance(got, tuple) else [
                (got, again)]
            same = all(torch.equal(a, b) for a, b in pairs)
            del again, pairs
        torch.cuda.synchronize()
        ref = plain()
        got = got if crop is None else crop(got)
        abs_err, err = errors(got, ref)
        errs = [errors(g, r)[1] for g, r in zip(got, ref)] if each else []
        del got, ref
        ms = time_ms(kern, reps=reps, warm=min(2, reps - 2))
        plain_ms = time_ms(plain, reps=3, warm=0)
        lib_ms = time_ms(library, reps=reps) if library else None
    bms, by = bound_ms(flops, nbytes)
    if not max([err] + errs) <= REL_TOL:
        raise AssertionError(f"{name}: error {max([err] + errs):.3e} > "
                             f"{REL_TOL}")
    if same is False:
        raise AssertionError(f"{name}: two launches gave different bits")
    row = dict(name=name, route="cuda", source=source, replaces=replaces,
               launches=0, max_abs_err=abs_err, max_rel_err=err,
               tol_rel=REL_TOL, ms=ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, library_ms=lib_ms, tflops=tflops(flops, ms))
    if each:
        row["max_rel_err_each"] = errs
    if same_bits:
        row["reproducible"] = True
    return row


def device_ms(fn, key: str | None, calls: int = 20,
              rounds: int = 3) -> float | None:
    """torch.profiler's CUDA time a call of ``fn``'s kernels whose name
    holds ``key`` (None: every kernel of the call), median of ``rounds``
    profiles of ``calls`` calls, each after as many calls with the
    profiler warming up. The profiler can miss launches, so a profile
    whose launches are not a whole number a call is taken again, up to
    SPLIT_TRIES times; None if no profile saw them all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    seen, per = {}, []
    for _ in range(rounds):
        for _ in range(SPLIT_TRIES):
            with torch.inference_mode(), profile(
                    activities=[ProfilerActivity.CUDA],
                    on_trace_ready=lambda p: seen.update(
                        evs=p.key_averages()),
                    schedule=schedule(wait=0, warmup=1, active=1)) as prof:
                for _ in range(2):
                    for _ in range(calls):
                        fn()
                    torch.cuda.synchronize()
                    prof.step()
            evs = [e for e in seen["evs"] if e.device_type == DeviceType.CUDA
                   and (key is None or key in e.key)]
            n = sum(e.count for e in evs)
            if n and n % calls == 0:
                per.append(sum(e.device_time_total for e in evs) / 1e3
                           / calls)
                break
    return statistics.median(per) if per else None


def k1_device_split(row: dict, kern, library) -> None:
    """A one-tap K1 row's device time a launch (profiler) beside its
    batched event time, and its library call's both ways: logged, and kept
    in the row (``device_ms``, ``library_device_ms``)."""
    row["device_ms"] = device_ms(kern, "f3p")
    row["library_device_ms"] = device_ms(library, None)

    def ms(t):
        return "launches missed" if t is None else f"{t:.4f} ms"
    log(f"kernel {row['name']} device {ms(row['device_ms'])} a launch "
        f"(profiler), events {row['ms']:.4f} ms (10 back to back); library "
        f"device {ms(row['library_device_ms'])} a call, events "
        f"{row['library_ms']:.4f} ms")


def check_kernels(restorer, lq_tile: torch.Tensor,
                  lq_odd: torch.Tensor) -> list[dict]:
    """Each kernel vs its plain version on the main path's tensors of one
    flagship tile (bf16 kernel, f32 plain on the same values), and the
    decode kernel once more at the odd-width request's shapes."""
    from ciaosr_torch.models.ciaosr import rational_cell
    from ciaosr_torch.ops.kernels import csa_stencil as k4
    from ciaosr_torch.ops.kernels import decoder as dk

    net = restorer.generator
    s, dt = 4, torch.bfloat16
    with torch.inference_mode():
        feature = net.gen_feature(restorer.normalize(lq_tile)).contiguous()
        match, keys, embed = net.cs_attn.stencil_inputs(feature, 2, dt)
        b, h, w, c = feature.shape
        int_maps = net._kernel_maps(feature, (2.0 / s, 2.0 / s))
        _, csa, gk, gv, wt, ck, pk = int_maps
        tabs = dk.decoder_tables(s, h, w, net.local_size, feature.device)
        # the rational mode at ×2.5: 25 phases of (h/2) × (w/2)
        py, qy = 5, 2
        rat_maps = net._kernel_maps(
            feature, rational_cell(h, w, h * py // qy, w * py // qy))
        tabs_r = dk.rational_tables(h, w, py, qy, py, qy, net.local_size,
                                    feature.device)
        feat_odd = net.gen_feature(restorer.normalize(lq_odd)).contiguous()
        odd_maps = net._kernel_maps(feat_odd, (2.0 / s, 2.0 / s))
        tabs_odd = dk.decoder_tables(s, *feat_odd.shape[1:3],
                                     net.local_size, feature.device)
    m = b * h * w
    hid = 256
    ss, cs = net.softmax_scale, net.cs_attn.softmax_scale
    rows = []

    def run(*args):
        rows.append(kernel_row(*args))

    # K1: gk/gv = conv3x3([feature | csa]) with csa only on the centre tap
    # and only into gv, as one cuDNN call (the library yardstick)
    w_lib = torch.zeros(2 * hid, 2 * c, 3, 3, device=feature.device, dtype=dt)
    w_lib[:hid, :c] = pk["wk0"].reshape(3, 3, c, hid).permute(3, 2, 0, 1)
    w_lib[hid:, :c] = pk["wvu"].reshape(3, 3, c, hid).permute(3, 2, 0, 1)
    w_lib[hid:, c:, 1, 1] = pk["wvc"].t()
    x_lib = torch.cat([feature, csa], -1).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    w_lib = w_lib.contiguous(memory_format=torch.channels_last)
    run("f3p_build", "ciaosr_torch/csrc/f3p_build.cu",
        "ciaosr_tpu/ops/pallas/decoder_kernel.py:623 (_build_f3p)",
        lambda: dk.f3p_build(feature, csa, pk["wk0"], pk["wvu"], pk["wvc"]),
        lambda: dk.f3p_build_plain(*f32((feature, csa, pk["wk0"], pk["wvu"],
                                         pk["wvc"]))),
        2 * m * (9 * c * 2 * hid + csa.shape[-1] * hid),
        m * 2 * c * 2 + (2 * 9 * c + c) * hid * 2 + m * 2 * hid * 2,
        lambda: torch.nn.functional.conv2d(x_lib, w_lib, padding=1))
    rows.append(wt_row("wt_hoist", feature, pk, feature.float(), f32(pk),
                       "ciaosr_tpu/ops/pallas/decoder_kernel.py:762 "
                       "(_wt_hoist_planes)"))

    rows.append(decode_row("grid_decode", DECODE_REPLACES[False], int_maps,
                           tabs, False, ss))
    rows.append(decode_row("grid_decode_rational", DECODE_REPLACES[True],
                           rat_maps, tabs_r, True, ss))
    rows.append(decode_row("grid_decode@{}x{}".format(*feat_odd.shape[1:3]),
                           DECODE_REPLACES["odd"], odd_maps, tabs_odd, False,
                           ss))
    hp, wp = match.shape[1:3]
    p_, l_ = hp * wp, keys.shape[1]
    run("csa_stencil_fused", "ciaosr_torch/csrc/csa_stencil_sm90.cu",
        "ciaosr_tpu/ops/pallas/csa_attention.py:930 (csa_stencil_fused)",
        lambda: k4.csa_stencil_fused(match, keys, embed, cs, 2),
        lambda: k4.csa_stencil_fused_plain(match.float(), keys.float(),
                                           embed.float(), cs, 2),
        2 * b * p_ * l_ * (keys.shape[-1] + 4 * c),
        b * (p_ * match.shape[-1] * 2 + l_ * keys.shape[-1] * 2
             + p_ * c * 2 + 4 * p_ * c * 4),
        None)
    return rows


def wt_row(name, feature, pk, feat_real, pk_real, replaces) -> dict:
    """K2 on ``feature`` (zero-padded to a compiled width) and its packed
    W_kout, b_kout against its plain version (f32) on ``feat_real`` and
    ``pk_real`` at the real width: wt and ck each ≤ REL_TOL, the same bits
    on two launches; the bound counts the function's work at the real
    width (no PyTorch call computes it: no library time)."""
    from ciaosr_torch.ops.kernels import decoder as dk

    hid = 256
    b, h, w, c = feat_real.shape
    m, dk_ = b * h * w, pk_real["wkout"].shape[0]
    return kernel_row(
        name, "ciaosr_torch/csrc/wt_hoist_sm90.cu", replaces,
        lambda: dk.wt_hoist(feature, pk["wkout"], pk["bkout"]),
        lambda: dk.wt_hoist_plain(feat_real, pk_real["wkout"],
                                  pk_real["bkout"]),
        2 * 9 * m * dk_ * (hid + 1),
        m * c * 2 + dk_ * hid * 2 + dk_ * 4 + 9 * m * (hid * 2 + 4), None,
        same_bits=True, each=True)


# the TPU functions of the decode kernel's modes
DECODE_REPLACES = {
    False: "ciaosr_tpu/ops/pallas/decoder_kernel.py:1329 (_grid_decode_halo)",
    True: "ciaosr_tpu/ops/pallas/decoder_kernel.py:1224 "
          "(grid_decode_fused_rational)",
    "odd": "ciaosr_tpu/ops/pallas/decoder_kernel.py:255 "
           "(grid_decode_fused, assembly='stacked')"}


def decode_row(name, replaces, maps, tabs, rational, ss) -> dict:
    """The decode kernel (integer or rational mode) on ``maps``, the
    outputs of the CSA, K1 and K2 at one LR shape (``_kernel_maps``),
    against its plain version; the value is DV = taps·C + DC wide."""
    from ciaosr_torch.ops.kernels import decoder as dk

    hid = 256
    fb, fh, fw, fc = maps[0].shape
    if rational:
        kern = dk.grid_decode_rational
        plain = dk.grid_decode_rational_plain
        n_phase = tabs["yk"].shape[0] * tabs["xk"].shape[0]
        n_shift = tabs["yk"].shape[1]
        m_out = fb * tabs["yk"].shape[2] * tabs["xk"].shape[2]
    else:
        kern, plain = dk.grid_decode, dk.grid_decode_plain
        (n_phase, n_shift), m_out = tabs["dys"].shape, fb * fh * fw
    dv = maps[6]["vout"].shape[1]
    mlp = n_shift * (6 * hid * hid + hid * dv + hid) + dv * hid \
        + 3 * hid * hid + hid * 3
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*maps[-1].values(), *tabs.values()))
    return kernel_row(
        name, "ciaosr_torch/csrc/grid_decode_sm90.cu", replaces,
        lambda: kern(*maps[:6], maps[6], tabs, ss),
        lambda: plain(*f32(maps[:6]), f32(maps[6]), tabs, ss),
        2 * n_phase * m_out * mlp,
        fb * fh * fw * (2 * fc * 2 + 2 * hid * 2 + 9 * (hid * 2 + 4))
        + nbytes + n_phase * m_out * 3 * 4,
        None, same_bits=True)


def csa_inputs(restorer, img, banks: bool = False):
    """match, keys, embed (bf16) of the flagship CSA on an H × W × 3 image,
    and with ``banks`` also the streaming route's q and v banks."""
    from ciaosr_torch.ops.neighborhood import extract_patches_same

    net = restorer.generator
    with torch.inference_mode():
        feat = net.gen_feature(restorer.normalize(
            torch.as_tensor(img, device="cuda")[None])).contiguous()
        maps = net.cs_attn.stencil_inputs(feat, 2, torch.bfloat16)
        if not banks:
            return maps
        return (*maps, extract_patches_same(maps[0], 3, 1).contiguous(),
                extract_patches_same(maps[2], 6, 2).contiguous())


def check_csa_kernels(restorer, images) -> list[dict]:
    """Rows 5-8 against their plain versions at the CSA geometries of the
    paths that run them: the inputs are stencil_inputs of the flagship
    encoder on the seeded image of that size (``images``: (wrapper, H × W × 3
    array) pairs; "csa_attention" stands for rows 7 and 8), and rows 7 and 8
    take the banks of extract_patches_same.
    Rows of more than 1e8 (query, key) pairs are timed 3 times after one
    warm-up."""
    from ciaosr_torch.ops.kernels import csa_attention as ca
    from ciaosr_torch.ops.kernels import csa_stencil as st
    from ciaosr_torch.ops.neighborhood import plane_major_perm

    cs = restorer.generator.cs_attn.softmax_scale
    rows = []
    for name, img in images:
        inputs = csa_inputs(restorer, img, banks=name == "csa_attention")
        match, keys, embed = inputs[:3]
        b, hp, wp, c = embed.shape
        p_, l_ = hp * wp, keys.shape[1]
        dk, dv = keys.shape[-1], 36 * c
        reps = 3 if p_ * l_ > 1e8 else 5
        maps = (match, keys, embed)
        maps32 = tuple(t.float() for t in maps)
        # bytes of the maps in and the pasted f32 map out
        map_bytes = b * (p_ * match.shape[-1] * 2 + l_ * dk * 2 + p_ * c * 2
                         + 4 * p_ * c * 4)
        at = "ciaosr_tpu/ops/pallas/csa_attention.py:"
        if name == "csa_stencil":
            # K4's function from K4's inputs, on K4's kernels
            rows.append(kernel_row(
                f"csa_stencil@{hp}x{wp}",
                "ciaosr_torch/csrc/csa_stencil_sm90.cu",
                at + "687 (csa_stencil)",
                lambda: st.csa_stencil(*maps, cs, 2),
                lambda: st.csa_stencil_plain(*maps32, cs, 2),
                2 * b * p_ * l_ * (dk + 4 * c), map_bytes, None, reps))
        elif name == "csa_fused":
            # K4's function from K4's inputs, on K4's kernel: its bound is
            # K4's, not that of the bank form (2PL(dk + dv))
            rows.append(kernel_row(
                f"csa_fused@{hp}x{wp}",
                "ciaosr_torch/csrc/csa_stencil_sm90.cu",
                at + "447 (csa_fused)",
                lambda: ca.csa_fused(*maps, cs, 2),
                lambda: ca.csa_fused_plain(*maps32, cs, 2),
                2 * b * p_ * l_ * (dk + 4 * c), map_bytes, None, reps))
        else:  # the banks of the streaming route
            q, v = inputs[3:]
            with torch.inference_mode():
                v_pm = v[..., torch.as_tensor(plane_major_perm(2, c),
                                              device=v.device)].contiguous()
            bank_bytes = b * (p_ * dk + l_ * dk + l_ * dv) * 2
            rows.append(kernel_row(
                f"csa_attention@{hp}x{wp}", "ciaosr_torch/csrc/csa_flash.cu",
                at + "65 (csa_attention)",
                lambda: ca.csa_attention(q, keys, v, cs),
                lambda: ca.csa_attention_plain(q.float(), keys.float(),
                                               v.float(), cs),
                2 * b * p_ * l_ * (dk + dv), bank_bytes + b * p_ * dv * 4,
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, keys, v, scale=cs), reps))
            # row 8: row 7's kernel on v_pm, then the paste
            rows.append(kernel_row(
                f"csa_attention_overlap_add@{hp}x{wp}",
                "ciaosr_torch/csrc/csa_flash.cu + "
                "ciaosr_torch/csrc/csa_paste.cu",
                at + "194 (csa_attention_overlap_add)",
                lambda: ca.csa_attention_overlap_add(q, keys, v_pm, cs, hp,
                                                     wp, 2),
                lambda: ca.csa_attention_overlap_add_plain(
                    q.float(), keys.float(), v_pm.float(), cs, hp, wp, 2),
                2 * b * p_ * l_ * (dk + dv),
                bank_bytes + b * 4 * p_ * c * 4, None, reps,
                same_bits=True))
            check_paste(q, keys, v_pm, cs, hp, wp)
    return rows


def check_paste(q, keys, v_pm, cs: float, hp: int, wp: int) -> None:
    """Row 8's paste alone (csrc/csa_paste.cu) on the plane-major kernels
    that row 7's kernel writes from these banks: against its plain
    version (≤ PASTE_TOL, the same bits twice), its CUDA-event time and
    its byte bound (the k_pm values that land on the grid, read once:
    B·(3Hp − 2)(3Wp − 2)·s²C f32; the output written once), on a line of
    its own."""
    from ciaosr_torch.ops.kernels import csa_attention as ca

    with torch.inference_mode():
        k_pm = ca.csa_attention(q, keys, v_pm, cs)
        got = ca.plane_overlap_add(k_pm, hp, wp, 2)
        same = torch.equal(got, ca.plane_overlap_add(k_pm, hp, wp, 2))
        abs_err, err = errors(got, ca.plane_overlap_add_plain(k_pm, hp, wp,
                                                               2))
        nbytes = 4 * k_pm.shape[0] * (3 * hp - 2) * (3 * wp - 2) * (
            k_pm.shape[-1] // 9) + 4 * got.numel()
        del got
        ms = time_ms(lambda: ca.plane_overlap_add(k_pm, hp, wp, 2), reps=20)
    bms, _ = bound_ms(0, nbytes)
    log(f"kernel plane_overlap_add@{hp}x{wp} (row 8's paste, "
        f"csrc/csa_paste.cu): max|d|={abs_err:.3e} max|d|/max|ref|="
        f"{err:.3e} reproducible {same}; ms={ms:.4f}; bound "
        f"{nbytes / 1e6:.1f} MB: {bms:.4f} ms (bytes), "
        f"{bms / ms:.2f} of it")
    if not (err <= PASTE_TOL and same):
        raise AssertionError(f"plane_overlap_add@{hp}x{wp}: error "
                             f"{err:.3e} > {PASTE_TOL} or reproducible "
                             f"{same}")


def compare_csa_forms(restorer, img) -> None:
    """K4 (row 5 launches the same kernels: the same bits, asserted), row
    6 and the streaming route (row 7 + the plain overlap-add) on the same
    inputs at one geometry, where all three run: each one's time (CUDA
    events, median of 3 after one warm-up) and its output held against
    K4's."""
    from ciaosr_torch.ops.kernels import csa_attention as ca
    from ciaosr_torch.ops.kernels import csa_stencil as st
    from ciaosr_torch.ops.neighborhood import overlap_add

    cs = restorer.generator.cs_attn.softmax_scale
    *maps, q, v = csa_inputs(restorer, img, banks=True)
    _, hp, wp, c = maps[2].shape
    with torch.inference_mode():
        forms = {
            "csa_stencil_fused (K4) = csa_stencil (row 5)":
                lambda: st.csa_stencil_fused(*maps, cs, 2),
            "csa_fused (row 6)": lambda: ca.csa_fused(*maps, cs, 2),
            "csa_attention (row 7) + overlap_add": lambda: overlap_add(
                ca.csa_attention(q, maps[1], v, cs), hp, wp, 2, c),
        }
        ref = st.csa_stencil_fused(*maps, cs, 2)
        if not torch.equal(st.csa_stencil(*maps, cs, 2), ref):
            raise AssertionError(f"csa_stencil (row 5) and K4 differ in "
                                 f"bits at {hp}x{wp}")
        log(f"csa form at {hp}x{wp}: csa_stencil (row 5) gives K4's bits")
        for name, fn in forms.items():
            _, err = errors(fn(), ref)
            ms = time_ms(fn, reps=3, warm=1)
            log(f"csa form at {hp}x{wp}, {name}: {ms:.3f} ms, "
                f"max|d|/max|ref| vs K4 {err:.3e}")
            if not err <= REL_TOL:
                raise AssertionError(f"{name} disagrees with K4 at "
                                     f"{hp}x{wp}: {err:.3e}")


def time_full_images(restorer, big: np.ndarray, reps: int = 3) -> None:
    """Warm host-clock time of each full-image ×4 ``predict`` request of
    CSA_FULL (a crop of ``big``), output fetched: median of ``reps`` after
    one warm-up. Uses only the restorer's entry points, so it also times a
    tree whose CSA routes otherwise."""
    for mode, (h, w), _ in CSA_FULL:
        img = big[:h, :w]
        times = []
        for i in range(reps + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            restorer.predict(img, (4 * h, 4 * w))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        log(f"full-image predict {h}x{w} x4 (route here: {mode}): median "
            f"{statistics.median(times[1:]):.2f} ms of {reps} warm "
            f"({', '.join(f'{t:.2f}' for t in times[1:])})")


def breakdown(restorer, lq_tile: torch.Tensor) -> None:
    """Where one flagship tile's time goes: CUDA-event time per stage of
    the kernel route (×4, and the host stage and whole tile at ×2.5), and
    the profiler's device-busy share of one ×4 grid_predict request with
    its top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ciaosr_torch.models.ciaosr import pixel_shuffle, rational_cell
    from ciaosr_torch.ops.kernels import decoder as dk
    from ciaosr_torch.ops.sampling import interpolate_bilinear

    net, s, dt = restorer.generator, 4, torch.bfloat16
    st: dict = {}
    with torch.inference_mode():
        x = restorer.normalize(lq_tile)
        st["feature"] = net.gen_feature(x).contiguous()
        st["csa"] = net.nl_feature(st["feature"], True).to(dt).contiguous()
        feat, csa = st["feature"], st["csa"]
        b, h, w, c = feat.shape
        st["pk"] = dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, c,
                                   (2.0 / s, 2.0 / s), dt)
        st["tabs"] = dk.decoder_tables(s, h, w, net.local_size, feat.device)
        pk, tabs = st["pk"], st["tabs"]
        st["g"] = dk.f3p_build(feat, csa, pk["wk0"], pk["wvu"], pk["wvc"])
        st["w"] = dk.wt_hoist(feat, pk["wkout"], pk["bkout"])
        st["ph"] = dk.grid_decode(feat, csa, *st["g"], *st["w"], pk, tabs,
                                  net.softmax_scale)
        stages = {
            "encoder (RDN, cuDNN bf16)": lambda: net.gen_feature(x),
            "CSA (convs + K4)": lambda: net.nl_feature(feat, True),
            "pack weights + tables (host)": lambda: (
                dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, c,
                                (2.0 / s, 2.0 / s), dt),
                dk.decoder_tables(s, h, w, net.local_size, feat.device)),
            "K1 f3p_build": lambda: dk.f3p_build(feat, csa, pk["wk0"],
                                                 pk["wvu"], pk["wvc"]),
            "K2 wt_hoist": lambda: dk.wt_hoist(feat, pk["wkout"],
                                               pk["bkout"]),
            "K3 grid_decode": lambda: dk.grid_decode(
                feat, csa, *st["g"], *st["w"], pk, tabs, net.softmax_scale),
            "shuffle + residual + denorm": lambda: restorer.denormalize(
                pixel_shuffle(st["ph"], s)
                + interpolate_bilinear(x, s * h, s * w)),
            "whole tile (grid_predict)": lambda: restorer.grid_predict(
                lq_tile, s),
            "x2.5: pack weights + rational tables (host)": lambda: (
                dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, c,
                                rational_cell(h, w, h * 5 // 2, w * 5 // 2),
                                dt),
                dk.rational_tables(h, w, 5, 2, 5, 2, net.local_size,
                                   feat.device)),
            "x2.5: whole tile (grid_predict)": lambda: restorer.grid_predict(
                lq_tile, Fraction(5, 2)),
        }
        for name, fn in stages.items():
            log(f"stage {name}: {time_ms(fn, reps=3, warm=1):.3f} ms")
    restorer.grid_predict(lq_tile, s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        restorer.grid_predict(lq_tile, s)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: a CPU op's device time repeats its kernels'
    evs = sorted(((e.device_time_total, e.count, e.key)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA), reverse=True)
    dev_us = sum(t for t, _, _ in evs)
    if dev_us == 0:
        log("profile: no device time recorded: busy share not measured")
        return
    log(f"profile (one grid_predict tile, profiler on): wall "
        f"{wall_us / 1e3:.3f} ms, device busy {dev_us / 1e3:.3f} ms = "
        f"{dev_us / wall_us:.3f} of wall, {len(evs)} kernel names")
    for t, n, key in evs[:8]:
        log(f"  {t / 1e3:9.3f} ms  x{n:<4d} {key[:90]}")


def time_kernels(label: str, restorer, swin, sw1, lq: np.ndarray,
                 lq_s: np.ndarray, big: np.ndarray,
                 sw1_ms: dict | None = None, edsr=None, u1=None,
                 u1_ms: dict | None = None, swin_u1: dict | None = None,
                 swin_u1_ms: dict | None = None) -> None:
    """CUDA-event times (median of several after warm-up) of the kernels
    redesigned for Hopper (K1, K2 and K3's integer mode at both widths, K3 at
    row 9's odd width, row 7, K4 and row 6, row 11: the Swin block shifted
    and unshifted on a SwinIR tile's tokens, shifted on a training batch's),
    of K3's rational mode at both widths, of rows 5 and 8, of row 12 (the
    shifted block's backward; its three kernels also by launch, with the
    profiler), and of the tiles that run K1 and K3 or row
    10 (a flagship 192 tile at x4 and x2.5, a SwinIR 256 tile at x4), and
    of config 001
    swinir's instances (K4, K1 and K2 on its 192² tile, row 7 at 72², K3 on
    both and at 70², row 10 at x2.5 on the 192² tile and 72², rows 6 and 5
    on the 192 x 512 and 48 x 1024 full images), at the main path's
    shapes: one line, printed the same way by
    ``--kernel-times`` in another checkout, so that a parent tree's times
    and these are read in one call. ``sw1_ms`` (the normal run) gives the
    001 swinir instances' times that check_swin001_kernels measured in
    this run; without it (``--kernel-times``) they are timed here, and
    the wide pair is split by launch (torch.profiler). Last, config 001
    edsr's one-tap instances (``u1_ms`` from check_u1_kernels in the
    normal run, else timed here), a TILE² x4 tile of config 001 edsr and
    of its generator without the unfold (``edsr``, ``u1``), and the
    latter's tile at x2.5; then the SwinIR generators' one-tap C = 192
    instances (``swin_u1_ms`` from check_swin_u1_kernels, else timed
    here) and an x4 tile of each (``swin_u1``: their kernel routes)."""
    from ciaosr_torch.models.ciaosr import rational_cell
    from ciaosr_torch.ops.kernels import csa_attention as ca
    from ciaosr_torch.ops.kernels import csa_stencil as st
    from ciaosr_torch.ops.kernels import decoder as dk
    from ciaosr_torch.ops.kernels import swin_block as sb
    from ciaosr_torch.ops.neighborhood import plane_major_perm

    tile = torch.as_tensor(lq[:TILE, :TILE], device="cuda")[None]
    swin_tile = torch.as_tensor(lq_s[:SWIN_TILE, :SWIN_TILE],
                                device="cuda")[None]
    times = {}
    with torch.inference_mode():
        net = restorer.generator
        feature = net.gen_feature(restorer.normalize(tile)).contiguous()
        _, csa, _, _, _, _, pk = net._kernel_maps(feature, (0.5, 0.5))
        times["f3p_build"] = time_ms(lambda: dk.f3p_build(
            feature, csa, pk["wk0"], pk["wvu"], pk["wvc"]), reps=20)
        times["wt_hoist"] = time_ms(lambda: dk.wt_hoist(
            feature, pk["wkout"], pk["bkout"]), reps=20)
        sfeat = swin.generator.gen_feature(swin.normalize(swin_tile))
        feat_p, _, _, _, _, _, spk = swin.generator._kernel_maps(
            sfeat, (0.5, 0.5))
        times["f3p_build@C180"] = time_ms(lambda: dk.f3p_build(
            feat_p, None, spk["wk0"], spk["wvu"], spk["wvc"]), reps=20)
        times["wt_hoist@C180"] = time_ms(lambda: dk.wt_hoist(
            feat_p, spk["wkout"], spk["bkout"]), reps=20)

        def decode_times(suffix, gen, feat, rational):
            """K3 at x4 on feat's maps, and with ``rational`` its rational
            mode at x2.5 (25 phases of (H/2) x (W/2))."""
            h, w = feat.shape[1:3]
            maps = gen._kernel_maps(feat, (0.5, 0.5))
            tabs = dk.decoder_tables(4, h, w, gen.local_size, feat.device)
            times["grid_decode" + suffix] = time_ms(
                lambda: dk.grid_decode(*maps, tabs, gen.softmax_scale),
                reps=3, warm=1)
            if rational:
                maps = gen._kernel_maps(feat, rational_cell(
                    h, w, h * 5 // 2, w * 5 // 2))
                tabs = dk.rational_tables(h, w, 5, 2, 5, 2, gen.local_size,
                                          feat.device)
                times["grid_decode_rational" + suffix] = time_ms(
                    lambda: dk.grid_decode_rational(*maps, tabs,
                                                    gen.softmax_scale),
                    reps=3, warm=1)
            del maps, tabs

        decode_times("", net, feature, True)
        decode_times("@C180", swin.generator, sfeat, True)
        decode_times("@{}x{}".format(*ODD), net, net.gen_feature(
            restorer.normalize(torch.as_tensor(lq[:ODD[0], :ODD[1]],
                                               device="cuda")[None])), False)
        cs = net.cs_attn.softmax_scale
        match, keys, embed, q, v = csa_inputs(restorer, lq[:SET5[0][0],
                                                           :SET5[0][1]],
                                              banks=True)
        hp, wp = match.shape[1:3]
        v_pm = v[..., torch.as_tensor(plane_major_perm(2, embed.shape[-1]),
                                      device="cuda")].contiguous()
        s5 = f"{hp}x{wp}"
        times[f"csa_attention@{s5}"] = time_ms(
            lambda: ca.csa_attention(q, keys, v, cs), reps=20)
        times[f"csa_attention_overlap_add@{s5}"] = time_ms(
            lambda: ca.csa_attention_overlap_add(q, keys, v_pm, cs, hp, wp,
                                                 2), reps=20)
        if hasattr(ca, "plane_overlap_add"):   # a parent tree may lack it
            k_pm = ca.csa_attention(q, keys, v_pm, cs)
            times[f"plane_overlap_add@{s5}"] = time_ms(
                lambda: ca.plane_overlap_add(k_pm, hp, wp, 2), reps=20)
            del k_pm
        k4_maps = net.cs_attn.stencil_inputs(feature, 2, torch.bfloat16)
        times["csa_stencil_fused"] = time_ms(
            lambda: st.csa_stencil_fused(*k4_maps, cs, 2))
        for _, hw, kern in CSA_FULL:
            maps = csa_inputs(restorer, big[:hw[0], :hw[1]])
            fn = ca.csa_fused if kern == "csa_fused" else st.csa_stencil
            times["{}@{}x{}".format(kern, *hw)] = time_ms(
                lambda: fn(*maps, cs, 2), reps=3, warm=1)
    # rows 11 and 12: the first (unshifted) and second (shifted) Swin
    # blocks on the SwinIR tile's tokens and on a training batch's (as
    # swin_block_row), and the shifted block's backward on the batch's (as
    # check_swin_bwd)
    blk0, blk1 = swin_blocks(swin.generator)[:2]
    dt = torch.bfloat16

    def block_inputs(x):
        tok0 = swin.generator.encoder.embed(swin.normalize(x),
                                            dt)[0].contiguous()
        ws, shift = blk1.geometry(*tok0.shape[1:3])
        tok1 = torch.roll(blk0(tok0, dt, True), (-shift, -shift),
                          (1, 2)).contiguous()
        return tok1, blk1.packed(ws, dt), ws, shift, tok0, blk0.packed(ws,
                                                                        dt)

    with torch.no_grad():
        tok, pk1, ws, shift, tok0, pk0 = block_inputs(swin_tile)
        times["swin_block@{}x{}".format(*tok.shape[1:3])] = time_ms(
            lambda: sb.swin_block(tok, pk1, ws, shift), reps=20)
        times["swin_block@{}x{} unshifted".format(*tok.shape[1:3])] = \
            time_ms(lambda: sb.swin_block(tok0, pk0, ws, 0), reps=20)
        tok, pk1, ws, shift, tok0, pk0 = block_inputs(train_batch(
            np.random.default_rng(4), TRAIN_B, TRAIN_LR, TRAIN_QSIDE)["lq"])
        times["swin_block@{}x{}x{}".format(*tok.shape[:3])] = time_ms(
            lambda: sb.swin_block(tok, pk1, ws, shift), reps=20)
        dy = torch.as_tensor(np.random.default_rng(3).standard_normal(
            tok.shape).astype(np.float32), device="cuda")
        times["swin_block_bwd@{}x{}x{}".format(*tok.shape[:3])] = time_ms(
            lambda: sb.swin_block_bwd(tok, dy, pk1, ws, shift))
        log_launch_split("swin_block_bwd@{}x{}x{}".format(*tok.shape[:3]),
                         lambda: sb.swin_block_bwd(tok, dy, pk1, ws, shift),
                         BWD_KERNEL_NAMES)
    # the tiles first: a checkout without config 001 swinir's rows then
    # times them after the same work as this one
    times["flagship x4 tile (grid_predict)"] = time_ms(
        lambda: restorer.grid_predict(tile, 4), reps=3, warm=1)
    times["flagship x2.5 tile (grid_predict)"] = time_ms(
        lambda: restorer.grid_predict(tile, Fraction(5, 2)), reps=3, warm=1)
    times["SwinIR x4 256 tile (grid_predict)"] = time_ms(
        lambda: swin.grid_predict(swin_tile, 4), reps=3, warm=1)
    if sw1_ms is not None:
        times.update(sw1_ms)
    else:
        time_swin001_kernels(times, sw1, lq_s, big)
    times["001 swinir x4 192 tile (grid_predict)"] = time_ms(
        lambda: sw1.grid_predict(torch.as_tensor(
            lq_s[:SWIN_001_TILE, :SWIN_001_TILE], device="cuda")[None], 4),
        reps=3, warm=1)
    if u1 is not None:
        if u1_ms is not None:
            times.update(u1_ms)
        else:
            time_u1_kernels(times, u1, lq)
        for name, r in (("001 edsr", edsr), ("001 edsr_u1", u1)):
            times[f"{name} x4 {TILE} tile (grid_predict)"] = time_ms(
                lambda: r.grid_predict(tile, 4), reps=3, warm=1)
        times[f"001 edsr_u1 x2.5 {TILE} tile (grid_predict)"] = time_ms(
            lambda: u1.grid_predict(tile, Fraction(5, 2)), reps=3, warm=1)
    if swin_u1 is not None:
        if swin_u1_ms is not None:
            times.update(swin_u1_ms)
        else:
            time_swin_u1_kernels(times, {k: [g] for k, g in swin_u1.items()},
                                 lq_s)
        for key, t in (("002", SWIN_TILE), ("001", SWIN_001_TILE)):
            lr_t = torch.as_tensor(lq_s[:t, :t], device="cuda")[None]
            times[f"{key} swinir_u1 x4 {t} tile (grid_predict)"] = time_ms(
                lambda: swin_u1[key].grid_predict(lr_t, 4), reps=3, warm=1)
    log(f"kernel times ({label}): " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in times.items()))


def time_swin001_kernels(times: dict, sw1, lq_s: np.ndarray,
                         big: np.ndarray) -> None:
    """Config 001 swinir's instances into ``times``, on the maps
    check_swin001_kernels holds, and the wide pair by launch (K4 on the
    192² tile, row 6 on the 192 × 512 full image's blocks)."""
    from ciaosr_torch.ops.kernels import csa_attention as ca
    from ciaosr_torch.ops.kernels import csa_stencil as st
    from ciaosr_torch.ops.kernels import decoder as dk
    from ciaosr_torch.ops.neighborhood import extract_patches_same

    inputs = swin001_inputs(sw1, lq_s, big)
    cs1 = sw1.generator.cs_attn.softmax_scale
    t192_hw = (SWIN_001_TILE, SWIN_001_TILE)
    with torch.inference_mode():
        t192 = inputs[t192_hw]
        k4_maps = st.pad_maps(*t192["csa"])
        times["csa_stencil_fused@C180"] = time_ms(
            lambda: st.csa_stencil_fused(*k4_maps, cs1, 2), reps=3, warm=1)
        mp, kp, ep = st.pad_maps(*inputs[SET5_X4_EVEN[1]]["csa"])
        q1 = extract_patches_same(mp, 3, 1).contiguous()
        v1 = extract_patches_same(ep, 6, 2).contiguous()
        times["csa_attention@C180"] = time_ms(
            lambda: ca.csa_attention(q1, kp, v1, cs1), reps=20)
        feat_p, csa_p, _, _, _, _, pk1 = t192["maps"]
        times["f3p_build@C180+csa"] = time_ms(lambda: dk.f3p_build(
            feat_p, csa_p, pk1["wk0"], pk1["wvu"], pk1["wvc"]), reps=20)
        times["wt_hoist@C180+csa"] = time_ms(lambda: dk.wt_hoist(
            feat_p, pk1["wkout"], pk1["bkout"]), reps=20)
        odd = SET5_X4_ODD[0]
        for name, hw in (("grid_decode@C180+csa", (SWIN_001_TILE,) * 2),
                         ("grid_decode@C180+csa@{}x{}".format(*odd), odd)):
            maps = inputs[hw]["maps"]
            tabs = dk.decoder_tables(4, *hw, sw1.generator.local_size,
                                     maps[0].device)
            times[name] = time_ms(lambda: dk.grid_decode(
                *maps, tabs, sw1.generator.softmax_scale), reps=3, warm=1)
        for name, hw in (("grid_decode_rational@C180+csa", t192_hw),
                         ("grid_decode_rational@C180+csa@{}x{}".format(
                             *SWIN_001_X25[1]), SWIN_001_X25[1])):
            maps = inputs[hw]["maps25"]
            tabs = dk.rational_tables(*hw, 5, 2, 5, 2,
                                      sw1.generator.local_size,
                                      maps[0].device)
            times[name] = time_ms(lambda: dk.grid_decode_rational(
                *maps, tabs, sw1.generator.softmax_scale), reps=3, warm=1)
        full_maps = {hw: st.pad_maps(*inputs[hw]["csa"])
                     for hw, _ in SWIN_001_FULL}
        for (hw, kern), fn in zip(SWIN_001_FULL, (ca.csa_fused,
                                                  st.csa_stencil)):
            times["{}@C180@{}x{}".format(kern, *hw)] = time_ms(
                lambda: fn(*full_maps[hw], cs1, 2), reps=3, warm=1)
    log_launch_split("csa_stencil_fused@C180",
                     lambda: st.csa_stencil_fused(*k4_maps, cs1, 2),
                     ("scores_wide_kernel", "pv_wide_kernel"))
    hw = SWIN_001_FULL[0][0]
    log_launch_split("csa_fused@C180@{}x{}".format(*hw),
                     lambda: ca.csa_fused(*full_maps[hw], cs1, 2),
                     ("scores_wide_kernel", "pv_wide_kernel"))


def swin_blocks(net):
    """The Swin blocks of a SwinIR generator, in order."""
    return [blk for layer in net.encoder.layers
            for blk in layer.residual_group.blocks]


def swin_block_row(swin, lq: torch.Tensor) -> dict:
    """Row 11 on the first group's real tokens of the LR images ``lq`` (B,
    h, w, 3; the encoder pads them to window multiples): its first,
    unshifted block and its second, shifted one on the first's output
    (``ms`` the shifted block's, ``ms_noshift`` the other's), each the
    kernel (bf16) against its plain version (f32, same values), y and the
    block's own increment y - x (the f32 residual dominates y), the same
    bits call after call. The bound counts the function's work at C = 180
    (no padding)."""
    from ciaosr_torch.ops.kernels import swin_block as sb

    net, dt = swin.generator, torch.bfloat16
    blk0, blk1 = swin_blocks(net)[:2]
    with torch.inference_mode():
        tok0 = net.encoder.embed(swin.normalize(lq), dt)[0].contiguous()
        b, h, w, c = tok0.shape
        ws, shift = blk1.geometry(h, w)
        tok1 = torch.roll(blk0(tok0, dt, True), (-shift, -shift),
                          (1, 2)).contiguous()
        pk0, pk1 = blk0.packed(ws, dt), blk1.packed(ws, dt)
    # the function's work: T tokens, N keys a window, the f32 map in/out
    t_, n_ = b * h * w, ws * ws
    hdn = blk0.mlp.fc1.out_features
    heads = blk0.attn.num_heads
    swin_flops = 2 * t_ * c * (3 * c + c + 2 * hdn) + 4 * t_ * n_ * c
    swin_bytes = (2 * t_ * c * 4 + (4 * c * c + 2 * c * hdn) * 2
                  + heads * n_ * n_ * 4 + (9 * c + hdn) * 4)
    name = f"swin_block@{b}x{h}x{w}" if b > 1 else f"swin_block@{h}x{w}"
    source = "ciaosr_torch/csrc/swin_block_sm90.cu"
    replaces = "ciaosr_tpu/ops/pallas/swin_block.py:380 (_swin_block_call)"
    row = kernel_row(
        name, source, replaces, lambda: sb.swin_block(tok1, pk1, ws, shift),
        lambda: sb.swin_block_plain(tok1, f32(pk1), ws, shift),
        swin_flops, swin_bytes, None)
    row0 = kernel_row(
        name + " unshifted", source, replaces,
        lambda: sb.swin_block(tok0, pk0, ws, 0),
        lambda: sb.swin_block_plain(tok0, f32(pk0), ws, 0), swin_flops,
        swin_bytes, None)
    row.update(ms_noshift=row0["ms"], plain_ms_noshift=row0["plain_ms"],
               max_abs_err=max(row["max_abs_err"], row0["max_abs_err"]),
               max_rel_err=max(row["max_rel_err"], row0["max_rel_err"]))
    for tok, pk_, sh in ((tok1, pk1, shift), (tok0, pk0, 0)):
        with torch.inference_mode():
            got = sb.swin_block(tok, pk_, ws, sh)
            same = torch.equal(got, sb.swin_block(tok, pk_, ws, sh))
            d_abs, d_rel = errors(got - tok, sb.swin_block_plain(
                tok, f32(pk_), ws, sh) - tok)
        log(f"kernel {name} shift {sh}: increment y - x max|d|={d_abs:.3e} "
            f"max|d|/max|ref|={d_rel:.3e}; reproducible {same}")
        if not (d_rel <= REL_TOL and same):
            raise AssertionError(f"{name} shift {sh}: increment error "
                                 f"{d_rel:.3e} > {REL_TOL} or not "
                                 f"reproducible ({same})")
        row["max_rel_err_increment"] = max(
            row.get("max_rel_err_increment", 0.0), d_rel)
    row["reproducible"] = True
    return row


# the f32 conv kernel's row: the 002 training batch's trunk map
CONV_ROW = f"conv3x3_f32@{TRAIN_B}x{TRAIN_LR}x{TRAIN_LR}"


def conv3x3_row() -> dict:
    """The f32 conv kernel (csrc/conv3x3_f32_sm90.cu) on a seeded map of the
    002 training batch's trunk (TRAIN_B × TRAIN_LR² × 180) against its plain
    version, ``F.conv2d`` in f32 (TF32 off), which is also the library
    call; the same bits on two launches. The bound is at the f32 peak: the
    model computes in f32, outside the tensor cores."""
    from ciaosr_torch.ops.kernels import conv3x3 as c3

    c = SWIN_002["encoder"]["embed_dim"]
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(TRAIN_B, TRAIN_LR, TRAIN_LR, c, device="cuda",
                    generator=g)
    w = (torch.rand(c, c, 3, 3, device="cuda", generator=g) * 2 - 1) \
        / (9 * c) ** 0.5
    bias = (torch.rand(c, device="cuda", generator=g) * 2 - 1) / (9 * c) ** 0.5
    flops = 2 * 9 * c * c * x.shape[0] * TRAIN_LR ** 2
    nbytes = 4 * (2 * x.numel() + w.numel() + c)
    row = kernel_row(
        CONV_ROW, "ciaosr_torch/csrc/conv3x3_f32_sm90.cu",
        "none: the trunk's nn.Conv (ciaosr_tpu/models/swinir.py:266, :335), "
        "left to XLA", lambda: c3.conv3x3(x, w, bias),
        lambda: c3.conv3x3_plain(x, w, bias), flops, nbytes,
        lambda: c3.conv3x3_plain(x, w, bias), same_bits=True)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    row.update(bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations (f32)" if t_ops >= t_bytes else "bytes",
               reproducible=True)
    return row


def check_swin_kernels(swin, lq_tile: torch.Tensor,
                       lq_odd: torch.Tensor) -> list[dict]:
    """Row 11 (``swin_block_row``) on one SWIN_TILE² tile and on the
    SWIN_ODD request's tile, and K1, K2, K3 (integer ×4 and rational ×2.5)
    at C = 180 on the SWIN_TILE² tile's features: each kernel (bf16)
    against its plain version (f32, same values). Bounds count the
    function's work at C = 180 (no padding)."""
    from ciaosr_torch.models.ciaosr import rational_cell
    from ciaosr_torch.ops.kernels import decoder as dk

    net = swin.generator
    hid = 256
    with torch.inference_mode():
        x = swin.normalize(lq_tile)
        feature = net.gen_feature(x)
        b, h, w, c = feature.shape
        maps = net._kernel_maps(feature, (0.5, 0.5))
        feat_p, _, gk, gv, wt, ck, pk = maps
        tabs = dk.decoder_tables(4, h, w, net.local_size, feature.device)
        py, qy = 5, 2
        maps_r = net._kernel_maps(feature, rational_cell(
            h, w, h * py // qy, w * py // qy))
        tabs_r = dk.rational_tables(h, w, py, qy, py, qy, net.local_size,
                                    feature.device)
    rows = [swin_block_row(swin, lq_tile), swin_block_row(swin, lq_odd)]

    m = b * h * w
    cp = feat_p.shape[-1]
    dk_, src = 9 * c, "ciaosr_tpu/ops/pallas/decoder_kernel.py:"
    # K1 without CSA: gk/gv = conv3x3(feature), one cuDNN call (the
    # library yardstick) on the same zero-padded feature and weights
    w_lib = torch.cat([pk["wk0"], pk["wvu"]], 1).reshape(
        3, 3, cp, 2 * hid).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    x_lib = feat_p.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    rows.append(kernel_row(
        "f3p_build@C180", "ciaosr_torch/csrc/f3p_build.cu",
        src + "623 (_build_f3p)",
        lambda: dk.f3p_build(feat_p, None, pk["wk0"], pk["wvu"], pk["wvc"]),
        lambda: dk.f3p_build_plain(*f32((feat_p, None, pk["wk0"], pk["wvu"],
                                         pk["wvc"]))),
        2 * m * dk_ * 2 * hid,
        m * c * 2 + 2 * dk_ * hid * 2 + m * 2 * hid * 2,
        lambda: torch.nn.functional.conv2d(x_lib, w_lib, padding=1)))
    rows.append(wt_row(
        "wt_hoist@C180", feat_p, pk, feat_p[..., :c].float(),
        f32(dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, c,
                            (0.5, 0.5), torch.bfloat16)),
        src + "762 (_wt_hoist_planes)"))

    def decode_row(name, source, replaces, kern, plain, mp, tb, n_phase,
                   m_out):
        n_shift = len(dk.shift_offsets(net.local_size))
        mlp = n_shift * (6 * hid * hid + hid * dk_ + hid) + dk_ * hid \
            + 3 * hid * hid + hid * 3
        weights = (6 * hid * hid + 2 * hid * dk_ + 3 * hid * hid) * 2
        tab_bytes = sum(t.numel() * t.element_size() for t in tb.values())
        rows.append(kernel_row(
            name, source, replaces,
            lambda: kern(*mp[:6], mp[6], tb, net.softmax_scale),
            lambda: plain(*f32(mp[:6]), f32(mp[6]), tb, net.softmax_scale),
            2 * n_phase * m_out * mlp,
            m * (c * 2 + 2 * hid * 2 + 9 * (hid * 2 + 4)) + weights
            + tab_bytes + n_phase * m_out * 3 * 4, None, reps=3,
            same_bits=True))

    decode_row("grid_decode@C180", "ciaosr_torch/csrc/grid_decode_sm90.cu",
               src + "1329 (_grid_decode_halo)", dk.grid_decode,
               dk.grid_decode_plain, maps, tabs, 16, m)
    decode_row("grid_decode_rational@C180",
               "ciaosr_torch/csrc/grid_decode_sm90.cu",
               src + "1224 (grid_decode_fused_rational)",
               dk.grid_decode_rational, dk.grid_decode_rational_plain,
               maps_r, tabs_r, py * py, b * (h // qy) * (w // qy))
    return rows


def swin_route_checks(swin, lq: np.ndarray) -> None:
    """The SwinIR kernel route (bf16) against the plain f32 route (same
    seeded weights) at ×4 on SWIN_SMALL and SWIN_ODD crops: the encoder's
    features, the decoder's output without the bilinear residual (which
    both routes add in f32 and which dominates the output) and the
    output, each within REL_TOL."""
    from ciaosr_torch.models.restorers import CiaoSRRestorer
    from ciaosr_torch.ops.sampling import interpolate_bilinear

    ref = CiaoSRRestorer(dict(SWIN_002, dtype=None, use_kernels=False),
                         rgb_mean=RGB_MEAN, device="cuda", seed=0)
    for hw in (SWIN_SMALL, SWIN_ODD):
        x = torch.as_tensor(lq[:hw[0], :hw[1]], device="cuda")[None]
        xn = swin.normalize(x)
        with torch.inference_mode():
            base = interpolate_bilinear(xn, 4 * hw[0], 4 * hw[1])
            errs = {
                "encoder": errors(swin.generator.gen_feature(xn),
                                  ref.generator.gen_feature(xn)),
                "decoder without residual": errors(
                    swin.generator.decode_grid(xn, 4) - base,
                    ref.generator.decode_grid(xn, 4) - base)}
        errs["output"] = errors(swin.grid_predict(x, 4),
                                ref.grid_predict(x, 4))
        log(f"e2e SwinIR kernel route (bf16) vs plain route (f32), "
            f"{hw[0]}x{hw[1]} x4: " + "; ".join(
                f"{k} max|d|={a:.3e} max|d|/max|ref|={r:.3e}"
                for k, (a, r) in errs.items()))
        bad = {k: r for k, (_, r) in errs.items() if not r <= REL_TOL}
        if bad:
            raise AssertionError(f"SwinIR kernel route disagrees at "
                                 f"{hw[0]}x{hw[1]}: {bad}")


def f32_model_checks(drive, lq: np.ndarray, lq_s: np.ndarray) -> None:
    """Models with no compute dtype in their config (f32, as every shipped
    config) on the kernel route, which hands the kernels bf16: one flagship
    ×4 TILE² tile (grid_predict), the SwinIR SWIN_ODD request and config
    001 swinir's 72² request at ×4 and ×2.5 (forward_test, one tile each),
    each with
    its kernels launched and no other, against the same weights on the
    plain f32 route, max|Δ|/max|ref| ≤ REL_TOL."""
    from ciaosr_torch.models.restorers import CiaoSRRestorer

    def pair(cfg, **kw):   # (kernel route, plain route), one seed
        return [CiaoSRRestorer(dict(cfg, dtype=None, use_kernels=k),
                               rgb_mean=RGB_MEAN, device="cuda", seed=0,
                               **kw) for k in (True, False)]

    others = list(CSA_KERNELS) + list(BWD_KERNELS) + ["grid_decode_rational"]
    decode = ["f3p_build", "wt_hoist", "grid_decode"]
    flag = pair(FLAGSHIP)
    tile = torch.as_tensor(lq[:TILE, :TILE], device="cuda")[None]
    got, launches, _ = drive(
        f"f32 flagship x4 {TILE}x{TILE} tile (kernel route)",
        lambda: flag[0].grid_predict(tile, 4), decode + ["csa_stencil_fused"],
        [k for k in others if k != "csa_stencil_fused"]
        + ["swin_block", "conv3x3_f32"])
    checks = {f"flagship x4 {TILE}x{TILE}": (got, flag[1].grid_predict(tile,
                                                                       4))}
    del flag
    swin = pair(SWIN_002, test_cfg=SWIN_TEST_CFG)
    so = lq_s[:SWIN_ODD[0], :SWIN_ODD[1]]
    got, launches, _ = drive(
        "f32 SwinIR x4 {}x{} (kernel route)".format(*SWIN_ODD),
        lambda: swin[0].forward_test(so),
        decode + ["swin_block", "conv3x3_f32"], others)
    n_blocks = len(swin_blocks(swin[0].generator))
    n_convs = trunk_convs(dict(SWIN_002, dtype=None))
    if (launches["swin_block"], launches["conv3x3_f32"]) != (n_blocks,
                                                             n_convs):
        raise AssertionError(f"f32 SwinIR: {launches['swin_block']} Swin "
                             f"block launches, want {n_blocks}; "
                             f"{launches['conv3x3_f32']} f32 conv "
                             f"launches, want {n_convs}")
    checks["SwinIR x4 {}x{}".format(*SWIN_ODD)] = (
        torch.as_tensor(got), torch.as_tensor(swin[1].forward_test(so)))
    del swin
    s001 = pair(SWIN_001, test_cfg=SWIN_001_TEST_CFG)
    s72 = lq_s[:SET5_X4_EVEN[1][0], :SET5_X4_EVEN[1][1]]
    got, launches, _ = drive(
        "f32 001 swinir x4 72x72 (kernel route)",
        lambda: s001[0].forward_test(s72),
        decode + ["swin_block", "csa_attention", "conv3x3_f32"],
        [k for k in others if k != "csa_attention"])
    n_convs = trunk_convs(dict(SWIN_001, dtype=None))
    if (launches["swin_block"], launches["conv3x3_f32"]) != (n_blocks,
                                                             n_convs):
        raise AssertionError(f"f32 001 swinir: {launches['swin_block']} "
                             f"Swin block launches, want {n_blocks}; "
                             f"{launches['conv3x3_f32']} f32 conv "
                             f"launches, want {n_convs}")
    checks["001 swinir x4 72x72"] = (
        torch.as_tensor(got), torch.as_tensor(s001[1].forward_test(s72)))
    got, launches, _ = drive(
        "f32 001 swinir x2.5 72x72 (kernel route)",
        lambda: s001[0].forward_test(s72, scale=2.5),
        ["f3p_build", "wt_hoist", "grid_decode_rational", "swin_block",
         "csa_attention", "conv3x3_f32"],
        [k for k in others if k not in ("csa_attention",
                                        "grid_decode_rational")]
        + ["grid_decode"])
    if (launches["swin_block"], launches["conv3x3_f32"]) != (n_blocks,
                                                             n_convs):
        raise AssertionError(f"f32 001 swinir x2.5: {launches['swin_block']}"
                             f" Swin block launches, want {n_blocks}; "
                             f"{launches['conv3x3_f32']} f32 conv "
                             f"launches, want {n_convs}")
    checks["001 swinir x2.5 72x72"] = (
        torch.as_tensor(got),
        torch.as_tensor(s001[1].forward_test(s72, scale=2.5)))
    for name, (got, ref) in checks.items():
        a, r = errors(got, ref)
        log(f"e2e f32 model, kernel route vs plain f32 route, {name}: "
            f"max|d|={a:.3e} max|d|/max|ref|={r:.3e}")
        if not (got.shape == ref.shape and r <= REL_TOL):
            raise AssertionError(f"f32 model's kernel route disagrees at "
                                 f"{name}: {r:.3e}")


def log_launch_split(name: str, fn, kernel_names) -> dict:
    """The device time of each of ``fn``'s kernels (torch.profiler, by
    kernel name) over SPLIT_CALLS calls, after as many calls with the
    profiler warming up: logged a launch, with the launches seen, and a
    call (the basis of older logs) where the launches seen are a multiple
    of the calls, with the device kernels of no listed name.
    The profiler can miss launches, so a profile that missed some is taken
    again, up to SPLIT_TRIES times. Returns ms a launch by name (None where
    the profiler saw no launch)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    seen = {}

    def keep(prof):
        seen["evs"] = prof.key_averages()

    def a_call(t, n):
        return (f"{t / SPLIT_CALLS / 1e3:.3f} ms a call"
                if n and n % SPLIT_CALLS == 0 else "launches missed")

    for _ in range(SPLIT_TRIES):
        with torch.inference_mode(), profile(
                activities=[ProfilerActivity.CUDA], on_trace_ready=keep,
                schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            for _ in range(2):
                for _ in range(SPLIT_CALLS):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        evs = [e for e in seen["evs"] if e.device_type == DeviceType.CUDA]
        split = {k: [e for e in evs if k in e.key] for k in kernel_names}
        split = {k: (sum(e.device_time_total for e in hits),
                     sum(e.count for e in hits))
                 for k, hits in split.items()}
        if all(n and n % SPLIT_CALLS == 0 for _, n in split.values()):
            break
    log(f"kernel {name} by launch (profiler, {SPLIT_CALLS} calls): "
        + ", ".join(f"{k} {t / max(n, 1) / 1e3:.3f} ms x{n} ({a_call(t, n)})"
                    for k, (t, n) in split.items())
        + "; other device kernels: " + ", ".join(
            f"{e.key[:40]} x{e.count}" for e in evs
            if not any(k in e.key for k in kernel_names)))
    return {k: t / n / 1e3 if n else None for k, (t, n) in split.items()}


def swin001_inputs(sw, lq_s: np.ndarray, big: np.ndarray) -> dict:
    """The 001 swinir kernels' inputs per LR shape: from the seeded image
    the 192² tile and the 72² and 70² requests' tiles (the encoder's
    features, the CSA maps at the real widths (bf16), the decode kernels'
    maps at ×4 (``_kernel_maps``: zero-padded to (C, DC) = (192, 192)) and,
    for the 192² tile and 72², at ×2.5 (``maps25``)); from the seeded
    picture the SWIN_001_FULL full images (features and CSA maps)."""
    from ciaosr_torch.models.ciaosr import rational_cell

    net, out = sw.generator, {}
    x25 = [hw for hw in SWIN_001_X25 if hw != (SWIN_001_IMG,) * 2]
    with torch.inference_mode():
        for hw, img in [(hw, lq_s) for hw in (
                (SWIN_001_TILE, SWIN_001_TILE), SET5_X4_EVEN[1],
                SET5_X4_ODD[0])] + [(hw, big) for hw, _ in SWIN_001_FULL]:
            x = sw.normalize(torch.as_tensor(img[:hw[0], :hw[1]],
                                             device="cuda")[None])
            feat = net.gen_feature(x).contiguous()
            out[hw] = dict(feat=feat,
                           csa=net.cs_attn.stencil_inputs(feat, 2,
                                                          torch.bfloat16))
            if img is lq_s:
                out[hw]["maps"] = net._kernel_maps(feat, (0.5, 0.5))
            if hw == (SWIN_001_TILE,) * 2 or hw in x25:
                out[hw]["maps25"] = net._kernel_maps(feat, rational_cell(
                    *hw, hw[0] * 5 // 2, hw[1] * 5 // 2))
    return out


def check_swin001_kernels(sw, inputs: dict) -> list[dict]:
    """Config 001 swinir's kernel instances on its path's tensors: K4 on
    the 192² tile's CSA maps and row 7 on the 72² request's banks (at
    (Cr, C) = (96, 192)), K1, K2 and K3 at (C, DC) = (192, 192) on the 192²
    tile, K3 once more at the 70² request's odd width, row 10 at ×2.5 on
    the 192² tile and on 72², row 6 on the 192 × 512 and row 5 on the
    48 × 1024 full image's CSA maps (the wide pair over row blocks; row 6
    also over two other block plans, which must give the same bits). Each
    kernel (bf16, on the zero-padded maps) against its plain version (f32,
    same values) at the real widths; bounds count the function's work
    there."""
    from ciaosr_torch.models.ciaosr import rational_cell
    from ciaosr_torch.ops.kernels import csa_attention as ca
    from ciaosr_torch.ops.kernels import csa_stencil as st
    from ciaosr_torch.ops.kernels import decoder as dk
    from ciaosr_torch.ops.neighborhood import extract_patches_same

    net, hid, dt = sw.generator, 256, torch.bfloat16
    cs, ss = net.cs_attn.softmax_scale, net.softmax_scale
    at = "ciaosr_tpu/ops/pallas/"
    rows = []
    tile = inputs[(SWIN_001_TILE, SWIN_001_TILE)]
    match, keys, embed = tile["csa"]
    b, hp, wp, c = embed.shape
    cr = match.shape[-1]
    p_, l_ = hp * wp, keys.shape[1]
    padded = st.pad_maps(match, keys, embed)
    maps32 = f32((match, keys, embed))
    rows.append(kernel_row(
        "csa_stencil_fused@C180", "ciaosr_torch/csrc/csa_stencil_sm90.cu",
        at + "csa_attention.py:930 (csa_stencil_fused)",
        lambda: st.csa_stencil_fused(*padded, cs, 2),
        lambda: st.csa_stencil_fused_plain(*maps32, cs, 2),
        2 * b * p_ * l_ * (9 * cr + 4 * c),
        b * (p_ * cr * 2 + l_ * 9 * cr * 2 + p_ * c * 2 + 4 * p_ * c * 4),
        None, reps=3, crop=lambda y: y[..., :c]))

    match, keys, embed = inputs[SET5_X4_EVEN[1]]["csa"]
    p_, l_ = match.shape[1] * match.shape[2], keys.shape[1]
    mp, kp, ep = st.pad_maps(match, keys, embed)
    cp = ep.shape[-1]
    with torch.inference_mode():
        q = extract_patches_same(mp, 3, 1).contiguous()
        v = extract_patches_same(ep, 6, 2).contiguous()
        q32 = extract_patches_same(match.float(), 3, 1)
        v32 = extract_patches_same(embed.float(), 6, 2)
    k32 = keys.float()
    rows.append(kernel_row(
        "csa_attention@C180", "ciaosr_torch/csrc/csa_flash.cu",
        at + "csa_attention.py:65 (csa_attention)",
        lambda: ca.csa_attention(q, kp, v, cs),
        lambda: ca.csa_attention_plain(q32, k32, v32, cs),
        2 * b * p_ * l_ * (9 * cr + 36 * c),
        b * ((p_ + l_) * 9 * cr * 2 + l_ * 36 * c * 2 + p_ * 36 * c * 4),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kp, v, scale=cs),
        crop=lambda y: y.reshape(b, p_, 36, cp)[..., :c].reshape(b, p_, -1)))

    # the decode kernels' plain versions at the real widths: the kernels'
    # bf16 weights packed at 180 channels, the maps cropped to 180
    pk_r = f32(dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, c,
                               (0.5, 0.5), dt))
    feat_p, csa_p, gk, gv, wt, ck, pk = tile["maps"]
    m = feat_p.shape[0] * feat_p.shape[1] * feat_p.shape[2]
    fp = feat_p.shape[-1]
    feat_r, csa_r = feat_p[..., :c].float(), csa_p[..., :c].float()
    # K1's library yardstick: one cuDNN conv2d of [feature | csa] (CSA
    # weights on the centre tap) to gk and gv's 512 channels
    w_lib = torch.zeros(2 * hid, 2 * fp, 3, 3, device="cuda", dtype=dt)
    w_lib[:hid, :fp] = pk["wk0"].reshape(3, 3, fp, hid).permute(3, 2, 0, 1)
    w_lib[hid:, :fp] = pk["wvu"].reshape(3, 3, fp, hid).permute(3, 2, 0, 1)
    w_lib[hid:, fp:, 1, 1] = pk["wvc"].t()
    x_lib = torch.cat([feat_p, csa_p], -1).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    w_lib = w_lib.contiguous(memory_format=torch.channels_last)
    rows.append(kernel_row(
        "f3p_build@C180+csa", "ciaosr_torch/csrc/f3p_build.cu",
        at + "decoder_kernel.py:623 (_build_f3p)",
        lambda: dk.f3p_build(feat_p, csa_p, pk["wk0"], pk["wvu"], pk["wvc"]),
        lambda: dk.f3p_build_plain(feat_r, csa_r, pk_r["wk0"], pk_r["wvu"],
                                   pk_r["wvc"]),
        2 * m * (9 * c * 2 * hid + c * hid),
        m * 2 * c * 2 + (2 * 9 * c + c) * hid * 2 + m * 2 * hid * 2,
        lambda: torch.nn.functional.conv2d(x_lib, w_lib, padding=1)))
    rows.append(wt_row("wt_hoist@C180+csa", feat_p, pk, feat_r, pk_r,
                       at + "decoder_kernel.py:762 (_wt_hoist_planes)"))

    def decode_row(name, hw):
        feat_p, csa_p, gk, gv, wt, ck, pk = inputs[hw]["maps"]
        fb, fh, fw, _ = feat_p.shape
        m = fb * fh * fw
        tabs = dk.decoder_tables(4, fh, fw, net.local_size, feat_p.device)
        n_phase, n_shift = tabs["dys"].shape
        dv = 10 * c
        mlp = n_shift * (6 * hid * hid + hid * dv + hid) + dv * hid \
            + 3 * hid * hid + hid * 3
        weights = (9 * hid * hid + 2 * hid * dv) * 2
        tab_bytes = sum(t.numel() * t.element_size() for t in tabs.values())
        rows.append(kernel_row(
            name, "ciaosr_torch/csrc/grid_decode_sm90.cu",
            at + "decoder_kernel.py:1329 (_grid_decode_halo)"
            + ("" if fw % 8 == 0 else "; :255 (grid_decode_fused, "
               "assembly='stacked')"),
            lambda: dk.grid_decode(feat_p, csa_p, gk, gv, wt, ck, pk, tabs,
                                   ss),
            lambda: dk.grid_decode_plain(
                feat_p[..., :c].float(), csa_p[..., :c].float(), gk.float(),
                gv.float(), wt.float(), ck, pk_r, tabs, ss),
            2 * n_phase * m * mlp,
            m * (2 * c * 2 + 2 * hid * 2 + 9 * (hid * 2 + 4)) + weights
            + tab_bytes + n_phase * m * 3 * 4, None, reps=3,
            same_bits=True))

    decode_row("grid_decode@C180+csa", (SWIN_001_TILE, SWIN_001_TILE))
    odd = SET5_X4_ODD[0]
    decode_row("grid_decode@C180+csa@{}x{}".format(*odd), odd)

    # row 10 at (192, 192): x2.5 on the 192² tile and on 72² (25 phases of
    # (H/2) x (W/2)), against its plain version at the real widths
    def rational_row(name, hw):
        feat_p, csa_p, gk, gv, wt, ck, pk = inputs[hw]["maps25"]
        fb, fh, fw, _ = feat_p.shape
        m = fb * fh * fw
        tabs = dk.rational_tables(fh, fw, 5, 2, 5, 2, net.local_size,
                                  feat_p.device)
        n_phase, n_shift = 25, tabs["yk"].shape[1]
        m_out = fb * (fh // 2) * (fw // 2)
        pk_25 = f32(dk.pack_decoder(
            net.imnet_k, net.imnet_v, net.imnet_q, c,
            rational_cell(fh, fw, fh * 5 // 2, fw * 5 // 2), dt))
        dv = 10 * c
        mlp = n_shift * (6 * hid * hid + hid * dv + hid) + dv * hid \
            + 3 * hid * hid + hid * 3
        weights = (9 * hid * hid + 2 * hid * dv) * 2
        tab_bytes = sum(t.numel() * t.element_size() for t in tabs.values())
        rows.append(kernel_row(
            name, "ciaosr_torch/csrc/grid_decode_sm90.cu",
            at + "decoder_kernel.py:1224 (grid_decode_fused_rational)",
            lambda: dk.grid_decode_rational(feat_p, csa_p, gk, gv, wt, ck,
                                            pk, tabs, ss),
            lambda: dk.grid_decode_rational_plain(
                feat_p[..., :c].float(), csa_p[..., :c].float(), gk.float(),
                gv.float(), wt.float(), ck, pk_25, tabs, ss),
            2 * n_phase * m_out * mlp,
            m * (2 * c * 2 + 2 * hid * 2 + 9 * (hid * 2 + 4)) + weights
            + tab_bytes + n_phase * m_out * 3 * 4, None, reps=3,
            same_bits=True))

    rational_row("grid_decode_rational@C180+csa", (SWIN_001_TILE,) * 2)
    rational_row("grid_decode_rational@C180+csa@{}x{}".format(
        *SWIN_001_X25[1]), SWIN_001_X25[1])

    # rows 5 and 6 at (96, 192): the wide pair over row blocks (at most 2
    # GiB of scores each) on the full images' CSA maps; its bound is K4's
    for (hw, kern), wrap in zip(SWIN_001_FULL, (ca.csa_fused,
                                                st.csa_stencil)):
        match, keys, embed = inputs[hw]["csa"]
        p_, l_ = match.shape[1] * match.shape[2], keys.shape[1]
        padded = st.pad_maps(match, keys, embed)
        maps32 = f32((match, keys, embed))
        replaces = {"csa_fused": "csa_attention.py:447 (csa_fused)",
                    "csa_stencil": "csa_attention.py:687 (csa_stencil)"}
        rows.append(kernel_row(
            "{}@C180@{}x{}".format(kern, *hw),
            "ciaosr_torch/csrc/csa_stencil_sm90.cu", at + replaces[kern],
            lambda: wrap(*padded, cs, 2),
            lambda: (ca.csa_fused_plain if kern == "csa_fused"
                     else st.csa_stencil_plain)(*maps32, cs, 2),
            2 * b * p_ * l_ * (9 * cr + 4 * c),
            b * (p_ * cr * 2 + l_ * 9 * cr * 2 + p_ * c * 2
                 + 4 * p_ * c * 4),
            None, reps=3, crop=lambda y: y[..., :c]))
        if kern == "csa_fused":
            wide_blocked_bits(kern, padded, cs, rows[-1])
    return rows


def wide_blocked_bits(name: str, padded, cs: float, row: dict) -> None:
    """The wide pair at one geometry over three block plans: the default
    (at most 2 GiB of scores a block), blocks of at most 1 GiB and one
    block over the whole map. All three must give the same bits; the row
    gets the forced plans' launches and times (``ms_1GiB``,
    ``ms_one_block``: the blocked form's cost) and the peak memory of one
    call of each plan."""
    from ciaosr_torch.ops.kernels import csa_stencil as st

    hp, wp = padded[0].shape[1:3]
    plans = {"2GiB": st.SCORES_BUDGET, "1GiB": 1 << 30, "one_block": 1 << 40}
    outs, peaks = {}, {}
    with torch.inference_mode():
        for key, budget in plans.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            outs[key] = st.launch_stencil_sm90(name, *padded, cs, 2,
                                               budget=budget)
            torch.cuda.synchronize()
            peaks[key] = torch.cuda.max_memory_allocated() / 2 ** 30
        same = {k: torch.equal(o, outs["2GiB"]) for k, o in outs.items()}
        del outs
        for key in ("1GiB", "one_block"):
            row[f"ms_{key}"] = time_ms(lambda: st.launch_stencil_sm90(
                name, *padded, cs, 2, budget=plans[key]), reps=3, warm=1)
    blocks = {k: len(st.wide_blocks(1, hp, wp, v)) for k, v in plans.items()}
    row["blocks"] = blocks
    log(f"kernel {row['name']} by block plan: blocks {blocks}, peak memory "
        + ", ".join(f"{k} {v:.2f} GiB" for k, v in peaks.items())
        + f"; ms 2GiB {row['ms']:.3f}, 1GiB {row['ms_1GiB']:.3f}, one block "
        f"{row['ms_one_block']:.3f}; same bits as 2GiB {same}")
    if not all(same.values()):
        raise AssertionError(f"{row['name']}: block plans disagree: {same}")


def swin001_route_errors(sw, lq_s: np.ndarray, seed: int = 0) -> dict:
    """Config 001 swinir's kernel route (bf16, ``sw``) against its plain
    f32 route (the same weights: ``seed`` is ``sw``'s): on one
    SWIN_001_TILE² tile the encoder's features, the CSA output on the same
    (plain route's) features and the ×4 output (``grid_predict``), and the
    ×4 output of the 72² request (``forward_test``), each as (max|Δ|,
    max|Δ|/max|ref|)."""
    from ciaosr_torch.models.restorers import CiaoSRRestorer

    ref = CiaoSRRestorer(dict(SWIN_001, dtype=None, use_kernels=False),
                         rgb_mean=RGB_MEAN, test_cfg=SWIN_001_TEST_CFG,
                         device="cuda", seed=seed)
    t = SWIN_001_TILE
    x = torch.as_tensor(lq_s[:t, :t], device="cuda")[None]
    xn = sw.normalize(x)
    s72 = lq_s[:SET5_X4_EVEN[1][0], :SET5_X4_EVEN[1][1]]
    with torch.inference_mode():
        feat_ref = ref.generator.gen_feature(xn)
        errs = {
            f"{t}x{t} encoder": errors(sw.generator.gen_feature(xn),
                                       feat_ref),
            f"{t}x{t} CSA (K4)": errors(
                sw.generator.nl_feature(feat_ref, use_kernel=True),
                ref.generator.nl_feature(feat_ref, use_kernel=False)),
            f"{t}x{t} x4 output": errors(sw.grid_predict(x, 4),
                                         ref.grid_predict(x, 4))}
    errs["72x72 x4 forward_test (row 7)"] = errors(
        torch.as_tensor(sw.forward_test(s72)),
        torch.as_tensor(ref.forward_test(s72)))
    return errs


def swin001_route_checks(sw, lq_s: np.ndarray) -> None:
    """swin001_route_errors at seed 0, each within REL_TOL
    (``tools/swin001_route_spread.py`` reads them over several seeds)."""
    errs = swin001_route_errors(sw, lq_s)
    log("e2e 001 swinir kernel route (bf16) vs plain route (f32): "
        + "; ".join(f"{k} max|d|={a:.3e} max|d|/max|ref|={r:.3e}"
                    for k, (a, r) in errs.items()))
    bad = {k: r for k, (_, r) in errs.items() if not r <= REL_TOL}
    if bad:
        raise AssertionError(f"001 swinir kernel route disagrees: {bad}")


def trunk_convs(gen: dict) -> int:
    """Launches of the f32 conv kernel (``conv3x3_f32``) a trunk forward of
    the generator dict ``gen`` on the kernel route: a SwinIR that computes
    in f32 (no ``dtype``, as every shipped config) takes it for each
    RSTB's conv and conv_after_body (``models.swinir.trunk_conv``); other
    generators and dtypes launch none."""
    from ciaosr_torch.core.device import resolve_dtype

    enc = gen["encoder"]
    if enc["type"] != "SwinIR" or \
            resolve_dtype(gen.get("dtype")) != torch.float32:
        return 0
    return len(enc["depths"]) + 1


def expected_launches(images, scale, tile: int | None, c: int,
                      n_blocks: int = 0, overlap: int = 32,
                      convs: int = 0) -> dict:
    """Exact launches of requests on LR images of the shapes ``images`` at
    ``scale`` by a CSA generator of C = ``c`` channels (bf16): per LR tile
    (``predict_tiled``'s tiling at ``tile``, ``overlap``; with ``tile``
    None the whole image) ``n_blocks`` Swin block launches (none for a
    conv encoder) and ``convs`` of the f32 conv kernel (``trunk_convs``);
    the CSA middle csa_route picks at the tile's geometry
    (reflect-padded to even), row 7 once, K4 and rows 5-6 once at the
    flagship's widths or once a block of ``wide_blocks`` at 001 swinir's;
    K1 and K2 once; K3's integer or rational mode once."""
    from ciaosr_torch.models.csa import csa_route
    from ciaosr_torch.models.restorers import as_scale_fraction, tile_layout
    from ciaosr_torch.ops.kernels.csa_stencil import wide_blocks

    f = as_scale_fraction(scale)
    decode = "grid_decode" if f.denominator == 1 else "grid_decode_rational"
    want: dict = {}
    for h, w in images:
        tiles = [(h, w)]
        if tile:
            t, hs, ws = tile_layout(h, w, f, tile, overlap)
            tiles = [(t, t)] * (len(hs) * len(ws))
        for th, tw in tiles:
            hp, wp = th + th % 2, tw + tw % 2
            csa = CSA_MODE_KERNEL[csa_route(hp, wp, 2, c, c // 2, 2)]
            n_csa = 1 if csa == "csa_attention" or c <= 64 else len(
                wide_blocks(1, hp, wp))
            for k, n in ((csa, n_csa), ("f3p_build", 1), ("wt_hoist", 1),
                         (decode, 1), ("swin_block", n_blocks),
                         ("conv3x3_f32", convs)):
                if n:
                    want[k] = want.get(k, 0) + n
    return want


def swin001_expected(images, scale, tiled: bool, n_blocks: int) -> dict:
    """Config 001 swinir's exact launches (``expected_launches`` through
    its test_cfg, or with ``tiled`` False on whole images)."""
    return expected_launches(images, scale, SWIN_001_TILE if tiled else None,
                             SWIN_001["encoder"]["embed_dim"], n_blocks,
                             SWIN_001_TEST_CFG["tile_overlap"])


def u1_inputs(u1, lq: np.ndarray) -> dict:
    """The one-tap decode kernels' inputs from the seeded image on the
    edsr_u1 generator: the TILE² tile's maps at x4 (``int``) and x2.5
    (``rat``, 25 phases of 96²) and the ODD image's maps at x4 (``odd``),
    each (maps, tables) as ``_kernel_maps`` and the wrappers take them."""
    from ciaosr_torch.models.ciaosr import rational_cell
    from ciaosr_torch.ops.kernels import decoder as dk

    net, ls = u1.generator, u1.generator.local_size
    with torch.inference_mode():
        def feat(hw):
            return net.gen_feature(u1.normalize(torch.as_tensor(
                lq[:hw[0], :hw[1]], device="cuda")[None])).contiguous()

        f, fo = feat((TILE, TILE)), feat(ODD)
        return {
            "int": (net._kernel_maps(f, (0.5, 0.5)),
                    dk.decoder_tables(4, TILE, TILE, ls, f.device)),
            "rat": (net._kernel_maps(f, rational_cell(
                TILE, TILE, TILE * 5 // 2, TILE * 5 // 2)),
                dk.rational_tables(TILE, TILE, 5, 2, 5, 2, ls, f.device)),
            "odd": (net._kernel_maps(fo, (0.5, 0.5)),
                    dk.decoder_tables(4, *ODD, ls, f.device))}


def check_u1_kernels(u1, lq: np.ndarray) -> list[dict]:
    """The one-tap instances (DK = C = 64) on the edsr_u1 generator's
    path tensors, each (bf16) against its plain version (f32, the same
    values): K1 and K2 on a TILE² tile, K3 on it at x4 and on the ODD
    image (row 9), row 10 on the tile at x2.5. K1's library yardstick is
    one matmul of [feature | csa] by [[W_k0, W_vu], [0, W_vc]]: at one
    tap K1 is nothing else."""
    from ciaosr_torch.ops.kernels import decoder as dk

    inputs = u1_inputs(u1, lq)
    ss = u1.generator.softmax_scale
    (feature, csa, _, _, _, _, pk), tabs = inputs["int"]
    b, h, w, c = feature.shape
    dc, m, hid = csa.shape[-1], b * h * w, 256
    w_lib = torch.zeros(c + dc, 2 * hid, device="cuda", dtype=torch.bfloat16)
    w_lib[:c, :hid], w_lib[:c, hid:] = pk["wk0"], pk["wvu"]
    w_lib[c:, hid:] = pk["wvc"]
    x_lib = torch.cat([feature, csa], -1)
    at = "ciaosr_tpu/ops/pallas/decoder_kernel.py:"

    def k1():
        return dk.f3p_build(feature, csa, pk["wk0"], pk["wvu"], pk["wvc"])

    def k1_library():
        return torch.matmul(x_lib, w_lib)

    rows = [kernel_row(
        "f3p_build@u1", "ciaosr_torch/csrc/f3p_build.cu",
        at + "623 (_build_f3p; _f3p_kernel u_map mode :561)", k1,
        lambda: dk.f3p_build_plain(*f32((feature, csa, pk["wk0"], pk["wvu"],
                                         pk["wvc"]))),
        2 * m * (c * 2 * hid + dc * hid),
        m * (c + dc) * 2 + (2 * c + dc) * hid * 2 + m * 2 * hid * 2,
        k1_library, same_bits=True)]
    k1_device_split(rows[0], k1, k1_library)
    rows.append(wt_row("wt_hoist@u1", feature, pk, feature.float(), f32(pk),
                       at + "762 (_wt_hoist_planes, dk = C)"))
    rows.append(decode_row("grid_decode@u1", DECODE_REPLACES[False],
                           *inputs["int"], False, ss))
    rows.append(decode_row("grid_decode@u1@{}x{}".format(*ODD),
                           DECODE_REPLACES["odd"], *inputs["odd"], False, ss))
    rows.append(decode_row("grid_decode_rational@u1", DECODE_REPLACES[True],
                           *inputs["rat"], True, ss))
    return rows


def time_u1_kernels(times: dict, u1, lq: np.ndarray) -> None:
    """The one-tap instances' times into ``times``, on the maps
    check_u1_kernels holds."""
    from ciaosr_torch.ops.kernels import decoder as dk

    inputs = u1_inputs(u1, lq)
    ss = u1.generator.softmax_scale
    (feature, csa, _, _, _, _, pk), _ = inputs["int"]
    with torch.inference_mode():
        times["f3p_build@u1"] = time_ms(lambda: dk.f3p_build(
            feature, csa, pk["wk0"], pk["wvu"], pk["wvc"]), reps=20)
        times["wt_hoist@u1"] = time_ms(lambda: dk.wt_hoist(
            feature, pk["wkout"], pk["bkout"]), reps=20)
        for name, key, fn in (
                ("grid_decode@u1", "int", dk.grid_decode),
                ("grid_decode@u1@{}x{}".format(*ODD), "odd", dk.grid_decode),
                ("grid_decode_rational@u1", "rat",
                 dk.grid_decode_rational)):
            maps, tabs = inputs[key]
            times[name] = time_ms(lambda: fn(*maps, tabs, ss), reps=5)


def edsr_phases(drive, check_image,
                lq: np.ndarray) -> tuple[list, dict, dict]:
    """Config 001 edsr (phase "edsr", as shipped) and its generator
    without the unfold (phase "edsr_u1"), full width, bf16, seeded random
    weights: each request of EDSR_REQUESTS / U1_REQUESTS on the seeded
    image with exactly the launches expected_launches counts and no
    other, its output checked and held against the plain f32 route of the
    same weights (max|d|/max|ref| <= REL_TOL); the one-tap kernel rows
    (check_u1_kernels); then one f32-model request (the config without
    ``dtype``) on a TILE² tile through the one-tap kernels, against the
    plain f32 route. Returns the one-tap rows, each kernel row's launches
    over both phases (the nine-tap phase's go to the flagship's rows: the
    same compiled instances) and the two phases' kernel-route restorers."""
    from ciaosr_torch.models.restorers import CiaoSRRestorer
    from ciaosr_torch.ops import kernels

    csa_rows = {"csa_stencil_fused": "csa_stencil_fused",
                "csa_attention": "csa_attention@{}x{}".format(*SET5[0])}
    row_launches: dict = {}
    u1_rows: list = []
    restorers: dict = {}
    for phase, cfg, requests in (("edsr", EDSR_001, EDSR_REQUESTS),
                                 ("edsr_u1", EDSR_U1, U1_REQUESTS)):
        suffix = "" if cfg["feat_unfold"] else "@u1"
        gens = [CiaoSRRestorer(dict(cfg, **kw), rgb_mean=RGB_MEAN,
                               test_cfg=EDSR_TEST_CFG, device="cuda", seed=0)
                for kw in ({}, dict(dtype=None, use_kernels=False))]
        t0 = time.perf_counter()
        for name, hw, scale, how in requests:
            img = lq[:hw[0], :hw[1]]
            tiled = how == "tiled"
            want = expected_launches([hw], scale, TILE if tiled else None,
                                     EDSR_001["encoder"]["mid_channels"],
                                     overlap=EDSR_TEST_CFG["tile_overlap"])
            out_hw = hr(hw, scale)

            def run(r):
                if tiled:
                    return r.forward_test(img, scale=scale)
                return r.predict(img, out_hw[:2])

            label = "{} {} {}x{} ({})".format(phase, name, *hw, how)
            out, launches, _ = drive(
                f"{label}, want {want}", lambda: run(gens[0]), list(want),
                [k for k in kernels.LAUNCHES if k not in want])
            got = {k: launches[k] for k in want}
            if got != want:
                raise AssertionError(f"path {label}: launches {got}, want "
                                     f"{want}")
            check_image(label, out, out_hw)
            a, r = errors(torch.as_tensor(out), torch.as_tensor(run(gens[1])))
            log(f"e2e {label}: kernel route (bf16) vs plain route (f32) "
                f"max|d|={a:.3e} max|d|/max|ref|={r:.3e}")
            if not r <= REL_TOL:
                raise AssertionError(f"{label}: kernel route disagrees: "
                                     f"{r:.3e}")
            tile_w = min(TILE, *hw) if tiled else hw[1]
            for k, n in got.items():
                row = csa_rows.get(k, k + suffix)
                if k == "grid_decode" and tile_w % 8:   # row 9's odd width
                    row += "@{}x{}".format(*ODD)
                row_launches[row] = row_launches.get(row, 0) + n
        log(f"phase {phase}: {time.perf_counter() - t0:.1f} s for "
            f"{len(requests)} requests, kernel and plain routes")
        if suffix:
            u1_rows = check_u1_kernels(gens[0], lq)
            f32k = CiaoSRRestorer(dict(cfg, dtype=None), rgb_mean=RGB_MEAN,
                                  device="cuda", seed=0)
            tile = torch.as_tensor(lq[:TILE, :TILE], device="cuda")[None]
            ran = ["csa_stencil_fused", "f3p_build", "wt_hoist",
                   "grid_decode"]
            got, launches, _ = drive(
                f"edsr_u1 f32 model x4 {TILE}x{TILE} tile (kernel route)",
                lambda: f32k.grid_predict(tile, 4), ran,
                [k for k in kernels.LAUNCHES if k not in ran])
            if any(launches[k] != 1 for k in ran):
                raise AssertionError(f"edsr_u1 f32 model: launches "
                                     f"{launches}, want one of each {ran}")
            for k in ran:
                row = csa_rows.get(k, k + suffix)
                row_launches[row] = row_launches.get(row, 0) + 1
            a, r = errors(got, gens[1].grid_predict(tile, 4))
            log(f"e2e f32 model, kernel route vs plain f32 route, edsr_u1 "
                f"x4 {TILE}x{TILE}: max|d|={a:.3e} max|d|/max|ref|={r:.3e}")
            if not r <= REL_TOL:
                raise AssertionError(f"edsr_u1 f32 model's kernel route "
                                     f"disagrees: {r:.3e}")
            del f32k
        restorers[phase] = gens[0]
        del gens
    return u1_rows, row_launches, restorers


def swin_u1_restorers(plain: bool = True) -> dict:
    """The SwinIR generators without the unfold, seeded, each with its
    config's test_cfg: {"002": [kernel route, plain f32 route], "001":
    [...]} (the plain route only with ``plain``)."""
    from ciaosr_torch.models.restorers import CiaoSRRestorer

    kws = [{}] + ([dict(dtype=None, use_kernels=False)] if plain else [])
    return {key: [CiaoSRRestorer(dict(cfg, **kw), rgb_mean=RGB_MEAN,
                                 test_cfg=test_cfg, device="cuda", seed=0)
                  for kw in kws]
            for key, cfg, test_cfg in (
                ("002", SWIN_002_U1, SWIN_TEST_CFG),
                ("001", SWIN_001_U1, SWIN_001_TEST_CFG))}


def swin_u1_row(kernel: str, key: str, kind: str = "int") -> str:
    """The kernel row of a one-tap C = 192 instance: ``kernel`` on
    generator ``key``'s tile (K3 with ``kind`` "rat": its rational mode;
    "odd": its odd-width request)."""
    name = "grid_decode_rational" if kind == "rat" else kernel
    name += "@C180@u1" if key == "002" else "@C180+csa@u1"
    return name + ("@{}x{}".format(*SWIN_U1_ODD) if kind == "odd" else "")


def swin_u1_inputs(gens: dict, lq_s: np.ndarray) -> dict:
    """The one-tap C = 192 kernels' inputs on the first tile of each
    SWIN_U1_REQUESTS request: {(generator, kind): (maps, tables)}, kind
    "int" (x4) and "rat" (x2.5: 25 phases of (H/2) x (W/2)) on the 002
    SWIN_TILE² and the 001 SWIN_001_TILE² tile, "odd" (x4) on the 60 x 47
    request's first 47² tile; the maps as ``_kernel_maps`` gives them
    (zero-padded to (192, 0) and (192, 192))."""
    from ciaosr_torch.models.ciaosr import rational_cell
    from ciaosr_torch.ops.kernels import decoder as dk

    out = {}
    with torch.inference_mode():
        for key, t, kinds in (("002", SWIN_TILE, ("int", "rat")),
                              ("001", SWIN_001_TILE, ("int", "rat")),
                              ("001", min(SWIN_U1_ODD), ("odd",))):
            r = gens[key][0]
            net, ls = r.generator, r.generator.local_size
            feat = net.gen_feature(r.normalize(torch.as_tensor(
                lq_s[:t, :t], device="cuda")[None])).contiguous()
            for kind in kinds:
                if kind == "rat":
                    out[key, kind] = (
                        net._kernel_maps(feat, rational_cell(
                            t, t, t * 5 // 2, t * 5 // 2)),
                        dk.rational_tables(t, t, 5, 2, 5, 2, ls,
                                           feat.device))
                else:
                    out[key, kind] = (
                        net._kernel_maps(feat, (0.5, 0.5)),
                        dk.decoder_tables(4, t, t, ls, feat.device))
    return out


def check_swin_u1_kernels(gens: dict, inputs: dict) -> list[dict]:
    """The one-tap instances at C = 192 on the SwinIR generators' path
    tensors (``swin_u1_inputs``): K1 and K2 on the x4 tile of each, K3 on
    it, row 9 on the 001 generator's 47² tile, row 10 on each x2.5 tile.
    Each kernel (bf16, on the zero-padded maps) against its plain version
    (f32, same values) at the real widths (the kernels' bf16 weights
    packed at 180 channels, the maps cropped); bounds count the function's
    work there. K1's library yardstick is one matmul of [feature | csa] by
    [[W_k0, W_vu], [0, W_vc]]: at one tap K1 is nothing else."""
    from ciaosr_torch.models.ciaosr import rational_cell
    from ciaosr_torch.ops.kernels import decoder as dk

    hid, dt, c = 256, torch.bfloat16, 180
    at = "ciaosr_tpu/ops/pallas/decoder_kernel.py:"
    rows = []
    for key in ("002", "001"):
        net = gens[key][0].generator
        ss = net.softmax_scale

        def packed(cell):   # the kernels' bf16 weights at 180 channels
            return f32(dk.pack_decoder(net.imnet_k, net.imnet_v,
                                       net.imnet_q, c, cell, dt))

        (feat_p, csa_p, _, _, _, _, pk), _ = inputs[key, "int"]
        dc = 0 if csa_p is None else c
        m = feat_p.shape[0] * feat_p.shape[1] * feat_p.shape[2]
        feat_r = feat_p[..., :c].float()
        csa_r = None if csa_p is None else csa_p[..., :c].float()
        pk_r = packed((0.5, 0.5))
        fp = feat_p.shape[-1]
        x_lib = feat_p if csa_p is None else torch.cat([feat_p, csa_p], -1)
        w_lib = torch.zeros(x_lib.shape[-1], 2 * hid, device="cuda",
                            dtype=dt)
        w_lib[:fp, :hid], w_lib[:fp, hid:] = pk["wk0"], pk["wvu"]
        w_lib[fp:, hid:] = pk["wvc"]
        def k1():
            return dk.f3p_build(feat_p, csa_p, pk["wk0"], pk["wvu"],
                                pk["wvc"])

        def k1_library():
            return torch.matmul(x_lib, w_lib)

        rows.append(kernel_row(
            swin_u1_row("f3p_build", key), "ciaosr_torch/csrc/f3p_build.cu",
            at + "623 (_build_f3p; _f3p_kernel u_map mode :561)", k1,
            lambda: dk.f3p_build_plain(feat_r, csa_r, pk_r["wk0"],
                                       pk_r["wvu"], pk_r["wvc"]),
            2 * m * (c * 2 * hid + dc * hid),
            m * (c + dc) * 2 + (2 * c + dc) * hid * 2 + m * 2 * hid * 2,
            k1_library, same_bits=True))
        k1_device_split(rows[-1], k1, k1_library)
        rows.append(wt_row(swin_u1_row("wt_hoist", key), feat_p, pk, feat_r,
                           pk_r, at + "762 (_wt_hoist_planes, dk = C)"))
        del x_lib, w_lib
        for kind in (("int", "rat") if key == "002" else
                     ("int", "odd", "rat")):
            (fp_, cp_, gk, gv, wt, ck, pk_), tabs = inputs[key, kind]
            fb, fh, fw, _ = fp_.shape
            m_ = fb * fh * fw
            if kind == "rat":
                kern, plain = dk.grid_decode_rational, \
                    dk.grid_decode_rational_plain
                pk_c = packed(rational_cell(fh, fw, fh * 5 // 2,
                                            fw * 5 // 2))
                n_phase, n_shift = 25, tabs["yk"].shape[1]
                m_out = fb * (fh // 2) * (fw // 2)
                replaces = DECODE_REPLACES[True]
            else:
                kern, plain, pk_c = dk.grid_decode, dk.grid_decode_plain, \
                    pk_r
                (n_phase, n_shift), m_out = tabs["dys"].shape, m_
                replaces = DECODE_REPLACES["odd" if kind == "odd" else False]
            dv = c + dc
            mlp = n_shift * (6 * hid * hid + hid * dv + hid) + dv * hid \
                + 3 * hid * hid + hid * 3
            weights = (9 * hid * hid + 2 * hid * dv) * 2
            tab_bytes = sum(t.numel() * t.element_size()
                            for t in tabs.values())
            rows.append(kernel_row(
                swin_u1_row("grid_decode", key, kind),
                "ciaosr_torch/csrc/grid_decode_sm90.cu", replaces,
                lambda: kern(fp_, cp_, gk, gv, wt, ck, pk_, tabs, ss),
                lambda: plain(fp_[..., :c].float(),
                              None if cp_ is None else cp_[..., :c].float(),
                              gk.float(), gv.float(), wt.float(), ck, pk_c,
                              tabs, ss),
                2 * n_phase * m_out * mlp,
                m_ * ((c + dc) * 2 + 2 * hid * 2 + 9 * (hid * 2 + 4))
                + weights + tab_bytes + n_phase * m_out * 3 * 4, None,
                reps=3, same_bits=True))
    return rows


def time_swin_u1_kernels(times: dict, gens: dict, lq_s: np.ndarray) -> None:
    """The one-tap C = 192 instances' times into ``times``, on the maps
    check_swin_u1_kernels holds."""
    from ciaosr_torch.ops.kernels import decoder as dk

    inputs = swin_u1_inputs(gens, lq_s)
    with torch.inference_mode():
        for key in ("002", "001"):
            (feat_p, csa_p, _, _, _, _, pk), _ = inputs[key, "int"]
            times[swin_u1_row("f3p_build", key)] = time_ms(
                lambda: dk.f3p_build(feat_p, csa_p, pk["wk0"], pk["wvu"],
                                     pk["wvc"]), reps=20)
            times[swin_u1_row("wt_hoist", key)] = time_ms(
                lambda: dk.wt_hoist(feat_p, pk["wkout"], pk["bkout"]),
                reps=20)
        for (key, kind), (maps, tabs) in inputs.items():
            fn = dk.grid_decode_rational if kind == "rat" else \
                dk.grid_decode
            ss = gens[key][0].generator.softmax_scale
            times[swin_u1_row("grid_decode", key, kind)] = time_ms(
                lambda: fn(*maps, tabs, ss), reps=3, warm=1)


def swin_u1_phase(drive, check_image,
                  lq_s: np.ndarray) -> tuple[list, dict, dict]:
    """The SwinIR generators without the unfold (phase "swinir_u1"), full
    width and depth, bf16, seeded random weights: the one-tap C = 192
    kernel rows (check_swin_u1_kernels), then each SWIN_U1_REQUESTS
    request through forward_test and its config's test_cfg with exactly
    the launches its tiling gives (36 Swin blocks, K1, K2 and K3's integer
    or rational mode a tile; for the 001 generator the CSA middle
    csa_route picks) and no other, its output checked and held against
    the plain f32 route of the same weights (max|d|/max|ref| <= REL_TOL).
    Returns the rows, the launches by kernel row (the 002 tiles' Swin
    blocks under row 11's 256² row; the 001 tiles' 192² and 47² Swin
    blocks have no row of their shape) and the kernel-route restorers."""
    from ciaosr_torch.models.restorers import tile_layout
    from ciaosr_torch.ops import kernels

    t0 = time.perf_counter()
    gens = swin_u1_restorers()
    rows = check_swin_u1_kernels(gens, swin_u1_inputs(gens, lq_s))
    log(f"phase swinir_u1: kernel rows {time.perf_counter() - t0:.1f} s")
    n_blocks = len(swin_blocks(gens["002"][0].generator))
    csa_rows = {"csa_stencil_fused": "csa_stencil_fused@C180",
                "csa_attention": "csa_attention@C180"}
    by_row: dict = {}
    for key, name, hw, scale in SWIN_U1_REQUESTS:
        kern_r, plain_r = gens[key]
        cfg = kern_r.test_cfg
        t, hs, ws = tile_layout(*hw, scale, cfg["tile"], cfg["tile_overlap"])
        if key == "001":
            want = swin001_expected([hw], scale, True, n_blocks)
        else:
            decode = "grid_decode" if scale == 4 else "grid_decode_rational"
            n = len(hs) * len(ws)
            want = {"swin_block": n_blocks * n, "f3p_build": n,
                    "wt_hoist": n, decode: n}
        img = lq_s[:hw[0], :hw[1]]
        label = "swinir_u1 {} {} {}x{} ({} tiles of {})".format(
            key, name, *hw, len(hs) * len(ws), t)
        out, launches, secs = drive(
            f"{label}, want {want}",
            lambda: kern_r.forward_test(img, scale=scale), list(want),
            [k for k in kernels.LAUNCHES if k not in want])
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"path {label}: launches {got}, want "
                                 f"{want}")
        check_image(label, out, hr(hw, scale))
        a, r = errors(torch.as_tensor(out), torch.as_tensor(
            plain_r.forward_test(img, scale=scale)))
        hw_out = hr(hw, scale)
        log(f"e2e {label}: {secs * 1e3:.1f} ms, "
            f"{hw_out[0] * hw_out[1] / 1e3 / (secs * 1e3):.3f} MP/s (the "
            f"path's call); kernel route (bf16) vs plain route (f32) "
            f"max|d|={a:.3e} max|d|/max|ref|={r:.3e}")
        if not r <= REL_TOL:
            raise AssertionError(f"{label}: kernel route disagrees: "
                                 f"{r:.3e}")
        for k, n in got.items():
            if k == "swin_block":
                row = f"swin_block@{t}x{t}" if key == "002" else None
            elif k in csa_rows:
                row = csa_rows[k]
            else:   # row 9's odd width: K3's launches at W % 8 != 0
                odd = k == "grid_decode" and t % 8
                row = swin_u1_row(k, key, "odd" if odd else "int")
            if row:
                by_row[row] = by_row.get(row, 0) + n
    log(f"phase swinir_u1: {time.perf_counter() - t0:.1f} s for "
        f"{len(SWIN_U1_REQUESTS)} requests, kernel and plain routes")
    return rows, by_row, {key: g[0] for key, g in gens.items()}


def hr(hw, s=4):
    """The HR shape of an LR (H, W) at scale s."""
    return (round(s * hw[0]), round(s * hw[1]), 3)


def swin_breakdown(swin, lq_tile: torch.Tensor) -> None:
    """Where one SWIN_TILE² tile's ×4 time goes: CUDA-event time per stage
    of the kernel route (the 36 Swin blocks, the convs and LayerNorms
    around them, weight packing, K1, K2, K3) and the whole tile."""
    from ciaosr_torch.models.rdn import conv
    from ciaosr_torch.ops.kernels import decoder as dk
    from ciaosr_torch.ops.kernels import swin_block as sb

    net, dt = swin.generator, torch.bfloat16
    enc, blocks = net.encoder, swin_blocks(swin.generator)
    with torch.inference_mode():
        x = swin.normalize(lq_tile)
        tok, skip = enc.embed(x, dt)
        feature = net.gen_feature(x)
        feat_p, _, gk, gv, wt, ck, pk = net._kernel_maps(feature,
                                                         (0.5, 0.5))
        h, w = feature.shape[1:3]
        tabs = dk.decoder_tables(4, h, w, net.local_size, feature.device)

        def all_blocks():
            t = tok
            for blk in blocks:
                t = blk(t, dt, True)
            return t

        def convs_and_norms():   # the encoder without its Swin blocks
            t, sk = enc.embed(x, dt)
            for layer in enc.layers:
                t = conv(t.permute(0, 3, 1, 2), layer.conv, dt).permute(
                    0, 2, 3, 1) + t
            return enc.head(t, sk, h, w, dt)

        stages = {
            f"Swin blocks ({len(blocks)} kernels + rolls)": all_blocks,
            "convs + LayerNorms (cuDNN bf16)": convs_and_norms,
            f"pack weights ({len(blocks)} Swin blocks + decoder, host)":
                lambda: ([sb.pack_swin_block(blk, enc.window_size, dt)
                          for blk in blocks],
                         dk.pack_decoder(net.imnet_k, net.imnet_v,
                                         net.imnet_q, feature.shape[-1],
                                         (0.5, 0.5), dt,
                                         c_pad=feat_p.shape[-1])),
            "K1 f3p_build@C180": lambda: dk.f3p_build(
                feat_p, None, pk["wk0"], pk["wvu"], pk["wvc"]),
            "K2 wt_hoist@C180": lambda: dk.wt_hoist(feat_p, pk["wkout"],
                                                    pk["bkout"]),
            "K3 grid_decode@C180": lambda: dk.grid_decode(
                feat_p, None, gk, gv, wt, ck, pk, tabs, net.softmax_scale),
            "whole tile (grid_predict x4)": lambda: swin.grid_predict(
                lq_tile, 4),
        }
        for name, fn in stages.items():
            log(f"stage SwinIR {name}: {time_ms(fn, reps=3, warm=1):.3f} ms")


def train_batch(rng, b: int, lr: int, q_side: int) -> dict:
    """A seeded batch on the card: LR patches uniform in [0, 1], and per
    sample a q_side × q_side block of the ×4 HR grid's coords and cells
    (make_coord_cell) at a random offset, gt uniform in [0, 1]."""
    from ciaosr_torch.core.coords import make_coord_cell

    coord, cell = make_coord_cell((4 * lr, 4 * lr))
    coord = coord.reshape(4 * lr, 4 * lr, 2)
    cs = []
    for _ in range(b):
        i, j = rng.integers(0, 4 * lr - q_side + 1, size=2)
        cs.append(coord[i:i + q_side, j:j + q_side].reshape(-1, 2))
    dev = dict(device="cuda")
    return dict(lq=torch.as_tensor(rng.random((b, lr, lr, 3),
                                              dtype=np.float32), **dev),
                gt=torch.as_tensor(rng.random((b, q_side ** 2, 3),
                                              dtype=np.float32), **dev),
                coord=torch.stack(cs).to(**dev),
                cell=cell[:q_side ** 2].expand(b, -1, -1).contiguous().to(
                    **dev))


def check_swin_wgrad(x, dy, pk, ws: int, shift: int, hid: int) -> dict:
    """Row 12's weight-gradient kernel alone, on the pairs that the window
    kernel writes for the block at x (C = x's last width, hid hidden
    units): its chunk partials summed against ``swin_block_wgrad_plain`` on
    the same pairs (≤ WGRAD_TOL), the same bits on two launches; CUDA-event
    times of the kernel, its plain version and four ``torch.matmul(a.t(),
    b)`` calls (the library yardstick, never called by the port); its own
    bound: the function's bytes and FLOPs at the real widths (each pair's
    real columns of the B·H·W tokens read once, the real weight gradients
    written once), the design's extra traffic (padded columns and rows,
    the chunk partials) logged beside it. Returns its row of the kernels
    line."""
    from ciaosr_torch.ops.kernels import swin_block as sb

    b, h, w, c = x.shape
    real = {sb.CP: c, 3 * sb.CP: 3 * c, sb.HIDP: hid}
    with torch.inference_mode():
        pairs = sb.launch_swin_bwd_window(x, dy, pk, ws, shift)[1]
        part = sb.swin_block_wgrad(pairs)
        same = torch.equal(part, sb.swin_block_wgrad(pairs))
        ref = sb.swin_block_wgrad_plain(pairs)
        abs_err, err = errors(part.sum(0), ref)
        t = pairs[0].shape[0]
        ld = sum(real[r] * real[cl] for _, (r, cl) in sb._MATRICES)
        flops = 2 * b * h * w * ld
        nbytes = (2 * b * h * w * sum(real[wd] for _, wd in sb._PAIRS)
                  + 4 * ld)
        design_bytes = sum(p.numel() * 2 for p in pairs) + part.numel() * 4
        del part, ref
        ms = time_ms(lambda: sb.swin_block_wgrad(pairs))
        plain_ms = time_ms(lambda: sb.swin_block_wgrad_plain(pairs), reps=3,
                           warm=1)
        lib_ms = time_ms(lambda: [torch.matmul(a.t(), g) for a, g in
                                  zip(pairs[0::2], pairs[1::2])])
    bms, by = bound_ms(flops, nbytes)
    name = f"swin_block_wgrad@{b}x{h}x{w}"
    log(f"kernel {name}: T={t}, {sb.WGRAD_SPLITS} chunks, "
        f"max|d|={abs_err:.3e} max|d|/max|ref|={err:.3e}, reproducible "
        f"{same}; ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms "
        f"(4 x torch.matmul)={lib_ms:.4f}; bound {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP: {bms:.4f} ms ({by}); the design moves "
        f"{design_bytes / 1e6:.1f} MB (padded pairs, chunk partials): "
        f"{design_bytes / PEAK_BYTES * 1e3:.4f} ms")
    if not (err <= WGRAD_TOL and same):
        raise AssertionError(f"{name}: error {err:.3e} > {WGRAD_TOL} or "
                             f"reproducible {same}")
    return dict(name=name, route="cuda",
                source="ciaosr_torch/csrc/swin_block_bwd_sm90.cu",
                replaces="ciaosr_tpu/ops/pallas/swin_block.py:220 "
                         "(_block_bwd_kernel's _mm_at sums, :220, :224, "
                         ":232, :276-278)",
                launches=0, max_abs_err=abs_err, max_rel_err=err,
                tol_rel=WGRAD_TOL, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms, tflops=tflops(flops, ms),
                reproducible=True)


def check_swin_bwd(swin, batch: dict) -> tuple[dict, dict]:
    """Row 12 on the training batch's first-group tokens (TRAIN_B, 64, 64,
    180): the first, unshifted block and the second, shifted one on the
    first's output, with a seeded dy and the same bf16 packed weights in
    both versions; the kernel against the f32 plain version (autograd
    through the plain block): dx - dy ≤ BWD_TOL_DX and each packed
    gradient ≤ BWD_TOL_PARAM (max|Δ|/max|ref|), the sums reproducible run
    to run. CUDA-event times of both; ``ms`` is the shifted block's. Then
    the weight-gradient kernel alone on the shifted block's pairs
    (``check_swin_wgrad``). Returns row 12's row and that kernel's."""
    from ciaosr_torch.ops.kernels import swin_block as sb

    net, dt = swin.generator, torch.bfloat16
    blk0, blk1 = swin_blocks(net)[:2]
    with torch.no_grad():
        tok0 = net.encoder.embed(swin.normalize(batch["lq"]), dt)[0]
        tok0 = tok0.contiguous()
        b, h, w, c = tok0.shape
        ws, shift = blk1.geometry(h, w)
        tok1 = torch.roll(blk0(tok0, dt, True), (-shift, -shift),
                          (1, 2)).contiguous()
    dy = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (b, h, w, c)).astype(np.float32), device="cuda")
    hid = blk0.mlp.fc1.out_features
    heads, n_ = blk0.attn.num_heads, ws * ws
    t_ = b * h * w
    fwd = 2 * t_ * c * (4 * c + 2 * hid) + 4 * t_ * n_ * c
    n_par = 4 * c * c + 2 * c * hid + 9 * c + hid
    nbytes = (3 * t_ * c * 4 + (4 * c * c + 2 * c * hid) * 2
              + (9 * c + hid) * 4 + 2 * heads * n_ * n_ * 4 + n_par * 4)
    bms, by = bound_ms(3 * fwd, nbytes)
    # the window kernel alone (swin_bwd_sm90): x and dy in; dx, the bf16
    # pairs (NT rows a window) and the f32 partial rows out; the recompute
    # and the data products
    nwin = t_ // (ws * ws)
    win_bytes = (3 * t_ * c * 4 + nwin * sb.NT * 2 * sum(
        width for _, width in sb._PAIRS) + nwin * 4 * (
        sum(size for _, size in sb._VECTORS) + heads * n_ * n_))
    wbms, wby = bound_ms(2 * fwd, win_bytes)
    log(f"kernel swin_bwd_sm90 (row 12's window kernel) bound: "
        f"{win_bytes / 1e6:.1f} MB, {2 * fwd / 1e9:.2f} GFLOP: {wbms:.4f} ms "
        f"({wby})")
    # the sum kernel alone (swin_gsum_kernel): the window partials and the
    # chunk partials in, the summed row out
    lw = sum(size for _, size in sb._VECTORS) + heads * n_ * n_
    ld = sum(r * cl for _, (r, cl) in sb._MATRICES)
    sum_bytes = 4 * (nwin * lw + sb.WGRAD_SPLITS * ld + lw + ld)
    sbms, _ = bound_ms(0, sum_bytes)
    log(f"kernel swin_gsum_kernel (row 12's sum) bound: "
        f"{sum_bytes / 1e6:.1f} MB: {sbms:.4f} ms (bytes)")
    row = dict(name=f"swin_block_bwd@{b}x{h}x{w}", route="cuda",
               source="ciaosr_torch/csrc/swin_block_bwd_sm90.cu",
               replaces="ciaosr_tpu/ops/pallas/swin_block.py:290 "
                        "(_swin_block_bwd_call)",
               launches=0, max_abs_err=0.0, max_rel_err=0.0,
               max_rel_err_dx=0.0, tol_rel=BWD_TOL_PARAM,
               tol_rel_dx=BWD_TOL_DX, bound_ms=bms, bound_by=by,
               window_bound_ms=wbms, gsum_bound_ms=sbms,
               library_ms=None)
    for tok, blk, sh, tag in ((tok1, blk1, shift, ""),
                              (tok0, blk0, 0, "_noshift")):
        pk = blk.packed(ws, dt)
        dx, g = sb.swin_block_bwd(tok, dy, pk, ws, sh)
        dx2, g2 = sb.swin_block_bwd(tok, dy, pk, ws, sh)
        torch.cuda.synchronize()
        same = torch.equal(dx, dx2) and all(torch.equal(g[k], g2[k])
                                            for k in g)
        rdx, rg = sb.swin_block_bwd_plain(tok, dy, f32(pk), ws, sh)
        d_abs, d_rel = errors(dx - dy, rdx - dy)
        worst = max(((errors(g[k], rg[k]), k) for k in rg),
                    key=lambda e: e[0][1])
        (p_abs, p_rel), p_name = worst
        log(f"kernel {row['name']} shift {sh}: dx - dy max|d|={d_abs:.3e} "
            f"max|d|/max|ref|={d_rel:.3e}; worst parameter gradient "
            f"{p_name} max|d|={p_abs:.3e} max|d|/max|ref|={p_rel:.3e}; "
            f"reproducible {same}")
        if not (d_rel <= BWD_TOL_DX and p_rel <= BWD_TOL_PARAM and same):
            raise AssertionError(f"{row['name']} shift {sh}: dx error "
                                 f"{d_rel:.3e}, {p_name} error {p_rel:.3e}, "
                                 f"reproducible {same}")
        del dx, g, dx2, g2, rdx, rg
        row["ms" + tag] = time_ms(lambda: sb.swin_block_bwd(tok, dy, pk, ws,
                                                            sh))
        row["plain_ms" + tag] = time_ms(lambda: sb.swin_block_bwd_plain(
            tok, dy, f32(pk), ws, sh), reps=3, warm=1)
        row["max_abs_err"] = max(row["max_abs_err"], p_abs)
        row["max_rel_err"] = max(row["max_rel_err"], p_rel)
        row["max_rel_err_dx"] = max(row["max_rel_err_dx"], d_rel)
    row["reproducible"] = True
    row["tflops"] = tflops(3 * fwd, row["ms"])
    # the shifted block's backward by kernel: device time of each launch
    pk1 = blk1.packed(ws, dt)
    # the sum kernel alone on the partials it reads, against the library's
    # two column sums of the same tensors (never called by the port)
    with torch.inference_mode():
        _, pairs, pw = sb.launch_swin_bwd_window(tok1, dy, pk1, ws, shift)
        pd = sb.swin_block_wgrad(pairs)
        del pairs
        g_abs, g_rel = errors(sb.swin_block_gsum(pw, pd),
                              torch.cat([pw.sum(0), pd.sum(0)]))
        row["gsum_ms"] = time_ms(lambda: sb.swin_block_gsum(pw, pd))
        row["gsum_library_ms"] = time_ms(lambda: (pw.sum(0), pd.sum(0)))
    log(f"kernel swin_gsum_kernel (row 12's sum) on pw {tuple(pw.shape)}, "
        f"pd {tuple(pd.shape)}: ms={row['gsum_ms']:.4f} library_ms "
        f"(pw.sum(0), pd.sum(0))={row['gsum_library_ms']:.4f} bound_ms="
        f"{sbms:.4f} (bytes); max|d|={g_abs:.3e} max|d|/max|ref|="
        f"{g_rel:.3e} against the library's sums")
    del pw, pd
    row["gsum_rounds"] = gsum_rounds(pk1, ws, shift, c)
    row["split_ms"] = log_launch_split(
        f"{row['name']} (shifted)",
        lambda: sb.swin_block_bwd(tok1, dy, pk1, ws, shift), BWD_KERNEL_NAMES)
    return row, check_swin_wgrad(tok1, dy, pk1, ws, shift, hid)


# row 12's sum kernel against the library's pair (pw.sum(0), pd.sum(0)):
# token grids (B, H, W) and rounds of each, in alternation
GSUM_GRIDS, GSUM_ROUNDS = ((6, 64, 64), (10, 48, 48)), 5


def gsum_rounds(pk, ws: int, shift: int, c: int) -> dict:
    """The sum kernel and the library's two column sums on the partials of
    the window and weight-gradient kernels at each of GSUM_GRIDS (seeded
    tokens and dy), timed in alternation (kernel, library) GSUM_ROUNDS
    times: {grid: {"ms": [...], "library_ms": [...]}}, both logged with
    their medians."""
    from ciaosr_torch.ops.kernels import swin_block as sb

    out = {}
    for b, h, w in GSUM_GRIDS:
        rng = np.random.default_rng(b * h)
        tok, dy = (torch.as_tensor(rng.standard_normal(
            (b, h, w, c)).astype(np.float32), device="cuda")
            for _ in range(2))
        with torch.inference_mode():
            _, pairs, pw = sb.launch_swin_bwd_window(tok, dy, pk, ws, shift)
            pd = sb.swin_block_wgrad(pairs)
            del pairs
            kern, lib = [], []
            for _ in range(GSUM_ROUNDS):
                kern.append(time_ms(lambda: sb.swin_block_gsum(pw, pd)))
                lib.append(time_ms(lambda: (pw.sum(0), pd.sum(0))))
        grid = f"{b}x{h}x{w}"
        out[grid] = {"ms": kern, "library_ms": lib}
        log(f"kernel swin_gsum_kernel at {grid} (pw {tuple(pw.shape)}, pd "
            f"{tuple(pd.shape)}), {GSUM_ROUNDS} rounds in alternation: "
            f"ms {[round(t, 4) for t in kern]} (median "
            f"{statistics.median(kern):.4f}); library (pw.sum(0), "
            f"pd.sum(0)) {[round(t, 4) for t in lib]} (median "
            f"{statistics.median(lib):.4f}); kernel faster in "
            f"{sum(k < q for k, q in zip(kern, lib))} of {GSUM_ROUNDS}")
        del tok, dy, pw, pd
    return out


def train_path(drive, kind: str, smi: str, fwd_row: dict,
               bwd_row: dict, wgrad_row: dict) -> None:
    """TRAIN_STEPS steps of make_train_step on the full 002 generator at
    the 002 batch, with exact launch counts per step; the warm step time,
    samples/s, a stage split and the peak memory; then one step's
    gradients, kernel route against the plain f32 route, on a small
    batch."""
    from ciaosr_torch.models.restorers import CiaoSRRestorer
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.ops.kernels import swin_block as sb
    from ciaosr_torch.train.optim import build_optimizer
    from ciaosr_torch.train.trainer import TrainState, make_train_step

    res = CiaoSRRestorer(SWIN_002, rgb_mean=RGB_MEAN, device="cuda", seed=0)
    gen = res.generator
    n_blocks = len(swin_blocks(gen))
    opt, sched = build_optimizer(gen.parameters(), TRAIN_OPT, TRAIN_LR_CFG)
    state = TrainState(0, gen, opt, sched)
    step = make_train_step(res, opt, sched)
    rng = np.random.default_rng(4)
    batches = [train_batch(rng, TRAIN_B, TRAIN_LR, TRAIN_QSIDE)
               for _ in range(TRAIN_STEPS + 3)]
    before = {k: p.detach().clone() for k, p in gen.named_parameters()}
    torch.cuda.reset_peak_memory_stats()

    def run():
        nonlocal state
        losses, secs = [], []
        for bt in batches[:TRAIN_STEPS]:
            t = time.perf_counter()
            state, m = step(state, bt)
            torch.cuda.synchronize()   # for the per-step time only
            secs.append(time.perf_counter() - t)
            losses.append(m["loss_pix"])
        return torch.stack(losses).cpu(), secs

    fwd_kernels = ["swin_block", *BWD_KERNELS]
    (losses, secs), launches, _ = drive(
        f"SwinIR train {TRAIN_STEPS} steps (batch {TRAIN_B} x "
        f"{TRAIN_LR}^2, {TRAIN_QSIDE ** 2} queries)", run, fwd_kernels,
        [k for k in kernels.LAUNCHES if k not in fwd_kernels])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: n_blocks * TRAIN_STEPS for k in fwd_kernels}
    got = {k: launches[k] for k in fwd_kernels}
    if got != want:
        raise AssertionError(f"train path: launches {got}, want {want}")
    fwd_row["launches"] = launches["swin_block"]
    bwd_row["launches"] = launches["swin_block_bwd"]
    bwd_row["launches_wgrad"] = launches["swin_block_wgrad"]
    bwd_row["launches_gsum"] = launches["swin_block_gsum"]
    wgrad_row["launches"] = launches["swin_block_wgrad"]
    if not torch.isfinite(losses).all():
        raise AssertionError(f"train path: losses {losses.tolist()}")
    unchanged = [k for k, p in gen.named_parameters()
                 if p.grad is not None and float(p.grad.abs().max()) > 0
                 and torch.equal(p.detach(), before[k])]
    if unchanged:
        raise AssertionError(f"train path: parameters with gradients did "
                             f"not change: {unchanged}")
    warm = statistics.median(secs[1:]) * 1e3
    log(f"train: losses {[round(float(v), 6) for v in losses]}; step ms "
        f"{', '.join(f'{t * 1e3:.1f}' for t in secs)}; peak memory "
        f"{peak:.2f} GiB")
    log(f"e2e ({kind}; {smi}): SwinIR-CiaoSR 002 train step, batch "
        f"{TRAIN_B} x {TRAIN_LR}^2 LR, {TRAIN_QSIDE ** 2} queries/sample: "
        f"warm {warm:.1f} ms/step (median of {len(secs) - 1}), "
        f"{TRAIN_B / warm * 1e3:.2f} samples/s, peak {peak:.2f} GiB")

    # stage split: CUDA events around the parts of a step (median of 3)
    stages: dict = {"forward (36 re-packs included)": [],
                    "backward": [], "optimizer + scheduler": []}
    for bt in batches[TRAIN_STEPS:]:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        loss, _ = res.train_forward(bt["lq"], bt["gt"], bt["coord"],
                                    bt["cell"])
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        sched.step()
        ev[3].record()
        ev[3].synchronize()
        for i, k in enumerate(stages):
            stages[k].append(ev[i].elapsed_time(ev[i + 1]))
    bwd_ms = statistics.median(stages["backward"])
    row12 = n_blocks * (bwd_row["ms"] + bwd_row["ms_noshift"]) / 2
    pack_ms = time_ms(lambda: [sb.pack_swin_block(blk, gen.encoder.window_size,
                                                  torch.bfloat16)
                               for blk in swin_blocks(gen)], reps=3, warm=1)
    for k, v in stages.items():
        log(f"stage train {k}: {statistics.median(v):.3f} ms")
    log(f"stage train row 12 ({n_blocks} x the kernel row's mean ms): "
        f"{row12:.3f} ms = {row12 / bwd_ms:.3f} of backward")
    log(f"stage train packing ({n_blocks} Swin blocks, bf16): "
        f"{pack_ms:.3f} ms")

    # one step's gradients: the kernel route (bf16) and the plain bf16
    # route (JAX's XLA route, no kernel) against the plain f32 route
    grad_route_check("train route check", {
        "kernel": SWIN_002, "plain bf16": dict(SWIN_002, use_kernels=False),
        "plain f32": dict(SWIN_002, dtype=None, use_kernels=False)})


def grad_route_check(label: str, routes: dict, restorer_of=None,
                     loss_of=None, small: dict | None = None) -> None:
    """One step's gradients on a small batch (``small``; by default B = 1,
    16² LR, 256 queries) of the generators ``routes`` names ("kernel",
    "plain bf16", "plain f32"; the same seeded weights): each parameter
    tensor of the kernel route within max(TRAIN_ROUTE_TOL,
    TRAIN_ROUTE_FACTOR × the plain bf16 route's own distance) of the plain
    f32 route, ||Δ||/||ref||. ``restorer_of(generator dict)`` builds a
    route's restorer (default: a CiaoSRRestorer) and ``loss_of(restorer,
    batch)`` gives its loss (default: ``train_forward``'s L1)."""
    from ciaosr_torch.models.restorers import CiaoSRRestorer

    if small is None:
        small = train_batch(np.random.default_rng(5), 1, 16, 16)
    if restorer_of is None:
        def restorer_of(cfg):
            return CiaoSRRestorer(cfg, rgb_mean=RGB_MEAN, device="cuda",
                                  seed=0)
    if loss_of is None:
        def loss_of(r, b):
            return r.train_forward(b["lq"], b["gt"], b["coord"],
                                   b["cell"])[0]
    grads = {}
    for name, cfg in routes.items():
        r = restorer_of(cfg)
        loss = loss_of(r, small)
        loss.backward()
        grads[name] = (float(loss.detach()),
                       {k: p.grad for k, p in r.generator.named_parameters()})
        del r
    ref = grads["plain f32"][1]

    def l2(name):   # per tensor ||Δ|| / ||ref||, and max|Δ| / max|ref|
        return {k: (float((g - ref[k]).norm() / ref[k].norm()),
                    errors(g, ref[k])[1])
                for k, g in grads[name][1].items()}

    e_k, e_b = l2("kernel"), l2("plain bf16")
    # the plain bf16 route runs no kernel: its own distance from f32 is the
    # bf16 class of each tensor (0.11 on the decoder's imnet_k, ~5e-2 on
    # the relative-position tables)
    limit = {k: max(TRAIN_ROUTE_TOL, TRAIN_ROUTE_FACTOR * e_b[k][0])
             for k in e_k}
    dec = {k for k in e_k if k.startswith("imnet_")}

    def worst(keys, i):
        return max(((e_k[k][i], k) for k in keys))

    enc = set(e_k) - dec
    log(f"{label} (B=1, 16^2 LR, 256 queries): loss "
        + ", ".join(f"{n} {v[0]:.6f}" for n, v in grads.items())
        + "; kernel route vs f32 ||d||/||ref||: encoder worst "
        "{:.3e} ({}, plain bf16 {:.3e}), decoder worst {:.3e} ({}, plain "
        "bf16 {:.3e}); max|d|/max|ref|: encoder worst {:.3e} ({}), decoder "
        "worst {:.3e} ({})".format(
            *worst(enc, 0), e_b[worst(enc, 0)[1]][0], *worst(dec, 0),
            e_b[worst(dec, 0)[1]][0], *worst(enc, 1), *worst(dec, 1))
        + "; worst ratio to the plain bf16 route {:.3f}".format(
            max(e_k[k][0] / e_b[k][0] for k in e_k)))
    bad = {k: (v[0], limit[k]) for k, v in e_k.items()
           if not v[0] <= limit[k]}
    if bad:
        raise AssertionError(f"{label}: {bad}")


# ---- the eval entry points (phase "cli"): the shipped 001 configs through
# python3 -m ciaosr_torch.tools.test on a Set5-shaped folder and a .pth
# Set5's GTmod12 shapes (baby, bird, butterfly, head, woman); their ×4 LR
# images are the SET5_X4_EVEN and SET5_X4_ODD shapes
CLI_SET5 = (("baby", (512, 512)), ("bird", (288, 288)),
            ("butterfly", (256, 256)), ("head", (280, 280)),
            ("woman", (228, 344)))
CLI_CONFIGS = ("rdn", "edsr", "swinir")
# inference on the woman LR image: ×4 with --tile 64 (wider than the tile,
# so tiled: three 57² tiles, the test_cfg's tiling) and ×2.5 (a full-image
# predict at round(57·2.5) × round(86·2.5))
CLI_INFER = (("4", ["--tile", "64"]), ("2.5", []))
# a written PNG against the restorer's output: uint8 levels
CLI_PNG_TOL = 1


def smooth_picture(rng, h: int, w: int) -> np.ndarray:
    """A seeded smooth uint8 RGB picture: four low-frequency waves."""
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.zeros((h, w, 3))
    for _ in range(4):
        fy, fx, ph = rng.uniform(0.5, 4, 2).tolist() + [rng.uniform(0, 6)]
        img += rng.uniform(0.2, 1, 3) * np.sin(2 * np.pi * (fy * y + fx * x)
                                               + ph)[..., None]
    img = (img - img.min()) / (img.max() - img.min())
    return np.round(img * 255).astype(np.uint8)


def write_set5(root: Path) -> None:
    """data/Classical/Set5/{GTmod12,LRbicx4} under ``root``, as the 001
    configs' test split reads them: seeded smooth GT pictures of Set5's
    shapes and their MATLAB-bicubic ×1/4 (the port's imresize_np), rounded
    to uint8, written by the port's PNG codec."""
    from ciaosr_torch.core.resize import imresize_np
    from ciaosr_torch.data.imageio import write_png

    rng = np.random.default_rng(5)
    base = root / "data" / "Classical" / "Set5"
    for sub in ("GTmod12", "LRbicx4"):
        (base / sub).mkdir(parents=True)
    for name, (h, w) in CLI_SET5:
        gt = smooth_picture(rng, h, w)
        lq = imresize_np(gt.astype(np.float32) / 255.0, scale=0.25)
        write_png(str(base / "GTmod12" / f"{name}.png"), gt)
        write_png(str(base / "LRbicx4" / f"{name}.png"),
                  np.clip(np.round(lq * 255.0), 0, 255).astype(np.uint8))


def write_checkpoint(path: Path, gen_cfg: dict, seed: int) -> None:
    """An mmcv-style restorer checkpoint of a seeded f32 generator
    (``generator.``), with an EMA copy and a discriminator beside it."""
    from ciaosr_torch.models.builder import build_generator

    gsd = build_generator(gen_cfg, device="cpu", seed=seed).state_dict()
    sd = {f"generator.{k}": v for k, v in gsd.items()}
    sd.update({f"generator_ema.{k}": v + 0.5 for k, v in gsd.items()})
    sd["discriminator.conv_0.weight"] = torch.zeros(64, 3, 3, 3)
    sd["discriminator.conv_0.bias"] = torch.zeros(64)
    torch.save({"meta": {"seed": seed}, "state_dict": sd}, str(path))


def cli_row(kernel: str, c: int, tile_w: int) -> str | None:
    """The kernel row that holds ``kernel``'s launches on a tile of width
    ``tile_w`` by a generator of C = ``c`` channels (None for the Swin
    block and the f32 conv: their rows hold the 002 generator's tiles and
    training batch)."""
    if kernel in ("swin_block", "conv3x3_f32"):
        return None
    odd = kernel == "grid_decode" and tile_w % 8
    if c <= 64:
        row = {"csa_attention": "csa_attention@{}x{}".format(*SET5[0])}.get(
            kernel, kernel)
        return row + ("@{}x{}".format(*ODD) if odd else "")
    row = kernel + ("@C180" if kernel.startswith("csa") else "@C180+csa")
    return row + ("@{}x{}".format(*SET5_X4_ODD[0]) if odd else "")


def cli_expected(images, scale, tile, c: int, n_blocks: int,
                 rows: dict, convs: int = 0) -> dict:
    """``expected_launches`` of requests on ``images``, summed, each
    image's also added into ``rows`` (kernel row → launches)."""
    from ciaosr_torch.models.restorers import tile_layout

    want: dict = {}
    for hw in images:
        one = expected_launches([hw], scale, tile, c, n_blocks,
                                convs=convs)
        tile_w = tile_layout(*hw, scale, tile)[0] if tile else hw[1]
        for k, n in one.items():
            want[k] = want.get(k, 0) + n
            row = cli_row(k, c, tile_w)
            if row:
                rows[row] = rows.get(row, 0) + n
    return want


def cli_phase(drive, kind: str, smi: str) -> dict:
    """Phase "cli": for each shipped 001 config (f32 params, its own
    test_cfg), ``ciaosr_torch.tools.test``'s ``main`` in this process on a
    Set5-shaped folder in a temporary working directory (the configs'
    data/ paths are relative) and a ``.pth`` of a seeded generator, with
    exactly the launches ``expected_launches`` counts for its five images;
    its PSNR and SSIM equal (≤ 1e-6) those of the same restorer's outputs
    on the same samples (the .pth loaded strictly), which agree with the
    plain f32 route at max|d|/max|ref| ≤ REL_TOL. The flagship's command
    also runs as a subprocess; ``ciaosr_torch.tools.inference`` upscales
    the woman LR image (×4 tiled, ×2.5), each PNG within CLI_PNG_TOL of
    ``forward_test``. Returns each kernel row's launches."""
    from ciaosr_torch.convert.load import load_torch_checkpoint
    from ciaosr_torch.data.datasets import build_dataset
    from ciaosr_torch.data.imageio import imread
    from ciaosr_torch.models.builder import build_model
    from ciaosr_torch.models.restorers import CiaoSRRestorer
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.tools import test as cli_test

    rows: dict = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        write_set5(root)
        log(f"cli: Set5-shaped folder written in "
            f"{time.perf_counter() - t0:.2f} s")
        os.chdir(root)
        try:
            for seed, name in enumerate(CLI_CONFIGS):
                path = config_path(f"001_localimplicitsr_{name}_")
                cfg = Config.fromfile(path)
                gen = cfg.model["generator"]
                ckpt = root / f"{name}.pth"
                write_checkpoint(ckpt, gen, seed)
                enc = gen["encoder"]
                c = enc.get("mid_channels") or enc["embed_dim"]
                n_blocks = sum(enc.get("depths", ()))
                test_cfg = cfg.test_cfg
                lrs = [imread(f"data/Classical/Set5/LRbicx4/{n}.png").shape[:2]
                       for n, _ in CLI_SET5]
                want = cli_expected(lrs, test_cfg["scale"], test_cfg["tile"],
                                    c, n_blocks, rows, trunk_convs(gen))
                out_json = root / f"{name}.json"
                metrics, launches, secs = drive(
                    f"cli {name} tools.test (want {want})",
                    lambda: cli_test.main([path, str(ckpt), "--out",
                                           str(out_json)]),
                    list(want), [k for k in kernels.LAUNCHES
                                 if k not in want])
                got = {k: launches[k] for k in want}
                if got != want:
                    raise AssertionError(f"cli {name}: launches {got}, "
                                         f"want {want}")
                with open(out_json) as f:
                    if json.load(f) != metrics:
                        raise AssertionError(f"cli {name}: --out differs "
                                             "from main's result")

                # the same restorer, loaded strictly, on the same samples
                model = dict(cfg.model)
                del model["type"]
                sd = load_torch_checkpoint(str(ckpt), cfg.model, strict=True)
                res = build_model(cfg.model, test_cfg=test_cfg)
                res.generator.load_state_dict(sd, strict=True)
                ref = CiaoSRRestorer(**dict(model, generator=dict(
                    gen, use_kernels=False)), test_cfg=test_cfg,
                    device="cuda")
                ref.generator.load_state_dict(sd, strict=True)
                del sd
                dataset = build_dataset(cfg.data["test"])
                recs, worst = [], 0.0
                for i in range(len(dataset)):
                    s = dataset[i]
                    meta = s["meta"]
                    out = res.forward_test(s["lq"],
                                           target_shape=meta["target_size"],
                                           scale=meta["scale"])
                    recs.append(res.evaluate(out, s["gt"]))
                    a, r = errors(torch.as_tensor(out), torch.as_tensor(
                        ref.forward_test(s["lq"], scale=meta["scale"])))
                    worst = max(worst, r)
                mine = {k: float(np.mean([rec[k] for rec in recs]))
                        for k in test_cfg["metrics"]}
                diff = {k: abs(mine[k] - metrics[k]) for k in mine}
                hr_px = sum(h * w for _, (h, w) in CLI_SET5)
                log(f"cli {name} ({kind}; {smi}): {metrics['n_images']} "
                    f"images, PSNR {metrics['PSNR']:.6f} dB, SSIM "
                    f"{metrics['SSIM']:.6f}; request {secs:.3f} s wall "
                    f"(evaluator {metrics['elapsed_s']:.3f} s, "
                    f"{hr_px / 1e6 / metrics['elapsed_s']:.3f} MP/s); "
                    f"|CLI - own| {diff}; kernel route (bf16) vs plain "
                    f"route (f32) worst max|d|/max|ref|={worst:.3e}")
                if metrics["n_images"] != len(CLI_SET5) or not all(
                        d <= 1e-6 for d in diff.values()):
                    raise AssertionError(f"cli {name}: metrics {metrics} vs "
                                         f"the phase's own {mine}")
                if not worst <= REL_TOL:
                    raise AssertionError(f"cli {name}: kernel route "
                                         f"disagrees: {worst:.3e}")
                if name == "rdn":
                    cli_shell(path, ckpt, root, metrics)
                    cli_infer(drive, path, ckpt, res, ref, c, rows)
                del res, ref
        finally:
            os.chdir(cwd)
    return rows


def cli_shell(path: str, ckpt: Path, root: Path, metrics: dict) -> None:
    """``python3 -m ciaosr_torch.tools.test`` as a shell command (PYTHONPATH
    at the repository root): its metrics equal the in-process run's."""
    out = root / "shell.json"
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "ciaosr_torch.tools.test", path, str(ckpt),
         "--out", str(out)], cwd=root, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=str(
            Path(__file__).resolve().parent)))
    if run.returncode != 0:
        raise AssertionError(f"cli shell run failed ({run.returncode}):\n"
                             f"{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
    with open(out) as f:
        shell = json.load(f)
    diff = {k: abs(shell[k] - metrics[k]) for k in ("PSNR", "SSIM")}
    log(f"cli rdn as a shell command: {time.perf_counter() - t0:.2f} s "
        f"(a new process), PSNR {shell['PSNR']:.6f}, SSIM "
        f"{shell['SSIM']:.6f}, |shell - in-process| {diff}")
    if not all(d <= 1e-6 for d in diff.values()):
        raise AssertionError(f"cli shell run: {shell} vs {metrics}")


def cli_infer(drive, path: str, ckpt: Path, res, ref, c: int,
              rows: dict) -> None:
    """``ciaosr_torch.tools.inference`` on the woman LR image at each scale
    of CLI_INFER, with exactly the launches expected_launches counts: the
    written PNG has the target size and is within CLI_PNG_TOL levels of
    ``res.forward_test`` on the decoded input (×2.5 through a test_cfg
    without a tile: the full-image predict), which agrees with ``ref``'s
    (the plain f32 route) at max|d|/max|ref| ≤ REL_TOL."""
    from ciaosr_torch.data.imageio import imread, read_png
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.tools import inference as cli_inference

    src = f"data/Classical/Set5/LRbicx4/{CLI_SET5[-1][0]}.png"
    lq = imread(src).astype(np.float32) / 255.0
    hw = lq.shape[:2]
    untiled = {k: v for k, v in res.test_cfg.items() if k != "tile"}
    full, ref_full = copy.copy(res), copy.copy(ref)
    full.test_cfg = ref_full.test_cfg = untiled
    for scale, extra in CLI_INFER:
        s = float(scale)
        # the CLI tiles an integer scale where the image exceeds --tile
        tile = int(extra[1]) if extra and max(hw) > int(extra[1]) else None
        want = cli_expected([hw], Fraction(scale), tile, c, 0, rows)
        out = f"sr_x{scale}.png"
        written, launches, secs = drive(
            f"cli inference x{scale} (want {want})",
            lambda: cli_inference.main([path, str(ckpt), "--img", src,
                                        "--scale", scale, "--out", out]
                                       + extra),
            list(want), [k for k in kernels.LAUNCHES if k not in want])
        got = {k: launches[k] for k in want}
        if got != want or written != [out]:
            raise AssertionError(f"cli inference x{scale}: launches {got}, "
                                 f"want {want}; wrote {written}")
        png = read_png(out).astype(np.int32)
        sr = (res if tile else full).forward_test(lq, scale=s)
        sr8 = np.clip(sr * 255.0 + 0.5, 0, 255).astype(np.int32)
        shape = (round(hw[0] * s), round(hw[1] * s), 3)
        dev = int(np.abs(png - sr8).max()) if png.shape == shape else None
        a, r = errors(torch.as_tensor(sr), torch.as_tensor(
            (ref if tile else ref_full).forward_test(lq, scale=s)))
        log(f"cli inference x{scale} {hw[0]}x{hw[1]} -> {png.shape}: "
            f"{secs * 1e3:.1f} ms, max |PNG - forward_test| {dev} levels; "
            f"kernel route (bf16) vs plain route (f32) max|d|={a:.3e} "
            f"max|d|/max|ref|={r:.3e}")
        if dev is None or dev > CLI_PNG_TOL or not r <= REL_TOL:
            raise AssertionError(f"cli inference x{scale}: PNG {png.shape}, "
                                 f"want {shape}, {dev} levels off; route "
                                 f"error {r:.3e}")


# ---- classical training through the train CLI (phase "train_cli"): the
# shipped 001 configs through python3 -m ciaosr_torch.tools.train on a
# DIV2K-shaped folder (seeded smooth pictures, each at least 192², so that
# a ×4 patch of 48 fits) and the Set5-shaped folder of phase "cli"
TRAIN_HR = ((256, 256), (240, 300), (300, 240), (228, 344))
# the one derived config: 001 rdn with checkpoints and evals every 2
# iterations and a log line every iteration
TRAIN_CLI_OVERRIDES = """
# train_cli: hooks every few iterations
checkpoint_config = dict(interval=2, save_optimizer=True, by_epoch=False)
evaluation = dict(interval=2, save_image=False, gpu_collect=True)
log_config = dict(interval=1)
"""
# iterations: 001 rdn to 4, then resumed to 6; 001 swinir 3; 001 edsr 2
TRAIN_CLI_RDN, TRAIN_CLI_SWINIR, TRAIN_CLI_EDSR = (4, 6), 3, 2
# batches the loader alone is timed over, after its first; steps of a
# trainer timed after its CLI run, after one more
LOADER_BATCHES, WARM_STEPS = 6, 3


def write_div2k(root: Path) -> None:
    """data/DIV2K/HR under ``root``: seeded smooth pictures of TRAIN_HR's
    shapes, written by the port's PNG codec."""
    from ciaosr_torch.data.imageio import write_png

    rng = np.random.default_rng(6)
    hr = root / "data" / "DIV2K" / "HR"
    hr.mkdir(parents=True)
    for i, (h, w) in enumerate(TRAIN_HR):
        write_png(str(hr / f"{i + 1:04d}.png"), smooth_picture(rng, h, w))


class TrainProbe:
    """Instruments ``ciaosr_torch.train.trainer`` for one or more CLI runs
    (undone by ``close``): per iteration, the time the loop waited in
    ``next(loader)``, the loss (and every metric of a GAN step), and the
    time each step ended (after a device sync); the time each run's loop
    started (``_maybe_resume``) and the state it left; the seconds of each
    checkpoint save."""

    def __init__(self):
        from ciaosr_torch.models.real_restorer import RealCiaoSRRestorer
        from ciaosr_torch.train import trainer as tr

        self.tr, self.gan = tr, RealCiaoSRRestorer
        self.real = (tr.make_train_step, tr.Trainer._next,
                     tr.Trainer._maybe_resume, tr.CheckpointManager.save,
                     RealCiaoSRRestorer.make_gan_train_step)
        self.waits, self.ends, self.losses, self.resumed = [], [], [], []
        self.starts, self.saves, self.metrics = [], [], []
        make_step, next_, resume, save, make_gan = self.real
        probe = self

        def timed(step):
            def run(state, batch):
                state, m = step(state, batch)
                torch.cuda.synchronize()
                probe.ends.append((state.step, time.perf_counter()))
                probe.losses.append(m["loss_pix"])
                probe.metrics.append(m)
                return state, m
            return run

        def make(*a):
            return timed(make_step(*a))

        def make_gan_step(restorer, *a):
            return timed(make_gan(restorer, *a))

        def waited(trainer, it):
            t = time.perf_counter()
            batch = next_(trainer, it)
            probe.waits.append(time.perf_counter() - t)
            return batch

        def saved(mgr, *a, **kw):
            t = time.perf_counter()
            save(mgr, *a, **kw)
            probe.saves.append(time.perf_counter() - t)

        def resumed(trainer):
            probe.starts.append(time.perf_counter())
            resume(trainer)
            opt = trainer.optimizer.state_dict()
            probe.resumed.append((
                trainer.state.step, trainer.optimizer.param_groups[0]["lr"],
                {i: {k: v.detach().cpu().clone() for k, v in st.items()}
                 for i, st in opt["state"].items()}))

        tr.make_train_step = make
        tr.Trainer._next, tr.Trainer._maybe_resume = waited, resumed
        tr.CheckpointManager.save = saved
        RealCiaoSRRestorer.make_gan_train_step = make_gan_step

    def close(self):
        tr = self.tr
        (tr.make_train_step, tr.Trainer._next, tr.Trainer._maybe_resume,
         tr.CheckpointManager.save, self.gan.make_gan_train_step) = self.real

    def loop_stats(self, hooks=()) -> tuple[float, float, int]:
        """(median ms an iteration, the loader-wait share, samples) over
        the iterations after the first whose previous step fired no hook
        (``hooks``: steps followed by an eval or a save): an iteration is
        one step end to the next, its loader wait included."""
        ms, waits = [], []
        for i in range(1, len(self.ends)):
            prev, t0 = self.ends[i - 1]
            step, t1 = self.ends[i]
            if step == prev + 1 and prev not in hooks:
                ms.append((t1 - t0) * 1e3)
                waits.append(self.waits[i] * 1e3)
        return statistics.median(ms), sum(waits) / sum(ms), len(ms)


def loader_rate(cfg) -> tuple[float, int, int]:
    """The train loader alone, as tools.train builds it: (batches/s over
    LOADER_BATCHES after its first, batch size, workers)."""
    from ciaosr_torch.data.datasets import build_dataset
    from ciaosr_torch.data.loader import build_dataloader

    b = (cfg.data.get("train_dataloader") or {}).get("samples_per_gpu", 16)
    workers = cfg.data.get("workers_per_gpu", 4)
    it = iter(build_dataloader(build_dataset(cfg.data["train"]),
                               samples_per_gpu=b, workers_per_gpu=workers,
                               worker_mode=cfg.data.get("worker_mode",
                                                        "thread"),
                               seed=1))
    try:
        next(it)
        t = time.perf_counter()
        for _ in range(LOADER_BATCHES):
            next(it)
        return LOADER_BATCHES / (time.perf_counter() - t), b, workers
    finally:
        it.close()


def changed_parameters(gen, before: dict) -> None:
    """Every parameter of ``gen`` with a nonzero gradient differs from its
    value in ``before`` (the seeded initial weights, on the CPU)."""
    same = [k for k, p in gen.named_parameters()
            if p.grad is not None and float(p.grad.abs().max()) > 0
            and torch.equal(p.detach().cpu(), before[k])]
    if same:
        raise AssertionError(f"train_cli: parameters with gradients did "
                             f"not change: {same}")


def tb_events_check(label: str, work: Path) -> None:
    """The TensorBoard scalars of a tools.train work_dir (``tb/``), read
    back by the port's reader, equal to the JSONL records' means at their
    steps: the losses and the evals' ``val_*``, without the extra fields
    (``lr``, ``iters_per_s``), as float32."""
    from ciaosr_torch.train.tb_events import read_scalars

    want: dict = {}
    with open(work / "train_log.jsonl") as f:
        for r in map(json.loads, f):
            for k, v in r.items():
                if k not in ("step", "time", "lr", "iters_per_s"):
                    want.setdefault(k, []).append((r["step"],
                                                   float(np.float32(v))))
    got = read_scalars(str(work / "tb"))
    files = sorted(p.name for p in (work / "tb").glob("events.out.tfevents.*"))
    steps = sorted({step for v in got.values() for step, _ in v})
    log(f"train_cli {label}: tb/ {files}: {sum(map(len, got.values()))} "
        f"scalars of {sorted(got)} at steps {steps}")
    if not want.get("loss_pix") or got != want:
        raise AssertionError(f"train_cli {label}: tb/ events {got}, want "
                             f"the JSONL means {want}")


def train_cli_run(drive, probe, label: str, argv: list, want: dict):
    """``ciaosr_torch.tools.train.main(argv)`` with exactly the launches
    ``want`` (every other kernel idle), its losses finite. Returns the
    trainer, the peak memory (GiB) and the wall seconds."""
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.tools import train as cli_train

    probe.losses.clear()
    probe.saves.clear()
    n0 = len(probe.ends)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, launches, secs = drive(
        f"train_cli {label} (want {want})", lambda: cli_train.main(argv),
        [k for k, n in want.items() if n], [k for k in kernels.LAUNCHES
                                            if not want.get(k)])
    ends = [t for _, t in probe.ends[n0:]]
    its = [b - a for a, b in zip([probe.starts[-1]] + ends, ends)]
    log(f"train_cli {label}: set-up before the loop "
        f"{probe.starts[-1] - t0:.2f} s; iterations (loader wait, hooks "
        f"and a device sync included) {[round(t * 1e3, 1) for t in its]} "
        f"ms; checkpoint saves {[round(t, 3) for t in probe.saves]} s")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"train_cli {label}: launches {got}, want "
                             f"{want}")
    losses = torch.stack(probe.losses).cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"train_cli {label}: losses {losses.tolist()}")
    log(f"train_cli {label}: {secs:.2f} s, losses "
        f"{[round(float(v), 6) for v in losses]}")
    return trainer, peak, secs


def warm_steps(trainer, cfg, n: int = WARM_STEPS) -> list:
    """ms of n more steps of a CLI run's trainer, after one step more, each
    ended by a device sync, on batches a loader built as tools.train builds
    it made first and moved to the device as the loop moves them (the
    loader closed before the first step: while it fills its prefetch
    queue, its threads take the host from a host-bound step)."""
    from ciaosr_torch.data.datasets import build_dataset
    from ciaosr_torch.data.loader import build_dataloader
    from ciaosr_torch.train.trainer import to_device

    loader_cfg = cfg.data.get("train_dataloader") or {}
    it = iter(build_dataloader(
        build_dataset(cfg.data["train"]),
        samples_per_gpu=loader_cfg.get("samples_per_gpu", 16),
        workers_per_gpu=cfg.data.get("workers_per_gpu", 4), seed=2))
    try:
        batches = [next(it) for _ in range(n + 1)]
    finally:
        it.close()
    ms = []
    for b in batches:
        batch = to_device(b, trainer.restorer.device)
        t = time.perf_counter()
        trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return ms[1:]


def train_cli_report(kind: str, smi: str, name: str, cfg, probe, trainer,
                     peak: float, hooks=()) -> None:
    """A config's line: the CLI loop's iterations (those after a step
    without a hook), the warm step of its trainer, the peak memory and
    the loader alone."""
    ms, share, n = probe.loop_stats(hooks)
    warm = warm_steps(trainer, cfg)
    step = statistics.median(warm)
    rate, b, workers = loader_rate(cfg)
    log(f"e2e ({kind}; {smi}): train_cli 001 {name} as shipped (f32 params, "
        f"kernel route), batch {b} x 48^2 LR, 2304 queries/sample: the CLI "
        f"loop {ms:.1f} ms/iteration (median of {n}, loader wait "
        f"included), loader wait {share:.3f} of it; warm step "
        f"{step:.1f} ms (median of {len(warm)} more steps of its trainer: "
        f"{[round(t, 1) for t in warm]}), {b / step * 1e3:.2f} samples/s; "
        f"peak {peak:.2f} GiB; the loader alone ({workers} threads) "
        f"{rate:.2f} batches/s ({rate * b:.1f} samples/s)")


def train_cli_phase(drive, kind: str, smi: str) -> tuple[dict, list]:
    """Phase "train_cli": the shipped 001 configs (f32 params) through
    ``ciaosr_torch.tools.train``'s ``main`` in a temporary working
    directory (their data/ paths are relative) on seeded DIV2K- and
    Set5-shaped folders:

    1. 001 rdn on a derived copy with hooks every 2 iterations: 4
       iterations (a log line each; evals at 2 and 4 on the five Set5
       images, with the launches ``cli_expected`` counts for each;
       checkpoints at 2 and 4), then to 6: auto-resumed at 4 with the
       step, lr and Adam state saved; ``ciaosr_torch.tools.test`` on the
       work_dir gives the PSNR and SSIM (≤ 1e-6) of a restorer loaded
       strictly from the newest checkpoint;
    2. 001 swinir as shipped: rows 11 and 12 held against their plain
       versions (row 12 against autograd) at the train batch's tokens,
       shifted and unshifted, reproducible, and timed; then 3 iterations
       with exactly 36 × 3 launches of rows 11 and 12 and both reduction
       kernels, and no other kernel;
    3. 001 edsr as shipped: 2 iterations under ``--deterministic``, no
       kernel;
    4. one step's gradients of 001 swinir's generator, the kernel route
       (as the CLI trains it: f32 params, the Swin blocks in bf16)
       against the plain f32 route (``grad_route_check``).

    Each run's losses are finite and every parameter with a gradient
    changed; per config, the warm time an iteration, samples/s, the peak
    memory, the loader's share of the loop and the loader alone. Returns
    each kernel row's launches and the phase's own kernel rows."""
    from ciaosr_torch.convert.load import load_torch_checkpoint
    from ciaosr_torch.data.datasets import build_dataset
    from ciaosr_torch.data.imageio import imread
    from ciaosr_torch.models.builder import build_generator, build_model
    from ciaosr_torch.models.restorers import CiaoSRRestorer
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.tools import test as cli_test
    from ciaosr_torch.train.checkpoint import list_steps, read_checkpoint

    rows: dict = {}
    new_rows: list = []
    cwd = os.getcwd()
    probe = TrainProbe()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        write_div2k(root)
        write_set5(root)
        log(f"train_cli: DIV2K- and Set5-shaped folders written in "
            f"{time.perf_counter() - t0:.2f} s")
        os.chdir(root)
        try:
            # ---- 001 rdn: hooks, resume, tools.test
            shipped = config_path("001_localimplicitsr_rdn_")
            derived = root / "001_rdn_train_cli.py"
            derived.write_text(Path(shipped).read_text()
                               + TRAIN_CLI_OVERRIDES)
            log(f"train_cli rdn: the derived copy {derived.name} of "
                f"{Path(shipped).name} (checkpoint_config.interval 2, "
                "evaluation.interval 2, log_config.interval 1)")
            cfg = Config.fromfile(str(derived))
            tile = cfg.test_cfg["tile"]
            val_lrs = [(h // 4, w // 4) for _, (h, w) in CLI_SET5]

            def evals(n):   # the launches of n evals, added into rows
                want: dict = {}
                for _ in range(n):
                    for k, v in cli_expected(val_lrs, 4, tile, 64, 0,
                                             rows).items():
                        want[k] = want.get(k, 0) + v
                return want

            before = build_generator(cfg.model["generator"], device="cpu",
                                     seed=0).state_dict()
            first, again = TRAIN_CLI_RDN
            trainer, peak, _ = train_cli_run(
                drive, probe, f"rdn to {first}",
                [str(derived), "--total-iters", str(first)], evals(2))
            work = Path(trainer.work_dir)
            changed_parameters(trainer.state.generator, before)
            with open(work / "train_log.jsonl") as f:
                recs = [json.loads(line) for line in f]
            steps = [r["step"] for r in recs if "loss_pix" in r]
            val = [r["step"] for r in recs if "val_PSNR" in r]
            ckpts = list_steps(str(work / "checkpoints"))
            if steps != list(range(1, first + 1)) or val != [2, 4] \
                    or ckpts != [2, 4]:
                raise AssertionError(f"train_cli rdn: logged {steps}, evals "
                                     f"{val}, checkpoints {ckpts}")
            saved = read_checkpoint(str(work / "checkpoints" /
                                        f"iter_{first}.pth"))
            del trainer
            trainer, peak2, _ = train_cli_run(
                drive, probe, f"rdn resumed to {again}",
                [str(derived), "--total-iters", str(again)], evals(1))
            step0, lr0, opt0 = probe.resumed[-1]
            same_adam = set(opt0) == set(saved["optimizer"]["state"]) and \
                all(torch.equal(v, saved["optimizer"]["state"][i][k])
                    for i, st in opt0.items() for k, v in st.items())
            saved_lr = saved["optimizer"]["param_groups"][0]["lr"]
            log(f"train_cli rdn resumed at {step0} (saved {saved['step']}), "
                f"lr {lr0} (saved {saved_lr}), Adam state of "
                f"{len(opt0)} tensors equal to the saved: {same_adam}")
            if not (step0 == saved["step"] == first and lr0 == saved_lr
                    and same_adam and trainer.state.step == again):
                raise AssertionError("train_cli rdn: the resume did not "
                                     "restore the saved state")
            ckpts = list_steps(str(work / "checkpoints"))
            if ckpts != [2, 4, 6]:
                raise AssertionError(f"train_cli rdn: checkpoints {ckpts}")
            tb_events_check("rdn", work)
            train_cli_report(kind, smi, "rdn", cfg, probe, trainer,
                             max(peak, peak2), hooks={2, 4, 6})
            del trainer, saved

            # tools.test on the work_dir, against the newest checkpoint
            test_lrs = [imread(f"data/Classical/Set5/LRbicx4/{n}.png"
                               ).shape[:2] for n, _ in CLI_SET5]
            want = cli_expected(test_lrs, 4, tile, 64, 0, rows)
            metrics, launches, secs = drive(
                f"train_cli rdn tools.test on the work_dir (want {want})",
                lambda: cli_test.main([str(derived), str(work)]),
                list(want), [k for k in kernels.LAUNCHES if k not in want])
            got = {k: launches[k] for k in want}
            if got != want:
                raise AssertionError(f"train_cli tools.test: launches {got}, "
                                     f"want {want}")
            newest = str(work / "checkpoints" / f"iter_{again}.pth")
            res = build_model(cfg.model, test_cfg=cfg.test_cfg)
            res.generator.load_state_dict(load_torch_checkpoint(
                newest, cfg.model, strict=True), strict=True)
            dataset = build_dataset(cfg.data["test"])
            recs = []
            for i in range(len(dataset)):
                smp = dataset[i]
                meta = smp["meta"]
                recs.append(res.evaluate(res.forward_test(
                    smp["lq"], target_shape=meta["target_size"],
                    scale=meta["scale"]), smp["gt"]))
            mine = {k: float(np.mean([r[k] for r in recs]))
                    for k in cfg.test_cfg["metrics"]}
            diff = {k: abs(mine[k] - metrics[k]) for k in mine}
            log(f"train_cli rdn tools.test on the work_dir: {secs:.2f} s, "
                f"PSNR {metrics['PSNR']:.6f} SSIM {metrics['SSIM']:.6f}; "
                f"|CLI - a restorer loaded from iter_{again}.pth| {diff}")
            if not all(d <= 1e-6 for d in diff.values()):
                raise AssertionError(f"train_cli tools.test: {metrics} vs "
                                     f"{mine}")
            del res
            torch.cuda.empty_cache()

            # ---- 001 swinir: rows 11 and 12 at the train batch's tokens,
            # then 3 iterations with exact launches
            path = config_path("001_localimplicitsr_swinir_")
            cfg = Config.fromfile(path)
            b = cfg.data["train_dataloader"]["samples_per_gpu"]
            sw = CiaoSRRestorer(SWIN_001, rgb_mean=RGB_MEAN, device="cuda",
                                seed=0)
            lq = torch.rand((b, 48, 48, 3), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(7))
            t0 = time.perf_counter()
            fwd_row = swin_block_row(sw, lq)
            bwd_row, wgrad_row = check_swin_bwd(sw, {"lq": lq})
            n_blocks = len(swin_blocks(sw.generator))
            log(f"train_cli swinir: rows 11 and 12 at {b}x48x48 held and "
                f"timed in {time.perf_counter() - t0:.2f} s")
            del sw, lq
            torch.cuda.empty_cache()
            gen = cfg.model["generator"]
            before = build_generator(gen, device="cpu", seed=0).state_dict()
            probe.ends.clear()
            probe.waits.clear()
            iters = TRAIN_CLI_SWINIR
            want = {k: n_blocks * iters for k in ("swin_block",)
                    + BWD_KERNELS}
            want["conv3x3_f32"] = trunk_convs(gen) * iters
            trainer, peak, _ = train_cli_run(
                drive, probe, f"swinir {iters} iterations",
                [path, "--total-iters", str(iters)], want)
            changed_parameters(trainer.state.generator, before)
            train_cli_report(kind, smi, "swinir", cfg, probe, trainer,
                             peak)
            del trainer
            torch.cuda.empty_cache()
            rows[fwd_row["name"]] = want["swin_block"]
            rows[CONV_ROW] = want["conv3x3_f32"]
            rows[bwd_row["name"]] = want["swin_block_bwd"]
            rows[wgrad_row["name"]] = want["swin_block_wgrad"]
            bwd_row["launches_wgrad"] = want["swin_block_wgrad"]
            bwd_row["launches_gsum"] = want["swin_block_gsum"]
            new_rows += [fwd_row, bwd_row, wgrad_row]

            # ---- 001 edsr: no kernel on its training path
            path = config_path("001_localimplicitsr_edsr_")
            cfg = Config.fromfile(path)
            before = build_generator(cfg.model["generator"], device="cpu",
                                     seed=0).state_dict()
            probe.ends.clear()
            probe.waits.clear()
            # under --deterministic: a CSA config trains with the flag
            # (F.interpolate and the reflect pad in CSA's backward)
            trainer, peak, _ = train_cli_run(
                drive, probe,
                f"edsr {TRAIN_CLI_EDSR} iterations (--deterministic)",
                [path, "--total-iters", str(TRAIN_CLI_EDSR),
                 "--deterministic"], {})
            if torch.are_deterministic_algorithms_enabled() or \
                    torch.backends.cudnn.deterministic:
                raise AssertionError("train_cli edsr: --deterministic "
                                     "outlived its run")
            changed_parameters(trainer.state.generator, before)
            train_cli_report(kind, smi, "edsr", cfg, probe, trainer, peak)
            del trainer
            torch.cuda.empty_cache()
        finally:
            probe.close()
            os.chdir(cwd)

    # ---- one step's gradients of 001 swinir's generator as the CLI
    # trains it, against the plain f32 route
    f32_gen = {k: v for k, v in SWIN_001.items() if k != "dtype"}
    t0 = time.perf_counter()
    grad_route_check("train_cli route check (001 swinir)", {
        "kernel": f32_gen,
        "plain bf16": dict(SWIN_001, use_kernels=False),
        "plain f32": dict(f32_gen, use_kernels=False)})
    log(f"train_cli route check: {time.perf_counter() - t0:.2f} s")
    return rows, new_rows


# ---- the real-world GAN stack (phase "gan"): the shipped 002 configs'
# RealCiaoSR (the SwinIR-CiaoSR generator, its EMA copy, the UNet-SN
# discriminator, VGG19 perceptual and vanilla GAN losses) on the card
# GAN steps at the 002 batch (TRAIN_B × TRAIN_LR² LR, TRAIN_QSIDE² queries),
# then steps timed by stage
GAN_STEPS, GAN_SPLIT_STEPS = 5, 3
# tools.train: stage 1 (wogan) iterations; stage 2 (GAN) iterations and
# its checkpoint interval (the resume point)
GAN_STAGE1, GAN_STAGE2, GAN_CKPT = 2, 4, 2
# the training picture: one seeded picture holding a 256² crop (64² LR)
GAN_HR = (288, 320)
# the config copies: the shipped text, then these assignments. Training
# data without the degradation chain (part gan_shipped runs that): a 256²
# crop, its ×4 MATLAB-bicubic 64² LR, 4096 contiguous queries (a 16-row
# strip, which RealCiaoSR's √ns reshape makes a 64² image), no
# gt_unsharp. The dataset's seed makes every sample the same crop, so every
# batch is the same: a resumed run (whose loader starts again at its first
# batch, as in the JAX package) then meets the batches of one that was not
# interrupted. The Set5-shaped test split of phase "cli" for tools.test.
GAN_OVERRIDES = """
# chip_smoke phase gan: a fixed crop, hooks every 2 iterations
train_pipeline = [
    dict(type='LoadImageFromFile', io_backend='disk', key='gt',
         flag='color', channel_order='rgb'),
    dict(type='RandomDownSampling', scale_min=4, scale_max=4,
         patch_size=64),
    dict(type='RescaleToZeroOne', keys=['lq', 'gt']),
    dict(type='ImageToTensor', keys=['lq', 'gt']),
    dict(type='GenerateCoordinateAndCell', sample_quantity=4096,
         is_shuffle=False),
    dict(type='Collect', keys=['lq', 'gt', 'coord', 'cell'],
         meta_keys=['gt_path'])]
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
    workers_per_gpu=6, worker_mode='thread',
    train_dataloader=dict(samples_per_gpu=6, drop_last=True),
    train=dict(type='RepeatDataset', times=6,
               dataset=dict(type='SRFolderGTDataset',
                            gt_folder='data/DF2K/HR',
                            pipeline=train_pipeline, scale=4, seed=0)),
    test=dict(type='SRFolderDataset',
              lq_folder='data/Classical/Set5/LRbicx4',
              gt_folder='data/Classical/Set5/GTmod12',
              pipeline=test_pipeline, scale=4, filename_tmpl='{}'))
checkpoint_config = dict(interval=2, save_optimizer=True, by_epoch=False)
log_config = dict(interval=1)
"""


def gan_batch(rng, b: int, lr: int, q_side: int) -> dict:
    """``train_batch`` with a gt_unsharp beside gt (uniform in [0, 1])."""
    batch = train_batch(rng, b, lr, q_side)
    batch["gt_unsharp"] = torch.as_tensor(
        rng.random((b, q_side ** 2, 3), dtype=np.float32), device="cuda")
    return batch


def gan_restorer(cfg, gen: dict | None = None):
    """The config's RealCiaoSR on the card (``gen``: another generator
    dict), seed 0."""
    from ciaosr_torch.models.real_restorer import RealCiaoSRRestorer

    model = dict(cfg.model)
    del model["type"]
    if gen is not None:
        model["generator"] = gen
    return RealCiaoSRRestorer(**model, train_cfg=cfg.train_cfg,
                              test_cfg=cfg.test_cfg, device="cuda", seed=0)


def gan_optimizers(res, cfg):
    """(GANTrainState at 0, the step) with the config's two optimizers."""
    from ciaosr_torch.models.real_restorer import GANTrainState
    from ciaosr_torch.train.optim import build_optimizer

    lr_cfg = dict(cfg.lr_config)
    g_opt, g_sched = build_optimizer(res.generator.parameters(),
                                     dict(cfg.optimizers["generator"]),
                                     lr_cfg)
    d_opt, d_sched = build_optimizer(res.discriminator.parameters(),
                                     dict(cfg.optimizers["discriminator"]),
                                     lr_cfg)
    state = GANTrainState(0, g_opt, d_opt, g_sched, d_sched)
    return state, res.make_gan_train_step(g_opt, d_opt, (g_sched, d_sched))


def gan_split(res, state, batches) -> dict:
    """A GAN step's stages by CUDA events (median over ``batches``), in
    the order of ``make_gan_train_step``; and VGG19's forward and
    backward alone on the step's fake and real images."""
    from ciaosr_torch.models.real_restorer import query_images

    stages: dict = {"G forward + backward (pixel, VGG and D-forward "
                    "losses)": [], "G optimizer + schedule": [],
                    "D step (real + fake, backward, optimizer)": [],
                    "EMA update": []}
    disc, m = res.discriminator, res.ema_momentum
    live, ema = (list(res.generator.parameters()),
                 list(res.generator_ema.parameters()))
    for bt in batches:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        disc.requires_grad_(False)
        state.g_opt.zero_grad(set_to_none=True)
        total, _, pred_img = res.generator_losses(bt)
        total.backward()
        ev[1].record()
        state.g_opt.step()
        state.g_sched.step()
        ev[2].record()
        disc.requires_grad_(True)
        state.d_opt.zero_grad(set_to_none=True)
        gt, unsharp = res._targets(bt)
        gt_img = query_images(unsharp if res.use_sharp_gan else gt)
        loss = res.gan_loss(disc(gt_img, update_stats=True), True,
                            is_disc=True) + res.gan_loss(
            disc(pred_img.detach(), update_stats=True), False, is_disc=True)
        loss.backward()
        state.d_opt.step()
        state.d_sched.step()
        ev[3].record()
        with torch.no_grad():
            torch._foreach_mul_(ema, m)
            torch._foreach_add_(ema, live, alpha=1.0 - m)
        ev[4].record()
        ev[4].synchronize()
        for i, k in enumerate(stages):
            stages[k].append(ev[i].elapsed_time(ev[i + 1]))
    out = {k: statistics.median(v) for k, v in stages.items()}
    l1 = []   # the generator alone: the classical L1 step's forward and
    for bt in batches:   # backward on the same batches
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        state.g_opt.zero_grad(set_to_none=True)
        ev[0].record()
        res.train_forward(bt["lq"], bt["gt"], bt["coord"],
                          bt["cell"])[0].backward()
        ev[1].record()
        ev[1].synchronize()
        l1.append(ev[0].elapsed_time(ev[1]))
    out["generator alone (L1 forward + backward)"] = statistics.median(l1)
    gan_profile(res, state, batches[0])
    bt = batches[0]
    fake = query_images(res.generator(res.normalize(bt["lq"]), bt["coord"],
                                      bt["cell"]).detach()).requires_grad_()
    real = query_images(res.normalize(bt["gt"]))

    def vgg():
        percep, _ = res.perceptual_loss(fake, real)
        percep.backward()

    out["VGG19 forward (fake, real) + backward (alone)"] = time_ms(
        vgg, reps=3, warm=1)
    return out


def gan_profile(res, state, bt, top: int = 10) -> None:
    """The device time of one G phase (generator forward, the three
    losses, backward) by kernel (torch.profiler, after one warm-up):
    the total and the ``top`` kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    seen = {}
    res.discriminator.requires_grad_(False)
    with profile(activities=[ProfilerActivity.CUDA],
                 on_trace_ready=lambda p: seen.update(evs=p.key_averages()),
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for _ in range(2):
            state.g_opt.zero_grad(set_to_none=True)
            res.generator_losses(bt)[0].backward()
            torch.cuda.synchronize()
            prof.step()
    res.discriminator.requires_grad_(True)
    evs = sorted((e for e in seen["evs"] if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.device_time_total)
    total = sum(e.device_time_total for e in evs) / 1e3
    log(f"gan profile of one G phase: device {total:.2f} ms in "
        f"{sum(e.count for e in evs)} launches; top: " + "; ".join(
            f"{e.key[:60]} {e.device_time_total / 1e3:.2f} ms x{e.count}"
            for e in evs[:top]))


def gan_steps(drive, kind: str, smi: str, cfg) -> dict:
    """GAN_STEPS steps of the shipped 002 gan model's ``make_gan_train_step``
    at the 002 batch with exact launches (rows 11 and 12 and both of row
    12's reduction kernels 36 times a step, the f32 conv kernel 7 times,
    nothing else), finite losses,
    the generator, its EMA copy and the discriminator moved; the warm step,
    samples/s, peak memory and the stage split. Returns the launches."""
    from ciaosr_torch.models.builder import build_model
    from ciaosr_torch.ops import kernels

    res = build_model(cfg.model, train_cfg=cfg.train_cfg,
                      test_cfg=cfg.test_cfg)
    if not (res.generator.use_kernels and res.generator.dtype ==
            torch.float32):
        raise AssertionError("gan: the card's build_model must give f32 "
                             "params on the kernel route")
    n_blocks = len(swin_blocks(res.generator))
    state, step = gan_optimizers(res, cfg)
    rng = np.random.default_rng(7)
    batches = [gan_batch(rng, TRAIN_B, TRAIN_LR, TRAIN_QSIDE)
               for _ in range(GAN_STEPS + GAN_SPLIT_STEPS)]
    before = {name: [p.detach().clone() for p in mod.parameters()]
              for name, mod in (("generator", res.generator),
                                ("generator_ema", res.generator_ema),
                                ("discriminator", res.discriminator))}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def run():
        nonlocal state
        metrics, secs = [], []
        for bt in batches[:GAN_STEPS]:
            t = time.perf_counter()
            state, m = step(state, bt)
            torch.cuda.synchronize()   # for the per-step time only
            secs.append(time.perf_counter() - t)
            metrics.append(m)
        return metrics, secs

    fwd_kernels = ["swin_block", *BWD_KERNELS, "conv3x3_f32"]
    (metrics, secs), launches, _ = drive(
        f"gan {GAN_STEPS} GAN steps (batch {TRAIN_B} x {TRAIN_LR}^2, "
        f"{TRAIN_QSIDE ** 2} queries)", run, fwd_kernels,
        [k for k in kernels.LAUNCHES if k not in fwd_kernels])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: n_blocks * GAN_STEPS for k in fwd_kernels}
    want["conv3x3_f32"] = trunk_convs(cfg.model["generator"]) * GAN_STEPS
    got = {k: launches[k] for k in fwd_kernels}
    log(f"gan steps: launches per step "
        f"{ {k: v / GAN_STEPS for k, v in got.items()} } (want "
        f"{ {k: v / GAN_STEPS for k, v in want.items()} })")
    if got != want:
        raise AssertionError(f"gan steps: launches {got}, want {want}")
    keys = res.loss_keys() + ["loss_d_real", "loss_d_fake"]
    vals = torch.stack([torch.stack([m[k] for k in keys])
                        for m in metrics]).cpu()
    if not torch.isfinite(vals).all() or set(metrics[0]) != set(keys):
        raise AssertionError(f"gan steps: metrics {metrics}")
    for name, mod in (("generator", res.generator),
                      ("generator_ema", res.generator_ema),
                      ("discriminator", res.discriminator)):
        same = sum(torch.equal(p.detach(), q) for p, q in
                   zip(mod.parameters(), before[name]))
        if same:
            raise AssertionError(f"gan steps: {same} {name} parameters "
                                 "did not change")
    warm = statistics.median(secs[1:]) * 1e3
    log("gan steps: " + "; ".join(
        f"{k} {[round(float(v), 6) for v in vals[:, i]]}"
        for i, k in enumerate(keys)) + f"; step ms "
        f"{', '.join(f'{t * 1e3:.1f}' for t in secs)}")
    log(f"e2e ({kind}; {smi}): RealCiaoSR 002 GAN step (the shipped gan "
        f"model: f32 params, kernel route; synthetic VGG19), batch "
        f"{TRAIN_B} x {TRAIN_LR}^2 LR, {TRAIN_QSIDE ** 2} queries/sample: "
        f"warm {warm:.1f} ms/step (median of {len(secs) - 1}), "
        f"{TRAIN_B / warm * 1e3:.2f} samples/s, peak {peak:.2f} GiB")
    split = gan_split(res, state, batches[GAN_STEPS:])
    for k, v in split.items():
        log(f"stage gan {k}: {v:.3f} ms ({kind}; {smi})")
    return launches


def gan_route_check(cfg) -> None:
    """One G step's gradients (pixel, perceptual and GAN losses) of the
    gan model on a small batch: the kernel route (f32 params) and the
    plain bf16 route against the plain f32 route (``grad_route_check``'s
    rule); the discriminator and VGG19 the same in all three."""
    gen = cfg.model["generator"]
    routes = {"kernel": dict(gen, use_kernels=True),
              "plain bf16": dict(gen, dtype="bf16", use_kernels=False),
              "plain f32": dict(gen, use_kernels=False)}
    grad_route_check("gan route check (G step: pixel + perceptual + GAN)",
                     routes, lambda g: gan_restorer(cfg, g),
                     lambda res, b: res.generator_losses(b)[0],
                     gan_batch(np.random.default_rng(5), 1, 16, 16))


def gan_cli(drive, probe, root: Path, rows: dict) -> None:
    """Stage 1 (wogan) and stage 2 (GAN) of the shipped 002 configs
    through ``ciaosr_torch.tools.train`` on copies with a fixed crop,
    then ``ciaosr_torch.tools.test`` on the stage-1 work_dir."""
    from ciaosr_torch.convert.load import load_torch_checkpoint
    from ciaosr_torch.data.datasets import build_dataset
    from ciaosr_torch.data.imageio import imread, write_png
    from ciaosr_torch.models.builder import build_model
    from ciaosr_torch.models.real_restorer import RealCiaoSRRestorer
    from ciaosr_torch.models.restorers import tile_layout
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.tools import test as cli_test
    from ciaosr_torch.train.checkpoint import list_steps, read_checkpoint
    from ciaosr_torch.train.gan_trainer import GANTrainer

    hr = root / "data" / "DF2K" / "HR"
    hr.mkdir(parents=True)
    write_png(str(hr / "0001.png"),
              smooth_picture(np.random.default_rng(8), *GAN_HR))
    write_set5(root)
    copies = {}
    for name in ("wogan", "gan"):
        shipped = Path(config_path(f"002_real_{name}_"))
        copies[name] = root / f"002_{name}_gan_phase.py"
        copies[name].write_text(shipped.read_text() + GAN_OVERRIDES)
    cfg1 = Config.fromfile(str(copies["wogan"]))
    n_blocks = sum(cfg1.model["generator"]["encoder"]["depths"])
    n_convs = trunk_convs(cfg1.model["generator"])
    train_keys = ("swin_block",) + BWD_KERNELS

    def run(label, argv, iters):
        want = {k: n_blocks * iters for k in train_keys}
        want["conv3x3_f32"] = n_convs * iters
        trainer, _, secs = train_cli_run(drive, probe, label, argv, want)
        bad = [m for m in probe.metrics if not all(
            bool(torch.isfinite(v)) for v in m.values())]
        if bad:
            raise AssertionError(f"{label}: metrics {bad}")
        probe.metrics.clear()
        for k in train_keys + ("conv3x3_f32",):
            rows[k] = rows.get(k, 0) + want[k]
        return trainer, secs

    # ---- stage 1: wogan, the generator and its EMA copy
    trainer, secs = run(f"gan stage 1 (wogan, {GAN_STAGE1} iterations)",
                        [str(copies["wogan"]), "--total-iters",
                         str(GAN_STAGE1)], GAN_STAGE1)
    if trainer.d_optimizer is not None:
        raise AssertionError("gan stage 1: a discriminator optimizer")
    stage1 = Path(trainer.work_dir)
    log(f"gan stage 1: work_dir {stage1.name}, checkpoints "
        f"{list_steps(str(stage1 / 'checkpoints'))}, {secs:.2f} s")
    del trainer

    # ---- stage 2: the GAN, loading stage 1; straight to GAN_STAGE2, and
    # to GAN_CKPT then resumed; --deterministic for the same bits
    works = {w: root / "work_dirs" / f"gan_{w}" for w in ("straight", "cut")}
    # the weights each run starts from, after load_from and any resume
    starts = []
    real_resume = GANTrainer._maybe_resume

    def resume(trainer):
        real_resume(trainer)
        r = trainer.restorer
        starts.append({f"{name}.{k}": v.detach().cpu().clone()
                       for name, mod in (("generator", r.generator),
                                         ("generator_ema", r.generator_ema))
                       for k, v in mod.state_dict().items()})

    GANTrainer._maybe_resume = resume
    try:
        for label, work, total, iters in (
                ("straight", "straight", GAN_STAGE2, GAN_STAGE2),
                ("to the checkpoint", "cut", GAN_CKPT, GAN_CKPT),
                ("resumed", "cut", GAN_STAGE2, GAN_STAGE2 - GAN_CKPT)):
            trainer, secs = run(
                f"gan stage 2 {label} (to {total})",
                [str(copies["gan"]), "--total-iters", str(total),
                 "--work-dir", str(works[work]), "--deterministic"], iters)
            if label == "resumed" and probe.resumed[-1][0] != GAN_CKPT:
                raise AssertionError(f"gan stage 2: resumed at "
                                     f"{probe.resumed[-1][0]}")
            del trainer
    finally:
        GANTrainer._maybe_resume = real_resume
    stage1_sd = read_checkpoint(str(stage1 / "checkpoints" /
                                    f"iter_{GAN_STAGE1}.pth"))["state_dict"]
    unseeded = [k for k, v in starts[0].items()
                if not torch.equal(v, stage1_sd[k])]
    log(f"gan stage 2: load_from seeded {len(starts[0])} generator and EMA "
        f"tensors from stage 1's iter_{GAN_STAGE1}.pth; differing "
        f"{unseeded[:4]}")
    if unseeded:
        raise AssertionError(f"gan stage 2: load_from left {unseeded[:4]}")
    a, b = (read_checkpoint(str(works[w] / "checkpoints" /
                                f"iter_{GAN_STAGE2}.pth"))
            for w in ("straight", "cut"))
    diff = []

    def compare(x, y, path):
        if isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                diff.append(path)
        elif isinstance(x, dict):
            if set(x) != set(y):
                diff.append(f"{path} keys")
            for k in x:
                if k != "meta" and k in y:
                    compare(x[k], y[k], f"{path}/{k}")
        elif isinstance(x, list):
            for i, (u, v) in enumerate(zip(x, y)):
                compare(u, v, f"{path}/{i}")
        elif x != y:
            diff.append(path)

    compare(a, b, "")
    sd = a["state_dict"]
    counts = {p: sum(k.startswith(p + ".") for k in sd)
              for p in ("generator", "generator_ema", "discriminator")}
    n_sn = sum(k.endswith((".u", ".sigma")) for k in sd)
    n_adam = {k: len(v["state"]) for k, v in a["optimizer"].items()}
    log(f"gan stage 2: iter_{GAN_STAGE2}.pth straight against resumed at "
        f"{GAN_CKPT}: tensors {counts}, SN stats {n_sn}, Adam states "
        f"{n_adam}; differing {diff[:8]}")
    if diff or set(n_adam) != {"generator", "discriminator"} or not n_sn:
        raise AssertionError(f"gan stage 2: the resumed run differs from "
                             f"the straight one at {diff[:8]}")

    # ---- tools.test on the stage-1 work_dir: the EMA copy, tiled
    test_lrs = [imread(f"data/Classical/Set5/LRbicx4/{n}.png").shape[:2]
                for n, _ in CLI_SET5]
    tc = cfg1.test_cfg
    want: dict = {}
    for h, w in test_lrs:
        t, hs, ws = tile_layout(h, w, 4, tc["tile"], tc["tile_overlap"])
        for k, n in (("swin_block", n_blocks), ("f3p_build", 1),
                     ("wt_hoist", 1), ("grid_decode", 1),
                     ("conv3x3_f32", n_convs)):
            want[k] = want.get(k, 0) + n * len(hs) * len(ws)
            row = {"f3p_build": "f3p_build@C180", "wt_hoist": "wt_hoist@C180",
                   "grid_decode": "grid_decode@C180"}.get(k)
            if k == "swin_block" and -(-t // 8) * 8 == 72:
                row = "swin_block@72x72"
            if row:
                rows[row] = rows.get(row, 0) + n * len(hs) * len(ws)
    outs = []
    real_ft = RealCiaoSRRestorer.forward_test

    def recorded(self, *a, **kw):
        out = real_ft(self, *a, **kw)
        outs.append(out)
        return out

    RealCiaoSRRestorer.forward_test = recorded
    try:
        metrics, launches, secs = drive(
            f"gan tools.test on the stage-1 work_dir (want {want})",
            lambda: cli_test.main([str(copies["wogan"]), str(stage1)]),
            list(want), [k for k in kernels.LAUNCHES if k not in want])
    finally:
        RealCiaoSRRestorer.forward_test = real_ft
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"gan tools.test: launches {got}, want {want}")
    newest = str(stage1 / "checkpoints" / f"iter_{GAN_STAGE1}.pth")
    res = build_model(cfg1.model, test_cfg=tc)
    res.generator.load_state_dict(load_torch_checkpoint(
        newest, cfg1.model, strict=True), strict=True)
    res.generator_ema.load_state_dict(load_torch_checkpoint(
        newest, cfg1.model, ema=True, strict=True), strict=True)
    dataset = build_dataset(cfg1.data["test"])
    worst = 0.0
    for i in range(len(dataset)):
        smp = dataset[i]
        meta = smp["meta"]
        mine = res.forward_test(smp["lq"], target_shape=meta["target_size"],
                                scale=meta["scale"])
        worst = max(worst, float(np.abs(mine - outs[i]).max()))
    log(f"gan tools.test on the stage-1 work_dir: {secs:.2f} s, "
        f"{metrics['n_images']} images (tile {tc['tile']}); |CLI - the "
        f"EMA copy's own forward_test| max {worst:.3e}")
    if len(outs) != len(dataset) or not worst <= 1e-6:
        raise AssertionError(f"gan tools.test: {len(outs)} outputs, "
                             f"max |d| {worst:.3e}")
    del res


# part gan_shipped: both shipped 002 configs through tools.train with their
# own train pipeline (the Real-ESRGAN degradation chain) and loader (batch
# 6, 6 forked workers), on derived copies that set only the data paths and
# the hook intervals; the iterations of each stage (the command line's
# --total-iters), SHIPPED_N seeded DF2K-shaped pictures of SHIPPED_HR
# (the 400² crop draws), the samples of the per-op chain times
SHIPPED_ITERS, SHIPPED_N, SHIPPED_HR = 6, 12, (480, 512)
CHAIN_SAMPLES = 24
SHIPPED_OVERRIDES = """
# chip_smoke phase gan, part gan_shipped: data paths and hook intervals
data['train']['dataset']['gt_folder'] = 'data/DF2K/HR'
data['val']['gt_folder'] = 'data/val'
checkpoint_config = dict(checkpoint_config, interval={iters})
log_config = dict(interval=1)
"""


def chain_op_ms(cfg, n: int = CHAIN_SAMPLES) -> tuple[dict, float]:
    """One process's time in each group of the train pipeline's ops over
    ``n`` samples of ``cfg``'s train split (seeded generators): the
    median ms a sample of each group and of the whole sample."""
    from ciaosr_torch.data import degradations as dg
    from ciaosr_torch.data.datasets import build_dataset

    groups = {"filters": (dg.RandomBlur,),
              "resizes": (dg.RandomResize, dg.RandomScaleResize),
              "noise": (dg.RandomNoise,),
              "JPEG": (dg.RandomJPEGCompression,),
              "USM": (dg.UnsharpMasking,)}
    spent = dict.fromkeys(groups, 0.0)
    real = {}
    for group, classes in groups.items():
        for cls in classes:
            real[cls] = cls.__call__

            def call(self, results, _cls=cls, _g=group):
                t = time.perf_counter()
                out = real[_cls](self, results)
                spent[_g] += time.perf_counter() - t
                return out
            cls.__call__ = call
    per = {g: [] for g in groups}
    total = []
    try:
        ds = build_dataset(cfg.data["train"])
        for i in range(n):
            for g in spent:
                spent[g] = 0.0
            t = time.perf_counter()
            ds.load(i % len(ds), np.random.default_rng((7, i)))
            total.append((time.perf_counter() - t) * 1e3)
            for g in groups:
                per[g].append(spent[g] * 1e3)
    finally:
        for cls, fn in real.items():
            cls.__call__ = fn
    return ({g: statistics.median(v) for g, v in per.items()},
            statistics.median(total))


def gan_shipped(drive, probe, root: Path, rows: dict, kind: str,
                smi: str) -> None:
    """Stage 1 (wogan, SHIPPED_ITERS iterations) and stage 2 (GAN,
    SHIPPED_ITERS iterations, ``load_from`` of stage 1's work_dir as
    shipped) of the shipped 002 configs through ``tools.train`` with their
    own train pipeline and loader: exact launches, finite losses, every
    parameter with a gradient changed; the warm iteration, samples/s and
    the loader's wait share; then the loader alone and one process's
    per-op chain times."""
    from ciaosr_torch.data.imageio import write_png
    from ciaosr_torch.train.gan_trainer import GANTrainer

    rng = np.random.default_rng(24)
    hr = root / "data" / "DF2K" / "HR"
    hr.mkdir(parents=True)
    for i in range(SHIPPED_N):
        write_png(str(hr / f"{i + 1:04d}.png"),
                  smooth_picture(rng, *SHIPPED_HR))
    (root / "data" / "val").mkdir()
    write_png(str(root / "data" / "val" / "0001.png"),
              smooth_picture(rng, 48, 48))
    copies = {}
    for name in ("wogan", "gan"):
        shipped = Path(config_path(f"002_real_{name}_"))
        copies[name] = root / f"002_{name}_shipped.py"
        copies[name].write_text(shipped.read_text() + SHIPPED_OVERRIDES.format(
            iters=SHIPPED_ITERS))
    cfg = Config.fromfile(str(copies["wogan"]))
    loader_cfg = (cfg.data["workers_per_gpu"], cfg.data["worker_mode"],
                  cfg.data["train_dataloader"]["samples_per_gpu"])
    if loader_cfg != (6, "process", 6):
        raise AssertionError(f"gan_shipped: loader {loader_cfg}")
    b = loader_cfg[2]
    n_blocks = sum(cfg.model["generator"]["encoder"]["depths"])
    train_keys = ("swin_block",) + BWD_KERNELS
    want = {k: n_blocks * SHIPPED_ITERS for k in train_keys}
    want["conv3x3_f32"] = trunk_convs(cfg.model["generator"]) * SHIPPED_ITERS

    before = {}
    real_resume = GANTrainer._maybe_resume

    def resume(trainer):    # the weights the loop starts from
        real_resume(trainer)
        r = trainer.restorer
        before.clear()
        for part in ("generator", "discriminator"):
            mod = getattr(r, part)
            if mod is not None:
                before[part] = {k: v.detach().cpu().clone()
                                for k, v in mod.named_parameters()}

    GANTrainer._maybe_resume = resume
    try:
        for name in ("wogan", "gan"):
            label = f"gan_shipped {name} ({SHIPPED_ITERS} iterations)"
            # the steps timed outside a loop (gan_steps) have no wait
            probe.ends.clear()
            probe.waits.clear()
            trainer, peak, secs = train_cli_run(
                drive, probe, label, [str(copies[name]), "--total-iters",
                                      str(SHIPPED_ITERS)], want)
            bad = [m for m in probe.metrics if not all(
                bool(torch.isfinite(v)) for v in m.values())]
            if bad:
                raise AssertionError(f"{label}: metrics {bad}")
            probe.metrics.clear()
            r = trainer.restorer
            if (r.discriminator is None) != (name == "wogan"):
                raise AssertionError(f"{label}: discriminator "
                                     f"{type(r.discriminator)}")
            for part, start in before.items():
                changed_parameters(getattr(r, part), start)
            n_grad = {part: sum(p.grad is not None for p in getattr(
                r, part).parameters()) for part in before}
            log(f"{label}: every parameter with a gradient changed "
                f"({n_grad} with gradients)")
            ends = [t for _, t in probe.ends]
            waits = probe.waits
            if len(ends) != SHIPPED_ITERS or len(waits) != SHIPPED_ITERS:
                raise AssertionError(f"{label}: {len(ends)} steps, "
                                     f"{len(waits)} loader waits")
            its = [(t1 - t0) * 1e3 for t0, t1 in zip(ends, ends[1:])]
            warm = statistics.median(its)
            share = sum(waits[2:]) * 1e3 / sum(its[1:])
            log(f"e2e ({kind}; {smi}): gan_shipped {name} as shipped (f32 "
                f"params, kernel route; its train pipeline; batch {b}, "
                f"{loader_cfg[0]} {loader_cfg[1]} workers): iterations 2-"
                f"{SHIPPED_ITERS} {[round(t, 1) for t in its]} ms, warm "
                f"iteration {warm:.1f} ms (median, loader wait included), "
                f"{b / warm * 1e3:.2f} samples/s; loader wait share over "
                f"iterations 3-{SHIPPED_ITERS} {share:.3f} (waits "
                f"{[round(w * 1e3, 1) for w in waits]} ms); peak "
                f"{peak:.2f} GiB; {secs:.2f} s in all")
            for k in train_keys + ("conv3x3_f32",):
                rows[k] = rows.get(k, 0) + want[k]
            del trainer, r
            torch.cuda.empty_cache()
    finally:
        GANTrainer._maybe_resume = real_resume
    rate, _, workers = loader_rate(cfg)
    log(f"e2e ({kind}; {smi}): gan_shipped the train loader alone as "
        f"tools.train builds it ({workers} process workers, batch {b}): "
        f"{rate:.3f} batches/s ({rate * b:.2f} samples/s)")
    per, total = chain_op_ms(cfg)
    log(f"e2e ({kind}; {smi}): gan_shipped one process's chain, median of "
        f"{CHAIN_SAMPLES} samples: {total:.1f} ms a sample; by op group "
        + ", ".join(f"{g} {t:.1f} ms" for g, t in per.items())
        + f", the rest {total - sum(per.values()):.1f} ms")


def gan_phase(drive, kind: str, smi: str) -> dict:
    """Phase "gan": the shipped 002 configs' RealCiaoSR on the card (f32
    params, the kernel route, VGG19 on the explicit synthetic opt-in:
    ``CIAOSR_VGG19_SYNTHETIC``, logged):

    1. GAN_STEPS GAN steps of the shipped gan model at the 002 batch, with
       exact launches, the warm step, samples/s, peak memory and the
       stage split (``gan_steps``);
    2. one G step's gradients, kernel route against the plain f32 route
       (``gan_route_check``);
    3. stage 1 (wogan) through ``ciaosr_torch.tools.train`` on a config
       copy with a fixed crop, GAN_STAGE1 iterations;
    4. stage 2 (GAN) through ``tools.train``: ``load_from`` stage 1 (the
       generator and its EMA copy start as stage 1's newest checkpoint
       holds them), GAN_STAGE2 iterations straight, and GAN_CKPT then
       resumed: the
       generator, its EMA copy, the discriminator with its spectral norms'
       stats, both Adam states and both schedules bit-equal at the end
       (``--deterministic``);
    5. ``ciaosr_torch.tools.test`` on the stage-1 work_dir (its test_cfg:
       ×4, tile 128) on phase "cli"'s Set5-shaped folder, exact launches,
       its outputs equal (≤ 1e-6) to the EMA copy's own ``forward_test``;
    6. part gan_shipped: both shipped configs through ``tools.train`` with
       their own train pipeline and loader (``gan_shipped``).

    Returns each kernel row's launches (the train kernels under their
    launch keys: the caller puts them on the rows of its train batch)."""
    rows: dict = {}
    cwd = os.getcwd()
    opt_in = os.environ.get("CIAOSR_VGG19_SYNTHETIC")
    os.environ["CIAOSR_VGG19_SYNTHETIC"] = "1"
    log("gan: VGG19 on the explicit synthetic opt-in "
        "(CIAOSR_VGG19_SYNTHETIC=1): seeded random weights; no weights can "
        "be fetched")
    probe = TrainProbe()
    try:
        cfg = Config.fromfile(config_path("002_real_gan_"))
        t0 = time.perf_counter()
        for k, n in gan_steps(drive, kind, smi, cfg).items():
            if n and k in ("swin_block", "conv3x3_f32") + BWD_KERNELS:
                rows[k] = rows.get(k, 0) + n
        torch.cuda.empty_cache()
        log(f"gan steps and split: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        gan_route_check(cfg)
        log(f"gan route check: {time.perf_counter() - t0:.2f} s")
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            t0 = time.perf_counter()
            gan_cli(drive, probe, Path(tmp), rows)
            log(f"gan stages 1, 2 and tools.test: "
                f"{time.perf_counter() - t0:.2f} s")
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            t0 = time.perf_counter()
            gan_shipped(drive, probe, Path(tmp), rows, kind, smi)
            log(f"gan_shipped: {time.perf_counter() - t0:.2f} s")
    finally:
        os.chdir(cwd)
        probe.close()
        if opt_in is None:
            del os.environ["CIAOSR_VGG19_SYNTHETIC"]
        else:
            os.environ["CIAOSR_VGG19_SYNTHETIC"] = opt_in
        torch.cuda.empty_cache()
    return rows


# ---- the fixed-scale restorer (phase "basic"): BasicRestorer configs
# modelled on the 001 configs through tools.test, tools.inference and
# tools.train, f32 (TF32 off), on seeded pictures; its nets run cuDNN
# convolutions and launch no kernel of the port
# Set5's GTmod12 shapes: multiples of 12, so the ×3 and ×4 LR images are
# whole; LR sides such as 126, 63, 69 and 57 are no multiple of 8
BASIC_SET5 = (("baby", (504, 504)), ("bird", (288, 288)),
              ("butterfly", (252, 252)), ("head", (276, 276)),
              ("woman", (228, 336)))
# DIV2K-shaped training pictures (multiples of 12, each side ≥ the patch)
BASIC_HR = ((264, 264), (240, 300), (300, 240), (228, 336))
# config name → (generator, scale, test_cfg window_size): RDN's published
# ×4 net, and EDSR's at ×3 (the upsampler's ×3 step) with the window pad
BASIC_NETS = {
    "rdn": (dict(type="RDNNet", in_channels=3, out_channels=3,
                 mid_channels=64, num_blocks=16, num_layers=8,
                 channel_growth=64, upscale_factor=4), 4, 1),
    "edsr": (dict(type="EDSRNet", in_channels=3, out_channels=3,
                  mid_channels=64, num_blocks=16, upscale_factor=3,
                  res_scale=1.0, rgb_mean=RGB_MEAN,
                  rgb_std=(1.0, 1.0, 1.0)), 3, 8)}
# training the rdn config: batch, GT patch, iterations, checkpoint interval
BASIC_TRAIN = dict(batch=16, patch=192, iters=6, interval=3)
# the card's output against the CPU's on the same weights: max|d|/max|ref|
BASIC_CPU_TOL = 1e-4
# the inference CLI's refused case: an LR picture larger than --tile
BASIC_TILE, BASIC_WIDE = 192, (200, 240)
# H100 SXM f32 peak outside the tensor cores (NVIDIA data sheet): the
# bound of an f32 conv net with TF32 off
PEAK_F32_FLOPS = 67e12

BASIC_CONFIG = """\
# chip_smoke phase basic: a BasicRestorer config modelled on the 001 ones
exp_name = 'basic_{name}'
scale = {scale}
model = dict(
    type='BasicRestorer',
    generator={generator},
    pixel_loss=dict(type='L1Loss', loss_weight=1.0, reduction='mean'))
train_cfg = None
test_cfg = dict(metrics=['PSNR', 'SSIM'], crop_border=scale,
                convert_to='y', window_size={window})
train_pipeline = [
    dict(type='LoadImageFromFile', io_backend='disk', key='lq',
         flag='color', channel_order='rgb'),
    dict(type='LoadImageFromFile', io_backend='disk', key='gt',
         flag='color', channel_order='rgb'),
    dict(type='RescaleToZeroOne', keys=['lq', 'gt']),
    dict(type='PairedRandomCrop', gt_patch_size={patch}),
    dict(type='Flip', keys=['lq', 'gt'], flip_ratio=0.5,
         direction='horizontal'),
    dict(type='Flip', keys=['lq', 'gt'], flip_ratio=0.5,
         direction='vertical'),
    dict(type='RandomTransposeHW', keys=['lq', 'gt'], transpose_ratio=0.5),
    dict(type='Collect', keys=['lq', 'gt'], meta_keys=['lq_path', 'gt_path']),
    dict(type='ImageToTensor', keys=['lq', 'gt'])
]
test_pipeline = [
    dict(type='LoadImageFromFile', io_backend='disk', key='lq',
         flag='color', channel_order='rgb'),
    dict(type='LoadImageFromFile', io_backend='disk', key='gt',
         flag='color', channel_order='rgb'),
    dict(type='RescaleToZeroOne', keys=['lq', 'gt']),
    dict(type='Collect', keys=['lq', 'gt'], meta_keys=['lq_path', 'gt_path']),
    dict(type='ImageToTensor', keys=['lq', 'gt'])
]
data_dir = 'data'
data = dict(
    workers_per_gpu={workers},
    train_dataloader=dict(samples_per_gpu={batch}, drop_last=True),
    train=dict(
        type='RepeatDataset',
        times=1000,
        dataset=dict(type='SRFolderDataset',
                     lq_folder=f'{{data_dir}}/DIV2K/LRbicx{scale}',
                     gt_folder=f'{{data_dir}}/DIV2K/HR',
                     pipeline=train_pipeline, scale=scale)),
    val=dict(type='SRFolderDataset',
             lq_folder=f'{{data_dir}}/Set5/LRbicx{scale}',
             gt_folder=f'{{data_dir}}/Set5/GTmod12',
             pipeline=test_pipeline, scale=scale),
    test=dict(type='SRFolderDataset',
              lq_folder=f'{{data_dir}}/Set5/LRbicx{scale}',
              gt_folder=f'{{data_dir}}/Set5/GTmod12',
              pipeline=test_pipeline, scale=scale))
optimizers = dict(type='Adam', lr=1.e-4, betas=(0.9, 0.999))
total_iters = {iters}
lr_config = dict(policy='Step', by_epoch=False, step=[200000], gamma=0.5)
checkpoint_config = dict(interval={interval}, save_optimizer=True,
                         by_epoch=False)
evaluation = dict(interval={iters}, save_image=False)
log_config = dict(interval=1)
work_dir = './work_dirs/basic_{name}'
test_checkpoint_path = './work_dirs/basic_{name}/latest'
"""


def write_basic_config(root: Path, name: str, workers: int = 8) -> str:
    """``root``/basic_{name}.py: BASIC_CONFIG with BASIC_NETS[name]'s
    generator, scale and window and BASIC_TRAIN's batch, patch,
    iterations and checkpoint interval (an eval at the last iteration)."""
    gen, scale, window = BASIC_NETS[name]
    path = root / f"basic_{name}.py"
    path.write_text(BASIC_CONFIG.format(
        name=name, scale=scale, generator=repr(gen), window=window,
        workers=workers, **BASIC_TRAIN))
    return str(path)


def write_basic_data(root: Path) -> None:
    """data/Set5/{GTmod12,LRbicx<s>} and data/DIV2K/{HR,LRbicx<s>} under
    ``root`` for each scale of BASIC_NETS: seeded smooth pictures of
    BASIC_SET5's and BASIC_HR's shapes and their MATLAB-bicubic LR images
    (the port's imresize_np), uint8 PNGs by the port's codec; and
    data/wide.png, an LR picture of BASIC_WIDE."""
    from ciaosr_torch.core.resize import imresize_np
    from ciaosr_torch.data.imageio import write_png

    rng = np.random.default_rng(25)
    scales = sorted({s for _, s, _ in BASIC_NETS.values()})
    base = root / "data"
    for folder, gt_sub, pictures in (
            ("Set5", "GTmod12", BASIC_SET5),
            ("DIV2K", "HR", [(f"{i + 1:04d}", hw)
                             for i, hw in enumerate(BASIC_HR)])):
        for sub in [gt_sub] + [f"LRbicx{s}" for s in scales]:
            (base / folder / sub).mkdir(parents=True)
        for name, (h, w) in pictures:
            gt = smooth_picture(rng, h, w)
            write_png(str(base / folder / gt_sub / f"{name}.png"), gt)
            for s in scales:
                lq = imresize_np(gt.astype(np.float32) / 255.0, scale=1 / s)
                write_png(str(base / folder / f"LRbicx{s}" / f"{name}.png"),
                          np.clip(np.round(lq * 255.0), 0,
                                  255).astype(np.uint8))
    write_png(str(base / "wide.png"), smooth_picture(rng, *BASIC_WIDE))


def basic_flops(net, h: int, w: int) -> float:
    """The FLOPs of a fixed-scale net's forward on an h × w LR picture:
    2·C_in·C_out·k² a conv's output pixel, the trunk's convs at h × w,
    upsampling step j's conv at the resolution the steps before it made,
    conv_last at the output's."""
    import math

    import torch.nn as nn

    total = 0.0
    for name, m in net.named_modules():
        if not isinstance(m, nn.Conv2d):
            continue
        if name.startswith("upsample."):
            f = math.prod(net.upsample.factors[:int(name.split(".")[1])])
        elif name == "conv_last":
            f = net.upscale_factor
        else:
            f = 1
        total += 2.0 * m.weight.numel() * h * w * f * f
    return total


def basic_warm_eval(res, samples, reps: int = 3) -> tuple[list, list]:
    """Each sample's ``forward_test`` once to warm cuDNN, then ``reps``
    passes over the samples timed by the host clock (a call ends in its
    output's copy to the host). Returns the outputs and each sample's
    median ms."""
    for smp in samples:
        res.forward_test(smp["lq"])
    times = [[] for _ in samples]
    for _ in range(reps):
        outs = []
        for smp, ts in zip(samples, times):
            torch.cuda.synchronize()
            t = time.perf_counter()
            outs.append(res.forward_test(smp["lq"]))
            ts.append((time.perf_counter() - t) * 1e3)
    return outs, [statistics.median(ts) for ts in times]


def basic_profile(label: str, fn, top: int = 6) -> None:
    """One warm call of ``fn`` by kernel (torch.profiler, after one
    warm-up): the device total, its share of the call's host wall (one
    stream: the device's busy share) and the ``top`` kernels, whose names
    say which algorithm cuDNN runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    seen = {}
    with profile(activities=[ProfilerActivity.CUDA],
                 on_trace_ready=lambda p: seen.update(evs=p.key_averages()),
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
            prof.step()
    evs = sorted((e for e in seen["evs"] if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.device_time_total)
    total = sum(e.device_time_total for e in evs) / 1e3
    log(f"basic profile of {label}: device {total:.2f} ms of a {wall:.2f} ms "
        f"call (busy {total / wall:.3f}) in "
        f"{sum(e.count for e in evs)} launches; top: " + "; ".join(
            f"{e.key[:70]} {e.device_time_total / 1e3:.2f} ms x{e.count}"
            for e in evs[:top]))


# the metrics of phase "basic", run by a Python in which ``import cv2``
# fails: NIQE (y and gray) of one output (argv[1], a uint8 BGR .npy) and the
# four matting metrics on a seeded 512² matte; prints one JSON object
BASIC_METRICS_CODE = r"""
import json, sys, time
sys.modules["cv2"] = None
import numpy as np
from ciaosr_torch.core import metrics as m
try:
    import cv2
    sys.exit("cv2 importable")
except ImportError:
    pass
out = {}


def timed(key, fn, *args, **kw):
    ms = []
    for _ in range(2):   # the first call, then a warm one
        t = time.perf_counter()
        v = fn(*args, **kw)
        ms.append((time.perf_counter() - t) * 1e3)
    out[key] = [v] + ms


img = np.load(sys.argv[1])
for ct in ("y", "gray"):
    timed("niqe_" + ct, m.niqe, img, crop_border=4, convert_to=ct)
rng = np.random.default_rng(0)
y, x = np.mgrid[0:512, 0:512] / 512
alpha = np.clip(np.round((np.sin(6 * y + 4 * x) + 1) * 160 - 32), 0,
                255).astype(np.uint8)
trimap = np.full(alpha.shape, 128, np.uint8)
trimap[alpha == 0], trimap[alpha == 255] = 0, 255
pred = np.clip(alpha + rng.integers(-40, 41, alpha.shape), 0,
               255).astype(np.uint8)
pred[trimap == 0], pred[trimap == 255] = 0, 255
for name in ("sad", "mse", "gradient_error", "connectivity"):
    timed(name, getattr(m, name), alpha, trimap, pred)
out["imported"] = sorted({k.split(".")[0] for k, v in sys.modules.items()
                          if v is not None and k.split(".")[0] in (
                              "cv2", "PIL", "jax", "jaxlib", "flax",
                              "ciaosr_tpu")})
print(json.dumps(out))
"""


def basic_metrics(img_bgr: np.ndarray, tmp: Path) -> None:
    """BASIC_METRICS_CODE in a subprocess from the repository root: every
    score finite, nothing of OpenCV, Pillow or JAX imported; logs each
    score and its ms."""
    npy = tmp / "basic_output.npy"
    np.save(npy, img_bgr)
    run = subprocess.run(
        [sys.executable, "-c", BASIC_METRICS_CODE, str(npy)],
        cwd=str(Path(__file__).resolve().parent), capture_output=True,
        text=True, timeout=300)
    if run.returncode:
        raise AssertionError(f"basic metrics without cv2: rc "
                             f"{run.returncode}\n{run.stderr[-3000:]}")
    got = json.loads(run.stdout.strip().splitlines()[-1])
    imported = got.pop("imported")
    log("basic metrics (cv2 unimportable, host; ms of the first call, "
        "then a warm one): " + "; ".join(
            f"{k} {v:.6f} in {first:.1f}, {warm:.1f} ms"
            for k, (v, first, warm) in got.items())
        + f" on a {img_bgr.shape[0]}x{img_bgr.shape[1]} output and a "
        "512^2 matte")
    if imported or not all(np.isfinite(v) for v, _, _ in got.values()):
        raise AssertionError(f"basic metrics: {got}, imported {imported}")


def basic_eval(drive, kind: str, smi: str, name: str, path: str) -> tuple:
    """``tools.test`` with random weights on the config at ``path`` (exactly
    no launch, finite PSNR and SSIM), then the same restorer (seed 0, as
    the CLI builds it) warm: its metrics equal to the CLI's (≤ 1e-6), the
    ms a picture, MP/s and peak memory beside the f32 bound; its output on
    the last picture against the same weights on the CPU. Returns the
    config and the restorer's outputs."""
    from ciaosr_torch.data.datasets import build_dataset
    from ciaosr_torch.models.builder import build_model
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.tools import test as cli_test

    cfg = Config.fromfile(path)
    torch.cuda.reset_peak_memory_stats()
    metrics, _, secs = drive(f"basic {name} tools.test (random weights)",
                             lambda: cli_test.main([path, "random"]), [],
                             list(kernels.LAUNCHES))
    if not all(np.isfinite(metrics[k]) for k in ("PSNR", "SSIM")):
        raise AssertionError(f"basic {name} tools.test: {metrics}")
    res = build_model(cfg.model, test_cfg=cfg.test_cfg)
    dataset = build_dataset(cfg.data["test"])
    samples = [dataset[i] for i in range(len(dataset))]
    outs, ms = basic_warm_eval(res, samples)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mine = {k: float(np.mean([res.evaluate(o, smp["gt"])[k]
                              for o, smp in zip(outs, samples)]))
            for k in ("PSNR", "SSIM")}
    if any(abs(mine[k] - metrics[k]) > 1e-6 for k in mine):
        raise AssertionError(f"basic {name}: tools.test {metrics}, the same "
                             f"restorer {mine}")
    s = res.generator.upscale_factor
    lrs = [smp["lq"].shape[:2] for smp in samples]
    flops = sum(basic_flops(res.generator, h, w) for h, w in lrs)
    mp = sum(h * w * s * s for h, w in lrs) / 1e6
    log(f"e2e ({kind}; {smi}): basic {name} x{s} (BasicRestorer "
        f"{res.generator.__class__.__name__}, f32, TF32 off, window "
        f"{cfg.test_cfg['window_size']}) tools.test on {len(samples)} "
        f"pictures {[tuple(hw) for hw in lrs]} in {secs:.2f} s (cold), "
        f"PSNR {metrics['PSNR']:.4f} SSIM {metrics['SSIM']:.4f}; warm "
        f"forward_test {[round(t, 2) for t in ms]} ms (each the median of "
        f"3), "
        f"{statistics.median(ms):.2f} ms a picture (median), "
        f"{mp / sum(ms) * 1e3:.3f} MP/s over the {mp:.3f} MP out, "
        f"{flops / 1e12:.3f} TFLOP: {tflops(flops, sum(ms)):.2f} TFLOP/s, "
        f"f32 bound {flops / PEAK_F32_FLOPS * 1e3:.2f} ms "
        f"({sum(ms) / (flops / PEAK_F32_FLOPS * 1e3):.1f}x); peak "
        f"{peak:.3f} GiB")

    cpu = build_model(cfg.model, test_cfg=cfg.test_cfg, device="cpu")
    lq = samples[-1]["lq"]
    t0 = time.perf_counter()
    ref = cpu.predict(lq)
    cpu_s = time.perf_counter() - t0
    rel = float(np.abs(outs[-1] - ref).max() / np.abs(ref).max())
    log(f"basic {name}: the card's output on {lq.shape[0]}x{lq.shape[1]} "
        f"against the same weights on the CPU ({cpu_s:.2f} s): "
        f"max|d|/max|ref| {rel:.3e} (limit {BASIC_CPU_TOL:g})")
    if not rel <= BASIC_CPU_TOL:
        raise AssertionError(f"basic {name}: card vs CPU {rel}")
    basic_profile(f"{name}'s forward on {lq.shape[0]}x{lq.shape[1]}",
                  lambda: res.forward_test(lq))
    return outs


def basic_infer(drive, path: str) -> None:
    """``tools.inference --tile 0`` on the rdn config's last Set5 LR
    picture (the PNG's shape is the picture's × the net's scale), and
    ``--tile BASIC_TILE`` on a larger picture: the ValueError naming
    ``--tile 0``. Neither launches a kernel."""
    from ciaosr_torch.data.imageio import imread
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.tools import inference as cli_inference

    scale = BASIC_NETS["rdn"][1]
    src = f"data/Set5/LRbicx{scale}/{BASIC_SET5[-1][0]}.png"
    (written,), _, secs = drive(
        "basic rdn tools.inference --tile 0",
        lambda: cli_inference.main([path, "random", "--img", src, "--scale",
                                    str(scale), "--tile", "0", "--out",
                                    "basic_sr.png"]), [],
        list(kernels.LAUNCHES))
    h, w = imread(src).shape[:2]
    got = imread(written).shape
    log(f"basic rdn tools.inference --tile 0: {h}x{w} -> {got} in "
        f"{secs:.2f} s")
    if got != (h * scale, w * scale, 3):
        raise AssertionError(f"basic inference: {got}")

    def tiled():
        try:
            cli_inference.main([path, "random", "--img", "data/wide.png",
                                "--scale", str(scale), "--tile",
                                str(BASIC_TILE)])
        except ValueError as e:
            return str(e)
        return None

    msg, _, _ = drive(f"basic rdn tools.inference --tile {BASIC_TILE}",
                      tiled, [], list(kernels.LAUNCHES))
    log(f"basic rdn tools.inference --tile {BASIC_TILE} on "
        f"{BASIC_WIDE[0]}x{BASIC_WIDE[1]}: ValueError {msg!r}")
    if not msg or "--tile 0" not in msg:
        raise AssertionError(f"basic inference --tile: {msg!r}")


def basic_train(drive, kind: str, smi: str, path: str) -> None:
    """``tools.train --deterministic`` on the rdn config (BASIC_TRAIN:
    checkpoints at its interval and the end, an eval at the end): no
    launch, finite losses, every parameter changed; ``iter_<last>.pth``
    loads strictly; ``tools.test`` on the work_dir gives the metrics of
    the trained restorer in memory, and a restorer loaded by the CLI's
    own ``load_weights`` gives its outputs bit for bit; the CLI loop's
    iteration, a warm step, the loader's share and alone, peak memory,
    the f32 bound, and one step by kernel."""
    from ciaosr_torch.convert.load import load_torch_checkpoint
    from ciaosr_torch.data.datasets import build_dataset
    from ciaosr_torch.eval.evaluator import evaluate_dataset
    from ciaosr_torch.models.builder import build_generator, build_model
    from ciaosr_torch.ops import kernels
    from ciaosr_torch.train.checkpoint import list_steps
    from ciaosr_torch.train.trainer import to_device
    from ciaosr_torch.tools import test as cli_test

    cfg = Config.fromfile(path)
    iters, every = BASIC_TRAIN["iters"], BASIC_TRAIN["interval"]
    before = build_generator(cfg.model["generator"], device="cpu",
                             seed=0).state_dict()
    probe = TrainProbe()
    try:
        trainer, peak, secs = train_cli_run(
            drive, probe, f"basic rdn {iters} iterations (--deterministic)",
            [path, "--deterministic"], {})
        changed_parameters(trainer.state.generator, before)
        work = Path(trainer.work_dir)
        hooks = set(range(every, iters + 1, every)) | {iters}
        ckpts = list_steps(str(work / "checkpoints"))
        if ckpts != sorted(hooks):
            raise AssertionError(f"basic train: checkpoints {ckpts}")
        ms, share, n = probe.loop_stats(hooks)
    finally:
        probe.close()
    res = build_model(cfg.model, test_cfg=cfg.test_cfg, seed=1)
    res.generator.load_state_dict(load_torch_checkpoint(
        str(work / "checkpoints" / f"iter_{iters}.pth"), cfg.model,
        strict=True), strict=True)

    dataset = build_dataset(cfg.data["test"])
    want = evaluate_dataset(trainer.restorer, dataset, progress=lambda *_: 0)
    got, _, tsecs = drive("basic rdn tools.test on the work_dir",
                          lambda: cli_test.main([path, str(work)]), [],
                          list(kernels.LAUNCHES))
    fresh = build_model(cfg.model, test_cfg=cfg.test_cfg, seed=2)
    cli_test.load_weights(fresh, str(work), cfg)
    same = [np.array_equal(fresh.predict(dataset[i]["lq"]),
                           trainer.restorer.predict(dataset[i]["lq"]))
            for i in range(len(dataset))]
    log(f"basic rdn tools.test on the work_dir: {tsecs:.2f} s, PSNR "
        f"{got['PSNR']:.6f} SSIM {got['SSIM']:.6f}; the trained restorer "
        f"in memory PSNR {want['PSNR']:.6f} SSIM {want['SSIM']:.6f}; "
        f"outputs bit-equal to a restorer the CLI's load_weights loaded: "
        f"{same}; iter_{iters}.pth loaded strictly")
    if any(got[k] != want[k] for k in ("PSNR", "SSIM")) or not all(same):
        raise AssertionError(f"basic train: tools.test {got}, in memory "
                             f"{want}, outputs equal {same}")

    b = BASIC_TRAIN["batch"]
    lr_side = BASIC_TRAIN["patch"] // BASIC_NETS["rdn"][1]
    warm = warm_steps(trainer, cfg)
    step = statistics.median(warm)
    rate, _, workers = loader_rate(cfg)
    flops = 3 * basic_flops(trainer.restorer.generator, lr_side,
                            lr_side) * b
    log(f"e2e ({kind}; {smi}): basic rdn train (BasicRestorer RDNNet x4, "
        f"f32, TF32 off, --deterministic), batch {b} x {lr_side}^2 LR: the "
        f"CLI loop {ms:.1f} ms/iteration (median of {n}, loader wait "
        f"included), loader wait {share:.3f} of it; warm step {step:.1f} "
        f"ms (median of {[round(t, 1) for t in warm]}), "
        f"{b / step * 1e3:.2f} samples/s; {flops / 1e12:.3f} TFLOP a step "
        f"(3x the forward): {tflops(flops, step):.2f} TFLOP/s, f32 bound "
        f"{flops / PEAK_F32_FLOPS * 1e3:.2f} ms "
        f"({step / (flops / PEAK_F32_FLOPS * 1e3):.1f}x); peak {peak:.2f} "
        f"GiB; the loader alone ({workers} threads) {rate:.2f} batches/s "
        f"({rate * b:.1f} samples/s); the run {secs:.2f} s")
    train_ds, rng = build_dataset(cfg.data["train"]), np.random.default_rng(0)
    smps = [train_ds.load(i, rng) for i in range(b)]
    batch = to_device({k: np.stack([smp[k] for smp in smps])
                       for k in ("lq", "gt")}, trainer.restorer.device)
    basic_profile(f"one train step at batch {b}",
                  lambda: trainer.train_step(trainer.state, batch))


def basic_phase(drive, kind: str, smi: str) -> None:
    """Phase "basic": the fixed-scale BasicRestorer, in a temporary
    working directory holding seeded Set5- and DIV2K-shaped folders
    (``write_basic_data``) and one config for each of BASIC_NETS
    (``write_basic_config``: RDN's published ×4 net; EDSR's at ×3 with a
    window of 8), f32 params, TF32 off:

    1. each config through ``tools.test`` with random weights, then the
       same restorer warm, and on the CPU for one picture (``basic_eval``);
    2. ``tools.inference`` on the rdn config (``basic_infer``);
    3. ``tools.train`` on the rdn config, then ``tools.test`` on its
       work_dir (``basic_train``);
    4. NIQE and the matting metrics in a Python where cv2 is unimportable
       (``basic_metrics``).

    Each CLI run is driven with every launch count at 0 and none may
    move: no kernel of the port is on this path."""
    from ciaosr_torch.core.color import tensor2img

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        write_basic_data(root)
        paths = {name: write_basic_config(root, name) for name in BASIC_NETS}
        log(f"basic: pictures and configs written in "
            f"{time.perf_counter() - t0:.2f} s")
        os.chdir(root)
        try:
            outs = {}
            for name, path in paths.items():
                t0 = time.perf_counter()
                outs[name] = basic_eval(drive, kind, smi, name, path)
                log(f"basic {name} eval: {time.perf_counter() - t0:.2f} s")
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            basic_infer(drive, paths["rdn"])
            log(f"basic inference: {time.perf_counter() - t0:.2f} s")
            t0 = time.perf_counter()
            basic_train(drive, kind, smi, paths["rdn"])
            log(f"basic train: {time.perf_counter() - t0:.2f} s")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            basic_metrics(tensor2img(outs["rdn"][0]), root)
            log(f"basic metrics: {time.perf_counter() - t0:.2f} s")
        finally:
            os.chdir(cwd)


# ---- phase "aux": the JAX package's last public pieces in the port, plain
# PyTorch on the card (no kernel of the port), f32 with TF32 off
AUX_IMG, AUX_SCALES = 256, (0.25, 1 / 3, 2.5)
AUX_MAP, AUX_QUERIES = (2, 192, 192, 64), 4096
AUX_MLP_INPUT = (16, 4096, 64)
AUX_MLPS = (dict(type="PosMLPRefiner", in_dim=64, out_dim=64,
                 hidden_list=[256, 256]),
            dict(type="MLPRefiner", in_dim=64, out_dim=3,
                 hidden_list=[256] * 4, act="sin"))
# the card against the same call on the CPU: the resize max|d| (pixels in
# [0, 1]), the MLPs max|d|/max|ref|; the resize against imresize_np
# max|d| (as tests/test_torch_aux.py holds it against the JAX package)
AUX_CPU_TOL, AUX_NP_TOL = 1e-5, 1e-4


def aux_checks(kind: str, smi: str) -> None:
    """The body of phase "aux" (``aux_phase`` drives it)."""
    import torch.nn.functional as F

    from ciaosr_torch.config.registry import (BACKBONES, COMPONENTS,
                                              build_from_cfg)
    from ciaosr_torch.convert.load import generator_shapes
    from ciaosr_torch.core.device import resolve_device
    from ciaosr_torch.core.resize import imresize_np, imresize_torch
    from ciaosr_torch.models.builder import init_weights_, make_generator
    from ciaosr_torch.ops.sampling import grid_sample_nearest

    dev = resolve_device("cuda")        # TF32 off
    rng = np.random.default_rng(29)

    def report(name, err, limit, what, ms, extra=""):
        log(f"aux {name} ({kind}; {smi}): {what} {err:.3e} (limit "
            f"{limit:g}), warm {ms:.4f} ms{extra}")
        if not err <= limit:
            raise AssertionError(f"aux {name}: {what} {err} > {limit}")

    # imresize_torch: the MATLAB bicubic on the card
    img = rng.random((AUX_IMG, AUX_IMG, 3), dtype=np.float32)
    card = torch.as_tensor(img, device=dev)
    for s in AUX_SCALES:
        size = (math.ceil(AUX_IMG * s),) * 2
        got = imresize_torch(card, size, s).cpu()
        cpu = imresize_torch(torch.from_numpy(img), size, s)
        ref = imresize_np(img, scale=s)
        if got.shape != (*size, 3) or not torch.isfinite(got).all():
            raise AssertionError(f"aux imresize_torch x{s:.4g}: "
                                 f"{tuple(got.shape)}")
        name = f"imresize_torch {AUX_IMG}x{AUX_IMG}x3 x{s:.4g} -> {size}"
        ms = time_ms(lambda: imresize_torch(card, size, s))
        report(name, float((got - cpu).abs().max()), AUX_CPU_TOL,
               "max|d| vs the CPU", ms)
        report(name, float(np.abs(got.numpy() - ref).max()), AUX_NP_TOL,
               "max|d| vs imresize_np", ms)

    # grid_sample_nearest: coords k / 4096 - 1 are exact at every step of
    # the unnormalize in f32 (so F.grid_sample rounds none of them
    # otherwise); k a multiple of 128 puts the source on an exact
    # half-pixel of the 192 map; they reach past -1 and 1
    b, h, w, c = AUX_MAP
    k = rng.integers(-450, 8642, (b, AUX_QUERIES, 2))
    k[:, ::4] = 128 * rng.integers(-3, 68, (b, AUX_QUERIES // 4, 2))
    coord = torch.as_tensor(k / 4096 - 1, dtype=torch.float32)
    feat = torch.as_tensor(rng.standard_normal(AUX_MAP, dtype=np.float32))
    cfeat, ccoord = feat.to(dev), coord.to(dev)
    grid = ccoord.flip(-1)[:, None]                 # (x, y), (B, 1, Q, 2)
    nchw = cfeat.permute(0, 3, 1, 2)

    def library():
        return F.grid_sample(nchw, grid, mode="nearest",
                             align_corners=False)[:, :, 0].permute(0, 2, 1)

    got = grid_sample_nearest(cfeat, ccoord)
    off = int((coord.abs() > 1).any(-1).sum())
    ties = int((k % 128 == 0).all(-1).sum())
    if not (torch.equal(got.cpu(), grid_sample_nearest(feat, coord))
            and torch.equal(got, library()) and off and ties):
        raise AssertionError("aux grid_sample_nearest: not the same bits as "
                             "the CPU and F.grid_sample")
    ms = time_ms(lambda: grid_sample_nearest(cfeat, ccoord))
    report(f"grid_sample_nearest {AUX_MAP} at {AUX_QUERIES} queries "
           f"({ties} on exact half-pixels in both axes, {off} off the map)",
           0.0, 0.0, "max|d| vs the CPU and F.grid_sample (the same bits)",
           ms, f", library F.grid_sample {time_ms(library):.4f} ms")

    # the refiners from COMPONENTS: the card against the same weights on
    # the CPU
    x = torch.as_tensor(rng.standard_normal(AUX_MLP_INPUT,
                                            dtype=np.float32))
    cx = x.to(dev)
    for i, cfg in enumerate(AUX_MLPS):
        net = build_from_cfg(cfg, COMPONENTS)
        init_weights_(net, seed=i)
        on_card = copy.deepcopy(net).to(dev)
        with torch.inference_mode():
            ref = net(x)
            got = on_card(cx).cpu()
            ms = time_ms(lambda: on_card(cx))
        if got.shape != (*AUX_MLP_INPUT[:2], cfg["out_dim"]) or \
                not torch.isfinite(got).all():
            raise AssertionError(f"aux {cfg['type']}: {tuple(got.shape)}")
        report(f"{cfg} on {AUX_MLP_INPUT}", float(
            (got - ref).abs().max() / ref.abs().max()), AUX_CPU_TOL,
            "max|d|/max|ref| vs the CPU", ms)

    # every generator config: the encoder from BACKBONES, the parameter
    # shapes those of its class called directly
    for path in sorted((Path(__file__).resolve().parent / "configs").glob(
            "*.py")):
        gen = dict(Config.fromfile(str(path)).model["generator"])
        enc_cfg = dict(gen["encoder"])
        cls = BACKBONES.get(enc_cfg.pop("type"))
        if "window_size" in gen:
            enc_cfg.setdefault("window_size", gen["window_size"])
        with torch.device("meta"):
            net = make_generator(gen)
            want = {k: tuple(v.shape)
                    for k, v in cls(**enc_cfg).state_dict().items()}
        shapes = generator_shapes(gen)
        if type(net.encoder) is not cls or \
                {k: shapes.get(k) for k in want} != want:
            raise AssertionError(f"aux {path.name}: the encoder from "
                                 "BACKBONES is not its class's")
        n = sum(math.prod(v) for v in shapes.values())
        log(f"aux {path.name}: {gen['type']}, encoder {cls.__name__} from "
            f"BACKBONES, {len(shapes)} tensors, {n} parameters")


def aux_phase(drive, kind: str, smi: str) -> None:
    """Phase "aux": the JAX package's last public pieces in the port, on
    the card in f32 with TF32 off, at the sizes a user calls them:
    ``imresize_torch`` of a seeded 256² RGB picture at ×1/4, ×1/3 and
    ×2.5 against the same call on the CPU and ``imresize_np``;
    ``grid_sample_nearest`` on a (2, 192, 192, 64) map at 4096 queries
    (exact half-pixel ties, coords off the map) against the CPU and
    ``F.grid_sample``, the same bits; a ``PosMLPRefiner`` (64 → [256,
    256] → 64) and a registry-built ``MLPRefiner`` (act sin, 64 → [256] ×
    4 → 3) on (16, 4096, 64) against the same weights on the CPU; every
    generator config of configs/ built on the meta device with its
    encoder from ``BACKBONES``. Each with its error and warm ms. Driven
    with every launch count at 0: none may move."""
    from ciaosr_torch.ops import kernels

    drive("aux", lambda: aux_checks(kind, smi), [], list(kernels.LAUNCHES))


# ---- several GPUs (phase "dist"): one process per GPU on torch.distributed
# (ciaosr_torch/parallel/mesh.py). The smoke run's machine has one card: (a)
# runs one rank over NCCL, (b) two ranks that share cuda:0 over gloo (NCCL
# refuses two ranks on one device), each as its own command, this script's
# --dist-worker mode under python3 -m torch.distributed.run; (c) batches
# tiles in this process
DIST_ITERS, DIST_GAN_ITERS = 4, 2
DIST_TILE_BATCHES = (1, 2, 4)
DIST_SCALES = (4, Fraction(5, 2))
DIST_SHARED = ["--device", "cuda:0", "--dist-backend", "gloo"]
# the ranks meet on the loopback device: no other network is needed
DIST_ENV = dict(GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo")
# (b) 2 ranks at batch 8 against one process at 16: the first step's loss
# sees the same weights; cuDNN may pick other algorithms at batch 8, so the
# sums round otherwise, by f32 rounding (TF32 off), which Adam carries on.
# Its step moves an element by at most about lr, so the weights stay within
# iterations × lr
DIST_LOSS_REL = 1e-4
# the eval metrics of (b)'s gathered eval against one process (phase cli's)
DIST_METRIC_TOL = 1e-6
DIST_TIMEOUT = 600      # one command, s
DIST_TILE_CALLS = 5     # host-clock calls a tile batch is timed over
DIST_GAN_OVERRIDES = SHIPPED_OVERRIDES + """
# chip_smoke phase dist: no stage-1 checkpoint to start from
load_from = None
"""
TRAIN_KERNELS = ("swin_block",) + BWD_KERNELS


def dist_worker(argv: list) -> int:
    """``chip_smoke.py --dist-worker TASK OUT ARGS...``: one process of
    phase "dist" (a rank under torch.distributed.run, or one process
    without a launcher). ``train``: ``ciaosr_torch.tools.train``'s main on
    ARGS; ``test``: ``ciaosr_torch.tools.test``'s; ``tiles``: the
    flagship's ``predict_tiled`` of the IMG² picture at DIST_SCALES,
    tile_batch 4, under the launcher's mesh (ARGS: its device and
    backend, e.g. cuda:0 gloo; none: cuda:LOCAL_RANK over NCCL), then the
    warm ms of each request (median of DIST_TILE_CALLS; the launches are
    the requests' before it). Saves its result, its launches, peak memory
    and seconds to OUT/TASK_rank<RANK>.pt."""
    from ciaosr_torch.ops import kernels

    task, out, rest = argv[0], Path(argv[1]), argv[2:]
    rank = int(os.environ.get("RANK", "0"))
    t0 = time.perf_counter()
    if task == "train":
        from ciaosr_torch.tools import train as cli_train
        trainer = cli_train.main(rest)
        res = {"step": trainer.state.step, "weights": {
            name: {k: v.detach().cpu() for k, v in mod.state_dict().items()}
            for name, mod in trainer._modules().items()}}
    elif task == "test":
        from ciaosr_torch.tools import test as cli_test
        res = {"summary": cli_test.main(rest)}
    elif task == "tiles":
        from ciaosr_torch.models.restorers import CiaoSRRestorer
        from ciaosr_torch.parallel.mesh import close_mesh, init_mesh
        mesh = init_mesh("pytorch", *rest)
        try:
            r = CiaoSRRestorer(FLAGSHIP, rgb_mean=RGB_MEAN,
                               test_cfg=dict(TEST_CFG, tile_batch=4),
                               device=mesh.device, seed=0)
            lq = np.random.default_rng(0).random((IMG, IMG, 3),
                                                 dtype=np.float32)
            res = {"checksum": weight_checksum(r.generator), "outs": [
                r.predict_tiled(lq, s, TILE, OVERLAP, mesh=mesh)
                for s in DIST_SCALES]}
            # the requests' launches, before the timed calls add theirs
            res["launches"] = dict(kernels.LAUNCHES)
            res["ms"] = [request_ms(lambda: r.predict_tiled(
                lq, s, TILE, OVERLAP, mesh=mesh)) for s in DIST_SCALES]
        finally:
            close_mesh(mesh)
    else:
        print(f"chip_smoke: unknown dist task {task!r}", file=sys.stderr)
        return 2
    res.setdefault("launches", dict(kernels.LAUNCHES))
    res.update(secs=time.perf_counter() - t0,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               device=torch.cuda.current_device())
    torch.save(res, out / f"{task}_rank{rank}.pt")
    return 0


def request_ms(fn) -> float:
    """The median host ms of DIST_TILE_CALLS warm calls of ``fn``, each
    ended by a synchronize."""
    fn()
    ts = []
    for _ in range(DIST_TILE_CALLS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ts)


def weight_checksum(module) -> float:
    """The sum of a module's parameters in float64: the same seeded weights
    in two processes give the same sum."""
    return float(sum(p.detach().double().sum() for p in module.parameters()))


def dist_run(label: str, ranks: int, task: str, out: Path, argv: list,
             env: dict | None = None) -> tuple[list[dict], float]:
    """The dist worker's ``task`` on ARGS ``argv``: under ``python3 -m
    torch.distributed.run --standalone`` with ``ranks`` processes, or
    with ranks = 0 as one process without a launcher. Returns each rank's
    result and the command's wall seconds; raises (with the end of its
    output) if it fails or outlives DIST_TIMEOUT, when its whole process
    group is killed."""
    import signal

    out.mkdir(parents=True, exist_ok=True)
    cmd = [str(Path(__file__).resolve()), "--dist-worker", task, str(out),
           *argv]
    if ranks:
        cmd = ["-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(ranks)] + cmd
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable] + cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True,
                            env={**os.environ, **DIST_ENV, **(env or {})})
    try:
        text, _ = proc.communicate(timeout=DIST_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        raise AssertionError(f"dist {label}: no end in {DIST_TIMEOUT} s:\n"
                             + text[-4000:])
    secs = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"dist {label}: exit {proc.returncode}:\n"
                             + text[-4000:])
    res = [torch.load(out / f"{task}_rank{r}.pt", weights_only=False)
           for r in range(max(ranks, 1))]
    log(f"dist {label}: {secs:.1f} s (each rank's own part "
        f"{[round(r['secs'], 1) for r in res]} s, peak device memory "
        f"{[round(r['peak_gib'], 2) for r in res]} GiB, devices "
        f"{[r['device'] for r in res]})")
    return res, secs


def dist_launches(label: str, res: list, want: dict) -> None:
    """The launches of a dist command's ranks, summed, are exactly
    ``want``'s; every other kernel is idle."""
    got: dict = {}
    for r in res:
        for k, n in r["launches"].items():
            got[k] = got.get(k, 0) + n
    extra = {k: n for k, n in got.items() if n and k not in want}
    short = {k: (got.get(k, 0), n) for k, n in want.items()
             if got.get(k, 0) != n}
    if extra or short:
        raise AssertionError(f"dist {label}: launches off the path {extra}, "
                             f"(got, want) {short}")


def logged_records(work: Path) -> list:
    with open(work / "train_log.jsonl") as f:
        return [json.loads(line) for line in f]


def iteration_ms(recs: list) -> list:
    """The ms of the logged iterations whose window holds no hook (the
    log interval is 1; evals and saves at 2 and 4 fall into the next
    window): iterations 2 and 4."""
    return [round(1e3 / r["iters_per_s"], 1) for r in recs
            if r.get("step") in (2, 4) and "iters_per_s" in r]


def same_weights(label: str, a: dict, b: dict) -> None:
    """Two ranks' (or runs') modules, bit for bit."""
    for name, sd in a.items():
        bad = [k for k, v in sd.items() if not torch.equal(v, b[name][k])]
        if bad or set(sd) != set(b[name]):
            raise AssertionError(f"dist {label}: {name} differs at "
                                 f"{bad[:5]}")


def dist_train_checks(kind: str, smi: str, root: Path, derived: Path,
                      cfg, evals) -> None:
    """(a) and (b) of 001 rdn through tools.train: DIST_ITERS iterations
    under --deterministic (evals at 2 and 4, checkpoints at 2 and 4) in
    one process without a launcher, in one rank over NCCL (the losses,
    evals and weights bit for bit the plain run's) and in two ranks on
    cuda:0 over gloo at 8 samples each (the two ranks' weights bit for
    bit; the losses within DIST_LOSS_REL of the plain run, the weights
    within DIST_ITERS × lr). ``evals(n)``: the launches of n evals."""
    argv = [str(derived), "--deterministic", "--total-iters",
            str(DIST_ITERS), "--work-dir"]
    runs = {}
    for name, ranks, extra in (
            ("plain", 0, []), ("nccl", 1, ["--launcher", "pytorch"]),
            ("gloo", 2, ["--launcher", "pytorch"] + DIST_SHARED)):
        work = root / f"work_{name}"
        res, secs = dist_run(f"rdn train {name} ({ranks} ranks)", ranks,
                             "train", root / f"out_{name}",
                             argv + [str(work)] + extra)
        dist_launches(f"rdn train {name}", res, evals(2))
        recs = logged_records(work)
        runs[name] = (res, recs)
        log(f"e2e ({kind}; {smi}): dist rdn train {name} ({max(ranks, 1)} "
            f"process(es), global batch 16 x 48^2): iterations 2 and 4 "
            f"{iteration_ms(recs)} ms (loader wait included), command "
            f"{secs:.1f} s, losses "
            f"{[r['loss_pix'] for r in recs if 'loss_pix' in r]}")
    (plain,), p_recs = runs["plain"]
    (nccl,), n_recs = runs["nccl"]
    clock = ("time", "iters_per_s", "val_elapsed_s")
    strip = [{k: v for k, v in r.items() if k not in clock} for r in p_recs]
    if strip != [{k: v for k, v in r.items() if k not in clock}
                 for r in n_recs]:
        raise AssertionError("dist (a): the NCCL run logged other losses or "
                             "evals than the plain run")
    same_weights("(a) NCCL world 1 against the plain run", nccl["weights"],
                 plain["weights"])
    log("dist (a): the NCCL world-1 run logged the plain run's losses and "
        "evals and ended with its weights, bit for bit")
    g_res, g_recs = runs["gloo"]
    same_weights("(b) gloo rank 1 against rank 0", g_res[1]["weights"],
                 g_res[0]["weights"])
    losses = [[r["loss_pix"] for r in recs if "loss_pix" in r]
              for recs in (p_recs, g_recs)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(*losses, strict=True))
    dw = max(float((v - plain["weights"]["generator"][k]).abs().max())
             for k, v in g_res[0]["weights"]["generator"].items())
    w_tol = DIST_ITERS * cfg.optimizers["lr"]
    log(f"dist (b): 2 ranks on cuda:0 over gloo (8 samples each) against "
        f"one process at 16: losses max rel {rel:.3e} (<= {DIST_LOSS_REL}), "
        f"weights max|d| {dw:.3e} (<= {w_tol}); the ranks' weights bit for "
        "bit")
    if not (rel <= DIST_LOSS_REL and dw <= w_tol):
        raise AssertionError("dist (b): the 2-rank run left its bounds")


def dist_eval_checks(root: Path, derived: Path, gen_cfg: dict,
                     expected) -> None:
    """tools.test on the Set5-shaped test split with a seeded .pth: one
    process without a launcher; (a) one rank over NCCL with --shard-tiles
    (the summary equal); (b) two ranks on cuda:0 over gloo, the 5
    pictures strided (ragged) and gathered (both ranks' summaries equal,
    and within DIST_METRIC_TOL of the plain run's). ``expected()``: the
    launches of one eval of the split."""
    ckpt = root / "rdn_dist.pth"
    write_checkpoint(ckpt, gen_cfg, seed=3)
    argv = [str(derived), str(ckpt)]
    summaries = {}
    for name, ranks, extra in (
            ("plain", 0, []),
            ("nccl", 1, ["--launcher", "pytorch", "--shard-tiles"]),
            ("gloo", 2, ["--launcher", "pytorch"] + DIST_SHARED)):
        res, _ = dist_run(f"rdn test {name} ({ranks} ranks)", ranks, "test",
                          root / f"out_test_{name}", argv + extra)
        dist_launches(f"rdn test {name}", res, expected())
        got = [{k: v for k, v in r["summary"].items() if k != "elapsed_s"}
               for r in res]
        if any(g != got[0] for g in got):
            raise AssertionError(f"dist test {name}: the ranks' summaries "
                                 f"differ: {got}")
        summaries[name] = got[0]
    log(f"dist eval summaries: {summaries}")
    if summaries["nccl"] != summaries["plain"]:
        raise AssertionError("dist (a): tools.test --shard-tiles over NCCL "
                             "gave another summary")
    g, p = summaries["gloo"], summaries["plain"]
    if g["n_images"] != p["n_images"] or any(
            abs(g[k] - p[k]) > DIST_METRIC_TOL for k in ("PSNR", "SSIM")):
        raise AssertionError("dist (b): the gathered eval left its bound")


def dist_gan_check(root: Path) -> dict:
    """(b): the shipped 002 gan config (its degradation chain and 6
    forked loader workers a rank; no stage-1 checkpoint) through
    tools.train for DIST_GAN_ITERS iterations on two ranks that share
    cuda:0 over gloo, global batch 6, VGG19 synthetic: finite losses, the
    generator, its EMA copy and the discriminator (its spectral norms' u
    and sigma) bit for bit the same on both ranks. Returns the train
    kernels' launches."""
    from ciaosr_torch.data.imageio import write_png

    rng = np.random.default_rng(24)
    hr = root / "data" / "DF2K" / "HR"
    hr.mkdir(parents=True)
    for i in range(SHIPPED_N):
        write_png(str(hr / f"{i + 1:04d}.png"),
                  smooth_picture(rng, *SHIPPED_HR))
    (root / "data" / "val").mkdir()
    write_png(str(root / "data" / "val" / "0001.png"),
              smooth_picture(rng, 48, 48))
    path = root / "002_gan_dist.py"
    path.write_text(Path(config_path("002_real_gan_")).read_text()
                    + DIST_GAN_OVERRIDES.format(iters=DIST_GAN_ITERS))
    cfg = Config.fromfile(str(path))
    n_blocks = sum(cfg.model["generator"]["encoder"]["depths"])
    work = root / "work_gan"
    res, _ = dist_run("002 gan train (2 ranks)", 2, "train",
                      root / "out_gan",
                      [str(path), "--total-iters", str(DIST_GAN_ITERS),
                       "--work-dir", str(work), "--launcher", "pytorch"]
                      + DIST_SHARED, env={"CIAOSR_VGG19_SYNTHETIC": "1"})
    want = {k: 2 * n_blocks * DIST_GAN_ITERS for k in TRAIN_KERNELS}
    want["conv3x3_f32"] = 2 * trunk_convs(cfg.model["generator"]) \
        * DIST_GAN_ITERS
    dist_launches("002 gan train", res, want)
    same_weights("(b) 002 gan rank 1 against rank 0", res[1]["weights"],
                 res[0]["weights"])
    recs = logged_records(work)
    losses = [{k: v for k, v in r.items() if k.startswith("loss")}
              for r in recs]
    if len(recs) != DIST_GAN_ITERS or not all(
            np.isfinite(list(m.values())).all() and m for m in losses):
        raise AssertionError(f"dist (b) 002 gan: records {recs}")
    log(f"dist (b) 002 gan: 2 ranks on cuda:0, global batch 6: iteration 2 "
        f"{iteration_ms(recs)} ms (loader wait included), losses "
        f"{losses}; generator, EMA copy and discriminator ("
        f"{sum(k.endswith('.u') for k in res[0]['weights']['discriminator'])}"
        " spectral-norm u) the same on both ranks, bit for bit")
    return want


def dist_tiles_check(restorer, lq: np.ndarray, root: Path, ones: list,
                     rows: dict) -> None:
    """(b): the flagship's predict_tiled of the IMG² picture at ×4 and ×2.5
    with tile_batch 4 on two ranks (2 tiles each a group) that share
    cuda:0 over gloo: the ranks' pictures bit for bit, each within
    REL_TOL (max|Δ|/max|ref|) of this process's tile_batch 1 picture
    ``ones``; the ranks' weights this process's (a float64 checksum)."""
    res, _ = dist_run("flagship predict_tiled tile_batch 4 (2 ranks)", 2,
                      "tiles", root / "out_tiles", ["cuda:0", "gloo"])
    if {r["checksum"] for r in res} != {weight_checksum(restorer.generator)}:
        raise AssertionError("dist tiles: the ranks' seeded weights are not "
                             "this process's")
    # a group of 4 tiles: one group a scale, each rank 2 tiles of it
    want = {"f3p_build": 4, "wt_hoist": 4, "csa_stencil_fused": 4,
            "grid_decode": 2, "grid_decode_rational": 2}
    dist_launches("tiles", res, want)
    for k, n in want.items():
        rows[k] = rows.get(k, 0) + n
    for s, a, b, one in zip(DIST_SCALES, res[0]["outs"], res[1]["outs"],
                            ones, strict=True):
        if not np.array_equal(a, b):
            raise AssertionError(f"dist tiles x{s}: the ranks differ")
        e_abs, e_rel = errors(torch.as_tensor(a), torch.as_tensor(one))
        log(f"dist (b) predict_tiled x{s} {IMG}^2, 2 ranks x 2 tiles "
            f"against one process at tile_batch 1: max|d|={e_abs:.3e} "
            f"max|d|/max|ref|={e_rel:.3e}; warm ms a request on rank 0 "
            f"{res[0]['ms'][DIST_SCALES.index(s)]:.1f}")
        if not e_rel <= REL_TOL:
            raise AssertionError(f"dist tiles x{s}: {e_rel:.3e}")


def batched_kernel_checks(restorer, lq: np.ndarray, b: int) -> None:
    """K1, K2 (wt and ck each), K3 at ×4, row 10 at ×2.5 and K4 on the
    first ``b`` flagship tiles of the IMG² picture in one call (bf16)
    against their plain versions (f32, same values): max|Δ|/max|ref| ≤
    REL_TOL each."""
    from ciaosr_torch.models.ciaosr import rational_cell
    from ciaosr_torch.models.restorers import tile_layout
    from ciaosr_torch.ops.kernels import csa_stencil as k4
    from ciaosr_torch.ops.kernels import decoder as dk

    _, hs, ws = tile_layout(IMG, IMG, 4, TILE, OVERLAP)
    tiles = torch.as_tensor(np.stack(
        [lq[hi:hi + TILE, wi:wi + TILE] for hi in hs for wi in ws][:b]),
        device="cuda")
    net = restorer.generator
    with torch.inference_mode():
        feature = net.gen_feature(restorer.normalize(tiles)).contiguous()
        _, h, w, _ = feature.shape
        match, keys, embed = net.cs_attn.stencil_inputs(feature, 2,
                                                        torch.bfloat16)
        maps = net._kernel_maps(feature, (0.5, 0.5))
        _, csa, _, _, _, _, pk = maps
        rat = net._kernel_maps(feature, rational_cell(h, w, h * 5 // 2,
                                                      w * 5 // 2))
        tabs = dk.decoder_tables(4, h, w, net.local_size, feature.device)
        tabs_r = dk.rational_tables(h, w, 5, 2, 5, 2, net.local_size,
                                    feature.device)
        ss, cs = net.softmax_scale, net.cs_attn.softmax_scale
        checks = {
            "f3p_build": (
                lambda: dk.f3p_build(feature, csa, pk["wk0"], pk["wvu"],
                                     pk["wvc"]),
                lambda: dk.f3p_build_plain(*f32((feature, csa, pk["wk0"],
                                                 pk["wvu"], pk["wvc"])))),
            "wt_hoist": (
                lambda: dk.wt_hoist(feature, pk["wkout"], pk["bkout"]),
                lambda: dk.wt_hoist_plain(feature.float(),
                                          *f32((pk["wkout"], pk["bkout"])))),
            "grid_decode": (
                lambda: dk.grid_decode(*maps[:6], maps[6], tabs, ss),
                lambda: dk.grid_decode_plain(*f32(maps[:6]), f32(maps[6]),
                                             tabs, ss)),
            "grid_decode_rational": (
                lambda: dk.grid_decode_rational(*rat[:6], rat[6], tabs_r,
                                                ss),
                lambda: dk.grid_decode_rational_plain(
                    *f32(rat[:6]), f32(rat[6]), tabs_r, ss)),
            "csa_stencil_fused": (
                lambda: k4.csa_stencil_fused(match, keys, embed, cs, 2),
                lambda: k4.csa_stencil_fused_plain(
                    match.float(), keys.float(), embed.float(), cs, 2))}
        errs = {}
        for name, (kern, plain) in checks.items():
            got, ref = kern(), plain()
            pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
            errs[name] = max(errors(g, r)[1] for g, r in pairs)
            del got, ref, pairs
    log(f"dist (c) kernels at B={b} against their plain versions, "
        f"max|d|/max|ref| (each output of K2 on its own): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items() if not v <= REL_TOL}
    if bad:
        raise AssertionError(f"dist (c) kernels at B={b}: {bad}")


def tile_batch_times(restorer, lq: np.ndarray, scale) -> tuple:
    """(host ms, device ms) a tile of ``predict_tiled`` on the IMG²
    picture: the host clock around each of DIST_TILE_CALLS calls that end
    in a synchronize (median), and torch.profiler's CUDA kernel time of
    one more call; each over the picture's tiles."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ciaosr_torch.models.restorers import tile_layout

    _, hs, ws = tile_layout(IMG, IMG, scale, TILE, OVERLAP)
    n = len(hs) * len(ws)

    def call():
        restorer.predict_tiled(lq, scale, TILE, OVERLAP)
        torch.cuda.synchronize()

    call()
    ts = []
    for _ in range(DIST_TILE_CALLS):
        t = time.perf_counter()
        call()
        ts.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
    dev = sum(e.device_time_total for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA) / 1e3
    return statistics.median(ts) / n, dev / n, n


def dist_tile_batches(drive, kind: str, smi: str, restorer,
                      lq: np.ndarray) -> tuple[dict, list]:
    """(c) tile_batch 1, 2 and 4 in this process: the flagship's
    predict_tiled of the IMG² picture at ×4 and ×2.5, driven with the
    exact launches its tile groups give; each picture against tile_batch
    1's (max|Δ|/max|ref| ≤ REL_TOL); the kernels at B = 2 and 4 against
    their plain versions; the ms a tile, host and device, and the peak
    memory. Returns the launches by kernel row and tile_batch 1's
    pictures."""
    from ciaosr_torch.models.restorers import tile_layout
    from ciaosr_torch.ops import kernels

    cfg = restorer.test_cfg
    n_tiles = [len(hs) * len(ws) for _, hs, ws in
               (tile_layout(IMG, IMG, s, TILE, OVERLAP) for s in DIST_SCALES)]
    rows: dict = {}
    ones = None
    try:
        for b in DIST_TILE_BATCHES:
            restorer.test_cfg = dict(cfg, tile_batch=b)
            groups = [-(-n // b) for n in n_tiles]
            want = {"f3p_build": sum(groups), "wt_hoist": sum(groups),
                    "csa_stencil_fused": sum(groups),
                    "grid_decode": groups[0],
                    "grid_decode_rational": groups[1]}
            outs, launches, _ = drive(
                f"dist (c) tile_batch {b} (want {want})",
                lambda: [restorer.predict_tiled(lq, s, TILE, OVERLAP)
                         for s in DIST_SCALES],
                list(want), [k for k in kernels.LAUNCHES if k not in want])
            got = {k: launches[k] for k in want}
            if got != want:
                raise AssertionError(f"dist (c) tile_batch {b}: launches "
                                     f"{got}, want {want}")
            for k, n in want.items():
                rows[k] = rows.get(k, 0) + n
            ones = ones or outs
            for s, o, one in zip(DIST_SCALES, outs, ones):
                e_abs, e_rel = errors(torch.as_tensor(o),
                                      torch.as_tensor(one))
                log(f"dist (c) tile_batch {b} x{s}: against tile_batch 1 "
                    f"max|d|={e_abs:.3e} max|d|/max|ref|={e_rel:.3e}")
                if not e_rel <= REL_TOL:
                    raise AssertionError(f"dist (c) tile_batch {b} x{s}: "
                                         f"{e_rel:.3e}")
            if b > 1:
                batched_kernel_checks(restorer, lq, b)
            for s in DIST_SCALES:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                host, dev, n = tile_batch_times(restorer, lq, s)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                log(f"e2e ({kind}; {smi}): dist (c) flagship predict_tiled "
                    f"x{s} {IMG}^2 ({n} tiles of {TILE}), tile_batch {b}: "
                    f"host {host:.2f} ms/tile (median of {DIST_TILE_CALLS} "
                    f"calls), device {dev:.2f} ms/tile (profiled kernels of "
                    f"one call), busy {dev / host:.3f}; peak {peak:.2f} GiB")
    finally:
        restorer.test_cfg = cfg
    return rows, ones


def dist_phase(drive, kind: str, smi: str, restorer, lq: np.ndarray) -> dict:
    """Phase "dist", several GPUs as the machine's one card allows:

    (c) tile_batch 1, 2 and 4 in this process (``dist_tile_batches``);
    in a temporary working directory with seeded DIV2K-, Set5- and
    DF2K-shaped folders, each distributed part its own command
    (``dist_run``; the ranks on the loopback device):
    (a) one rank over NCCL: tools.train on 001 rdn (``dist_train_checks``)
        and tools.test --shard-tiles (``dist_eval_checks``), each against
        the same command without a launcher, bit for bit;
    (b) two ranks sharing cuda:0 over gloo: the same training at 8 samples
        a rank, the gathered eval of the 5 pictures, the flagship's
        sharded tiles (``dist_tiles_check``) and the 002 gan config
        (``dist_gan_check``).

    Returns the launches of the phase by kernel row (the train kernels by
    key)."""
    from ciaosr_torch.data.imageio import imread

    rows, ones = dist_tile_batches(drive, kind, smi, restorer, lq)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_div2k(root)
        write_set5(root)
        os.chdir(root)
        try:
            derived = root / "001_rdn_dist.py"
            derived.write_text(Path(config_path(
                "001_localimplicitsr_rdn_")).read_text()
                + TRAIN_CLI_OVERRIDES)
            cfg = Config.fromfile(str(derived))
            tile = cfg.test_cfg["tile"]
            val_lrs = [(h // 4, w // 4) for _, (h, w) in CLI_SET5]

            def evals(n):   # n evals' launches by kernel, added into rows
                want: dict = {}
                for _ in range(n):
                    for k, v in cli_expected(val_lrs, 4, tile, 64, 0,
                                             rows).items():
                        want[k] = want.get(k, 0) + v
                return want

            dist_train_checks(kind, smi, root, derived, cfg, evals)
            test_lrs = [imread(f"data/Classical/Set5/LRbicx4/{n}.png"
                               ).shape[:2] for n, _ in CLI_SET5]
            dist_eval_checks(root, derived, cfg.model["generator"],
                             lambda: cli_expected(test_lrs, 4, tile, 64, 0,
                                                  rows))
            dist_tiles_check(restorer, lq, root, ones, rows)
            rows.update(dist_gan_check(root))
        finally:
            os.chdir(cwd)
    return rows


# the native MATLAB bicubic's cases: (name, HR shape, scale); the 002
# configs' eval LR (a 480 x 512 picture at x1/4) and the train pipelines'
# patch (192² to 48²)
NATIVE_CASES = (("480x512 x1/4", (480, 512, 3), 0.25),
                ("192x192 x1/4", (192, 192, 3), 0.25))
NATIVE_TOL = 1e-6


def host_checks(kind: str, smi: str) -> None:
    """The host code this machine runs without OpenCV, Pillow or
    tensorboard: the native MATLAB bicubic (data/native.py: built with
    g++ from native/bicubic.cpp, taken by ``imresize_np`` by default,
    within NATIVE_TOL of the numpy path of ``CIAOSR_NATIVE=0``; both timed,
    median of 5 after one call) and ``RandomDownSampling(backend=
    "pillow")`` (core/pilresize.py: the LR patch's shape, dtype and
    range). The TensorBoard events are checked in phase train_cli."""
    from ciaosr_torch.core import resize
    from ciaosr_torch.data import native
    from ciaosr_torch.data.pipelines import RandomDownSampling

    t0 = time.perf_counter()
    lib = native.build()
    log(f"host native resize: {lib.name} in {lib.parent.name} built or "
        f"found in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(12)
    env = os.environ.get("CIAOSR_NATIVE")
    calls = []
    resize_native = native.bicubic_resize

    def counted(*a, **k):
        calls.append(1)
        return resize_native(*a, **k)

    def ms(fn):
        fn()
        times = []
        for _ in range(5):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    native.bicubic_resize = counted
    try:
        for name, shape, scale in NATIVE_CASES:
            img = rng.random(shape, dtype=np.float32)
            os.environ.pop("CIAOSR_NATIVE", None)
            n0 = len(calls)
            got = resize.imresize_np(img, scale=scale)
            used = len(calls) - n0
            ms_native = ms(lambda: resize.imresize_np(img, scale=scale))
            os.environ["CIAOSR_NATIVE"] = "0"
            ref = resize.imresize_np(img, scale=scale)
            ms_numpy = ms(lambda: resize.imresize_np(img, scale=scale))
            err = float(np.abs(got - ref).max())
            log(f"host native resize {name} ({kind}; {smi}; "
                f"{os.cpu_count()} CPUs): max|d| vs numpy {err:.3e}, "
                f"native {ms_native:.3f} ms, numpy {ms_numpy:.3f} ms "
                f"({ms_numpy / ms_native:.1f}x)")
            if used != 1 or got.shape != ref.shape or not err <= NATIVE_TOL:
                raise AssertionError(f"native resize {name}: {used} native "
                                     f"calls, error {err:.3e}")
    finally:
        native.bicubic_resize = resize_native
        if env is None:
            os.environ.pop("CIAOSR_NATIVE", None)
        else:
            os.environ["CIAOSR_NATIVE"] = env
    op = RandomDownSampling(scale_min=2.0, scale_max=4.0, patch_size=48,
                            backend="pillow")
    res = op({"gt": rng.random((256, 256, 3), dtype=np.float32),
              "_rng": np.random.default_rng(3)})
    lq, gt = res["lq"], res["gt"]
    log(f"host RandomDownSampling(backend='pillow'): scale "
        f"{res['scale']:.4f}, gt {gt.shape} -> lq {lq.shape} {lq.dtype}, "
        f"range [{lq.min():.4f}, {lq.max():.4f}]")
    if lq.shape != (48, 48, 3) or lq.dtype != np.float32 or \
            gt.shape != (round(48 * res["scale"]),) * 2 + (3,) or \
            not 0 <= lq.min() <= lq.max() <= 1:
        raise AssertionError("RandomDownSampling(backend='pillow'): bad "
                             f"output {lq.shape} {lq.dtype}")


def drive(name, fn, ran, idle):
    """fn() as one path: every launch count set to 0 just before it and
    read just after; each kernel of ``ran`` launched, none of ``idle``.
    Returns fn's result, the counts and the wall seconds."""
    from ciaosr_torch.ops import kernels

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    log(f"path {name}: {secs * 1e3:.1f} ms, launches {launches}")
    missing = [k for k in ran if launches[k] <= 0]
    extra = [k for k in idle if launches[k] != 0]
    if missing or extra:
        raise AssertionError(f"path {name}: kernels not launched "
                             f"{missing}, launched but off the path "
                             f"{extra}")
    return out, launches, secs


def main() -> int:
    """``--full-image``: build, then only time_full_images;
    ``--kernel-times``: build, then only time_kernels; ``--train-cli``:
    build, then only phase train_cli; ``--gan``: build, then only phase
    gan; ``--basic``: only phase basic, which needs no kernel;
    ``--aux``: only phase aux, which needs none either;
    ``--dist``: build, then only phase dist (none prints a result line);
    ``--dist-worker``: one process of phase dist."""
    t_start = time.perf_counter()
    flags = sys.argv[1:]
    if flags[:1] == ["--dist-worker"]:
        return dist_worker(flags[1:])
    if flags not in ([], ["--full-image"], ["--kernel-times"],
                     ["--train-cli"], ["--gan"], ["--basic"], ["--aux"],
                     ["--dist"]):
        print(f"chip_smoke: unknown arguments {flags}", file=sys.stderr)
        return 2
    full_only = flags == ["--full-image"]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from ciaosr_torch.models.restorers import (CiaoSRRestorer,
                                                   tile_layout)
        from ciaosr_torch.ops import kernels
        from ciaosr_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the "
              "repository root", file=sys.stderr)
        return 1

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # the f32 references compute in full f32: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def mark(phase):   # where the script's own time goes
        log(f"elapsed after {phase}: {time.perf_counter() - t_start:.1f} s")

    if flags == ["--basic"]:
        basic_phase(drive, kind, smi)
        mark("the basic phase")
        return 0
    if flags == ["--aux"]:
        aux_phase(drive, kind, smi)
        mark("the aux phase")
        return 0
    log(f"build: {_build.build_all():.2f} s ({_build.build_dir()})")
    if not flags:
        host_checks(kind, smi)

    if flags == ["--train-cli"]:
        launches, train_rows = train_cli_phase(drive, kind, smi)
        log(f"train_cli launches by kernel row: {launches}")
        log(json.dumps({"kernels": train_rows}))
        mark("the train_cli phase")
        return 0
    if flags == ["--gan"]:
        log(f"gan launches by kernel row (the train kernels by key): "
            f"{gan_phase(drive, kind, smi)}")
        mark("the gan phase")
        return 0

    restorer = CiaoSRRestorer(FLAGSHIP, rgb_mean=RGB_MEAN,
                              test_cfg=TEST_CFG, device="cuda", seed=0)
    rng = np.random.default_rng(0)
    lq = rng.random((IMG, IMG, 3), dtype=np.float32)
    tile = torch.as_tensor(lq[:TILE, :TILE], device="cuda")[None]
    def lr(hw):
        return lq[:hw[0], :hw[1]]

    if flags == ["--dist"]:
        log(f"dist launches by kernel row (the train kernels by key): "
            f"{dist_phase(drive, kind, smi, restorer, lq)}")
        mark("the dist phase")
        return 0
    big = np.random.default_rng(1).random((192, 1024, 3), dtype=np.float32)
    if full_only:
        time_full_images(restorer, big)
        return 0
    lq_s = np.random.default_rng(2).random((SWIN_IMG, SWIN_IMG, 3),
                                           dtype=np.float32)
    tree = str(Path(__file__).resolve().parent)
    if flags == ["--kernel-times"]:
        swin = CiaoSRRestorer(SWIN_002, rgb_mean=RGB_MEAN,
                              test_cfg=SWIN_TEST_CFG, device="cuda", seed=0)
        sw1 = CiaoSRRestorer(SWIN_001, rgb_mean=RGB_MEAN,
                             test_cfg=SWIN_001_TEST_CFG, device="cuda",
                             seed=0)
        edsr, u1 = (CiaoSRRestorer(cfg, rgb_mean=RGB_MEAN,
                                   test_cfg=EDSR_TEST_CFG, device="cuda",
                                   seed=0) for cfg in (EDSR_001, EDSR_U1))
        time_kernels(tree, restorer, swin, sw1, lq, lq_s, big, edsr=edsr,
                     u1=u1, swin_u1={k: g[0] for k, g in
                                     swin_u1_restorers(False).items()})
        return 0

    def full(hw):
        return big[:hw[0], :hw[1]]

    rows = check_kernels(restorer, tile,
                         torch.as_tensor(lr(ODD), device="cuda")[None])
    rows += check_csa_kernels(restorer, [("csa_attention", lr(SET5[0]))] + [
        (kern, full(hw)) for _, hw, kern in CSA_FULL])
    compare_csa_forms(restorer, full(CSA_FULL[-1][1]))
    mark("the flagship kernel rows")

    # ---- the main paths: requests through the entry points, each path
    # with the launch counters set to 0 just before it and read just after
    def check_image(name, out, shape):
        out = out.cpu().numpy() if isinstance(out, torch.Tensor) else out
        if out.shape != shape or not np.isfinite(out).all() \
                or out.min() < 0 or out.max() > 1:
            raise AssertionError(f"{name}: bad output {out.shape} "
                                 f"[{out.min()}, {out.max()}], want {shape}")

    def csa_idle(csa):
        """The CSA kernels other than ``csa``."""
        return [k for k in CSA_KERNELS if k != csa]

    decoders = ["f3p_build", "wt_hoist"]
    int_path = decoders + ["csa_stencil_fused", "grid_decode"]
    rat_path = decoders + ["csa_stencil_fused", "grid_decode_rational"]
    k4_idle = csa_idle("csa_stencil_fused")

    main_csa: dict = {}  # the CSA kernel rows' launches, path by path

    def x4_requests():
        first = restorer.predict_tiled(lq, 4, tile=TILE,
                                       tile_overlap=OVERLAP)
        torch.cuda.synchronize()
        t = time.perf_counter()
        singles = [restorer.grid_predict(torch.as_tensor(
            lq[i:i + TILE, j:j + TILE], device="cuda")[None], 4)
            for i, j in ((0, IMG - TILE), (IMG - TILE, 0))]
        torch.cuda.synchronize()
        return first, singles, time.perf_counter() - t

    (out, singles, t_singles), launches_x4, t_x4 = drive(
        "x4", x4_requests, int_path, ["grid_decode_rational"] + k4_idle)
    check_image("predict_tiled x4", out, (4 * IMG, 4 * IMG, 3))
    for o in singles:
        check_image("grid_predict x4", o, (1, 4 * TILE, 4 * TILE, 3))

    def rational_requests():
        return (restorer.predict_tiled(lq, 2.5, tile=TILE,
                                       tile_overlap=OVERLAP),
                restorer.predict_tiled(lq, "7/3", tile=TILE,
                                       tile_overlap=OVERLAP),
                restorer.predict(lr(FULL), hr(FULL, 2.5)[:2]))

    (r25, r73, full25), launches_rat, t_rat = drive(
        "rational", rational_requests, rat_path, ["grid_decode"] + k4_idle)
    n25, n73 = round(IMG * 2.5), round(IMG * 7 / 3)
    check_image("predict_tiled x2.5", r25, (n25, n25, 3))
    check_image("predict_tiled x7/3", r73, (n73, n73, 3))
    check_image("predict x2.5 {}x{}".format(*FULL), full25, hr(FULL, 2.5))

    # 101·83 phases: more than the dense decode takes
    (pq, _, _) = drive("per-query", lambda: restorer.predict(
        lr(SMALL), (101, 83)), ["csa_stencil_fused"],
        ["f3p_build", "wt_hoist", "grid_decode", "grid_decode_rational"]
        + k4_idle)
    check_image("predict {}x{} -> 101x83 (per query)".format(*SMALL), pq,
                (101, 83, 3))

    (odd, launches_odd, _) = drive(
        "odd-width x4", lambda: restorer.predict(lr(ODD), hr(ODD)[:2]),
        int_path, ["grid_decode_rational"] + k4_idle)
    check_image("predict {}x{} x4".format(*ODD), odd, hr(ODD))

    # the CSA geometries: each request's CSA takes the kernel the JAX
    # package picks at its geometry, and no other CSA kernel
    def set5_requests():
        return [restorer.predict_tiled(lr(hw), 4, tile=TILE,
                                       tile_overlap=OVERLAP) for hw in SET5]

    (set5, launches_set5, _) = drive(
        "Set5 shapes x4 (CSA streaming)", set5_requests,
        ["csa_attention", "f3p_build", "wt_hoist", "grid_decode"],
        csa_idle("csa_attention") + ["grid_decode_rational"])
    for hw, o in zip(SET5, set5):
        check_image("predict_tiled {}x{} x4".format(*hw), o, hr(hw))
    (s25, launches_s25, _) = drive(
        "72x72 x2.5 (CSA streaming)",
        lambda: restorer.predict_tiled(lr(SET5[0]), 2.5, tile=TILE,
                                       tile_overlap=OVERLAP),
        ["csa_attention", "f3p_build", "wt_hoist", "grid_decode_rational"],
        csa_idle("csa_attention") + ["grid_decode"])
    check_image("predict_tiled 72x72 x2.5", s25, hr(SET5[0], 2.5))
    for mode, hw, kern in CSA_FULL:
        (o, launches_full, _) = drive(
            "{}x{} x4 (CSA {})".format(*hw, mode),
            lambda: restorer.predict(full(hw), hr(hw)[:2]),
            [kern] + decoders + ["grid_decode"],
            csa_idle(kern) + ["grid_decode_rational"])
        check_image("predict {}x{} x4".format(*hw), o, hr(hw))
        main_csa["{}@{}x{}".format(kern, *hw)] = launches_full[kern]

    main_launches = dict(launches_x4,
                         grid_decode_rational=launches_rat[
                             "grid_decode_rational"], **main_csa)
    main_launches["grid_decode@{}x{}".format(*ODD)] = \
        launches_odd["grid_decode"]
    s5 = "{}x{}".format(*SET5[0])
    main_launches[f"csa_attention@{s5}"] = (launches_set5["csa_attention"]
                                           + launches_s25["csa_attention"])
    # row 8: nothing in the JAX package calls it, so no path runs it
    main_launches[f"csa_attention_overlap_add@{s5}"] = 0
    for r in rows:
        r["launches"] = main_launches[r["name"]]
        log(f"kernel {r['name']}: max|d|={r['max_abs_err']:.3e} "
            f"max|d|/max|ref|={r['max_rel_err']:.3e} ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) library_ms={r['library_ms']} "
            f"launches={r['launches']} tflops={r['tflops']:.1f}")

    # warm timing of the whole tiled requests
    def warm_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    ms_x4 = warm_ms(lambda: restorer.predict_tiled(lq, 4, tile=TILE,
                                                   tile_overlap=OVERLAP))
    log(f"e2e ({kind}; {smi}): predict_tiled {IMG}->{4 * IMG} x4, 4 tiles: "
        f"first {t_x4 * 1e3 - t_singles * 1e3:.1f} ms, warm {ms_x4:.1f} ms "
        f"= {ms_x4 / 4:.1f} ms/tile, {(4 * IMG) ** 2 / 1e3 / ms_x4:.3f} "
        f"MP/s; single-tile grid_predict {t_singles / 2 * 1e3:.1f} ms/tile")
    ms_25 = warm_ms(lambda: restorer.predict_tiled(lq, 2.5, tile=TILE,
                                                   tile_overlap=OVERLAP))
    log(f"e2e ({kind}; {smi}): predict_tiled {IMG}->{n25} x2.5, 4 tiles: "
        f"warm {ms_25:.1f} ms = {ms_25 / 4:.1f} ms/tile, "
        f"{n25 * n25 / 1e3 / ms_25:.3f} MP/s")
    time_full_images(restorer, big)

    # ---- the kernel route against the plain f32 route on small inputs
    ref_r = CiaoSRRestorer(dict(FLAGSHIP, dtype=None, use_kernels=False),
                           rgb_mean=RGB_MEAN, device="cuda", seed=0)
    small = torch.as_tensor(lr(SMALL), device="cuda")[None]
    sn, on = "{}x{}".format(*SMALL), "{}x{}".format(*ODD)
    # streaming CSA geometries: 72×72 and 57×86 (58×86 in the CSA)
    s72 = torch.as_tensor(lr(SET5[0]), device="cuda")[None]
    s57 = torch.as_tensor(lr(SET5[2]), device="cuda")[None]
    for name, fn in (
            (f"{sn} x4", lambda r: r.grid_predict(small, 4)),
            ("72x72 x4 (CSA streaming)", lambda r: r.grid_predict(s72, 4)),
            ("57x86 x4 (CSA streaming)", lambda r: r.grid_predict(s57, 4)),
            ("72x72 x2.5 (CSA streaming)",
             lambda r: r.grid_predict(s72, Fraction(5, 2))),
            (f"{sn} x2.5", lambda r: r.grid_predict(small, Fraction(5, 2))),
            (f"{sn} x7/3", lambda r: r.grid_predict(small, Fraction(7, 3))),
            (f"{on} x4 (odd width, predict)",
             lambda r: torch.as_tensor(r.predict(lr(ODD), hr(ODD)[:2])))):
        e2e_abs, e2e_rel = errors(fn(restorer), fn(ref_r))
        log(f"e2e kernel route (bf16) vs plain route (f32), {name}: "
            f"max|d|={e2e_abs:.3e} max|d|/max|ref|={e2e_rel:.3e}")
        if not e2e_rel <= REL_TOL:
            raise AssertionError(f"kernel route disagrees at {name}: "
                                 f"{e2e_rel:.3e}")

    breakdown(restorer, tile)
    del ref_r
    mark("the flagship paths, route checks and breakdown")

    # ---- the SwinIR-CiaoSR generator of the 002 configs
    swin = CiaoSRRestorer(SWIN_002, rgb_mean=RGB_MEAN,
                          test_cfg=SWIN_TEST_CFG, device="cuda", seed=0)
    swin_tile = torch.as_tensor(lq_s[:SWIN_TILE, :SWIN_TILE],
                                device="cuda")[None]
    so = lq_s[:SWIN_ODD[0], :SWIN_ODD[1]]
    swin_rows = check_swin_kernels(swin, swin_tile,
                                   torch.as_tensor(so, device="cuda")[None])
    n_blocks = len(swin_blocks(swin.generator))
    no_csa = list(CSA_KERNELS)

    def swin_request(name, img, scale, decode):
        """forward_test of ``img`` at ``scale``: exactly n_blocks Swin
        block launches and one of each decode kernel per tile of the
        request's tiling, nothing else."""
        _, hs, ws = tile_layout(*img.shape[:2], scale, SWIN_TILE,
                                SWIN_TEST_CFG["tile_overlap"])
        tiles = len(hs) * len(ws)
        out, launches, _ = drive(
            f"{name} ({tiles} tiles of {SWIN_TILE})",
            lambda: swin.forward_test(img, scale=scale),
            ["swin_block", "f3p_build", "wt_hoist", decode],
            no_csa + list(BWD_KERNELS)
            + [k for k in ("grid_decode", "grid_decode_rational")
               if k != decode])
        want = {"swin_block": n_blocks * tiles, "f3p_build": tiles,
                "wt_hoist": tiles, decode: tiles}
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"path {name}: launches {got}, want {want}")
        check_image(name, out, hr(img.shape[:2], scale))
        return launches

    sl_x4 = swin_request(f"SwinIR x4 {SWIN_IMG}x{SWIN_IMG}", lq_s, 4,
                         "grid_decode")
    sl_odd = swin_request("SwinIR x4 {}x{}".format(*SWIN_ODD), so, 4,
                          "grid_decode")
    sl_25 = swin_request("SwinIR x2.5 {}x{}".format(*SWIN_ODD), so, 2.5,
                         "grid_decode_rational")
    swin_launches = {   # row 11: the 256 tiles, then the SWIN_ODD tiles
        swin_rows[0]["name"]: sl_x4["swin_block"],
        swin_rows[1]["name"]: sl_odd["swin_block"] + sl_25["swin_block"],
        "f3p_build@C180": sum(sl["f3p_build"]
                              for sl in (sl_x4, sl_odd, sl_25)),
        "wt_hoist@C180": sum(sl["wt_hoist"] for sl in (sl_x4, sl_odd, sl_25)),
        "grid_decode@C180": sl_x4["grid_decode"] + sl_odd["grid_decode"],
        "grid_decode_rational@C180": sl_25["grid_decode_rational"]}
    for r in swin_rows:
        r["launches"] = swin_launches[r["name"]]
        log(f"kernel {r['name']}: max|d|={r['max_abs_err']:.3e} "
            f"max|d|/max|ref|={r['max_rel_err']:.3e} ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) library_ms={r['library_ms']} "
            f"launches={r['launches']} tflops={r['tflops']:.1f}"
            + (f" ms_noshift={r['ms_noshift']:.4f}" if "ms_noshift" in r
               else ""))
    rows += swin_rows
    ms_swin = warm_ms(lambda: swin.forward_test(lq_s))
    n_x4 = sl_x4["f3p_build"]  # one per tile, as swin_request checked
    log(f"e2e ({kind}; {smi}): SwinIR forward_test {SWIN_IMG}->"
        f"{4 * SWIN_IMG} x4, {n_x4} tiles of {SWIN_TILE}: warm "
        f"{ms_swin:.1f} ms = {ms_swin / n_x4:.1f} ms/tile, "
        f"{(4 * SWIN_IMG) ** 2 / 1e3 / ms_swin:.3f} MP/s")
    swin_route_checks(swin, lq_s)
    mark("the SwinIR 002 eval")

    # ---- config 001 swinir: SwinIR-CiaoSR with CSA at 180 channels,
    # through its own test_cfg (forward_test x4, tile 192, overlap 32)
    sw1 = CiaoSRRestorer(SWIN_001, rgb_mean=RGB_MEAN,
                         test_cfg=SWIN_001_TEST_CFG, device="cuda", seed=0)
    sw1_rows = check_swin001_kernels(sw1, swin001_inputs(sw1, lq_s, big))
    mark("the 001 swinir kernel rows")

    def swin001_request(name, imgs, want, odd=False):
        """forward_test of each image: exactly ``want``'s launches (the
        tile count checked against tile_layout), nothing else. Every tile
        of the request has a width divisible by 8 (K3's halo mode), or
        with ``odd`` none has (K3's odd-width mode, row 9), so that K3's
        launches in the request are the one mode's."""
        layouts = [tile_layout(*im.shape[:2], 4, SWIN_001_TILE,
                               SWIN_001_TEST_CFG["tile_overlap"])
                   for im in imgs]
        tiles = sum(len(hs) * len(ws) for _, hs, ws in layouts)
        if tiles != want["f3p_build"]:
            raise AssertionError(f"path {name}: {tiles} tiles, want "
                                 f"{want['f3p_build']}")
        if any(bool(t % 8) != odd for t, _, _ in layouts):
            raise AssertionError(f"path {name}: tile widths "
                                 f"{[t for t, _, _ in layouts]} mix K3's "
                                 "modes")
        outs, launches, _ = drive(
            f"{name} ({tiles} tiles)",
            lambda: [sw1.forward_test(im) for im in imgs], list(want),
            [k for k in kernels.LAUNCHES if k not in want])
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"path {name}: launches {got}, want {want}")
        for im, o in zip(imgs, outs):
            check_image("{} {}x{}".format(name, *im.shape[:2]), o,
                        hr(im.shape[:2]))
        return launches

    l_set5 = swin001_request(
        "001 swinir Set5 shapes x4", [lq_s[:h, :w] for h, w in SET5_X4_EVEN],
        SWIN_001_LAUNCHES["set5"])
    l_odd = swin001_request(
        "001 swinir Set5 shapes x4, odd widths",
        [lq_s[:h, :w] for h, w in SET5_X4_ODD], SWIN_001_LAUNCHES["set5_odd"],
        odd=True)
    s001 = lq_s[:SWIN_001_IMG, :SWIN_001_IMG]
    l_x4 = swin001_request("001 swinir x4", [s001], SWIN_001_LAUNCHES["x4"])
    # the hand-counted table above, as the route and block plan count it
    n1 = len(swin_blocks(sw1.generator))
    for key, imgs in (("set5", SET5_X4_EVEN), ("set5_odd", SET5_X4_ODD),
                      ("x4", [(SWIN_001_IMG,) * 2])):
        if swin001_expected(imgs, 4, True, n1) != SWIN_001_LAUNCHES[key]:
            raise AssertionError(f"swin001_expected disagrees with the "
                                 f"launch table at {key}")

    # its other protocols: x2.5 tiled, x6 full image (the test_cfg for
    # val_scale > 4 has no tile), x4 full images on the blocked wide pair;
    # each request with its launches from swin001_expected and its output
    # against the plain f32 route
    ref1 = CiaoSRRestorer(dict(SWIN_001, dtype=None, use_kernels=False),
                          rgb_mean=RGB_MEAN, test_cfg=SWIN_001_TEST_CFG,
                          device="cuda", seed=0)
    sw6, ref6 = copy.copy(sw1), copy.copy(ref1)
    sw6.test_cfg = ref6.test_cfg = SWIN_001_X6_TEST_CFG

    def swin001_protocol(name, img, scale, tiled, run):
        """``run(restorer, img)`` on the kernel route, with exactly the
        launches swin001_expected counts and nothing else, then on the
        plain f32 route: max|d|/max|ref| <= REL_TOL; logs the request's
        peak device memory. Returns the launches."""
        want = swin001_expected([img.shape[:2]], scale, tiled, n1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out, launches, _ = drive(
            f"{name} (want {want})", lambda: run(sw1 if tiled else sw6, img),
            list(want), [k for k in kernels.LAUNCHES if k not in want])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"path {name}: launches {got}, want {want}")
        check_image(name, out, hr(img.shape[:2], scale))
        a, r = errors(torch.as_tensor(out), torch.as_tensor(
            run(ref1 if tiled else ref6, img)))
        log(f"e2e 001 swinir {name}: peak device memory {peak:.2f} GiB; "
            f"kernel route (bf16) vs plain route (f32) max|d|={a:.3e} "
            f"max|d|/max|ref|={r:.3e}")
        if not r <= REL_TOL:
            raise AssertionError(f"001 swinir {name}: kernel route "
                                 f"disagrees: {r:.3e}")
        return launches

    l_p = {}
    for hw in SWIN_001_X25:
        l_p["x2.5", hw] = swin001_protocol(
            "x2.5 {}x{} (forward_test, tile {})".format(*hw, SWIN_001_TILE),
            lq_s[:hw[0], :hw[1]], 2.5, True,
            lambda r, im: r.forward_test(im, scale=2.5))
    for hw in SWIN_001_X6:
        l_p["x6", hw] = swin001_protocol(
            "x6 {}x{} (forward_test, no tile)".format(*hw),
            lq_s[:hw[0], :hw[1]], 6, False, lambda r, im: r.forward_test(im))
    for hw, kern in SWIN_001_FULL:
        l_p["full", hw] = swin001_protocol(
            "x4 {}x{} (full-image predict, CSA {})".format(*hw, kern),
            full(hw), 4, False,
            lambda r, im: r.predict(im, hr(im.shape[:2])[:2]))
    del ref1, ref6, sw6

    def total(kern, odd=None):
        """``kern``'s launches over the protocol requests; with ``odd``
        only those whose width is (True) or is not (False) a multiple of
        8, K3's odd-width mode (row 9) and its halo mode."""
        return sum(v[kern] for (_, hw), v in l_p.items()
                   if odd is None or bool(hw[1] % 8) == odd)

    sw1_launches = {
        "csa_stencil_fused@C180": (l_set5["csa_stencil_fused"]
                                   + l_x4["csa_stencil_fused"]
                                   + total("csa_stencil_fused")),
        "csa_attention@C180": (l_set5["csa_attention"]
                               + l_odd["csa_attention"]
                               + total("csa_attention")),
        "f3p_build@C180+csa": sum(sl["f3p_build"]
                                  for sl in (l_set5, l_odd, l_x4))
        + total("f3p_build"),
        "wt_hoist@C180+csa": sum(sl["wt_hoist"]
                                 for sl in (l_set5, l_odd, l_x4))
        + total("wt_hoist"),
        "grid_decode@C180+csa": l_set5["grid_decode"] + l_x4["grid_decode"]
        + total("grid_decode", False),
        "grid_decode@C180+csa@{}x{}".format(*SET5_X4_ODD[0]):
            l_odd["grid_decode"] + total("grid_decode", True),
        "grid_decode_rational@C180+csa":
            l_p["x2.5", (SWIN_001_IMG,) * 2]["grid_decode_rational"],
        "grid_decode_rational@C180+csa@{}x{}".format(*SWIN_001_X25[1]):
            l_p["x2.5", SWIN_001_X25[1]]["grid_decode_rational"]}
    for hw, kern in SWIN_001_FULL:
        sw1_launches["{}@C180@{}x{}".format(kern, *hw)] = \
            l_p["full", hw][kern]
    for r in sw1_rows:
        r["launches"] = sw1_launches[r["name"]]
        log(f"kernel {r['name']}: max|d|={r['max_abs_err']:.3e} "
            f"max|d|/max|ref|={r['max_rel_err']:.3e} ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) library_ms={r['library_ms']} "
            f"launches={r['launches']} tflops={r['tflops']:.1f}")
    rows += sw1_rows
    ms_001 = warm_ms(lambda: sw1.forward_test(s001))
    log(f"e2e ({kind}; {smi}): 001 swinir forward_test {SWIN_001_IMG}->"
        f"{4 * SWIN_001_IMG} x4, {l_x4['f3p_build']} tiles of "
        f"{SWIN_001_TILE}: warm {ms_001:.1f} ms = "
        f"{ms_001 / l_x4['f3p_build']:.1f} ms/tile, "
        f"{(4 * SWIN_001_IMG) ** 2 / 1e3 / ms_001:.3f} MP/s")
    swin001_route_checks(sw1, lq_s)
    mark("the 001 swinir paths and route checks")

    # ---- config 001 edsr, as shipped and without the unfold
    u1_rows, edsr_launches, edsr_gens = edsr_phases(drive, check_image, lq)
    unrowed = set(edsr_launches) - {r["name"] for r in rows + u1_rows}
    if unrowed:
        raise AssertionError(f"config 001 edsr launched {unrowed}, which "
                             "no kernel row holds")
    for r in u1_rows:
        r["launches"] = edsr_launches[r["name"]]
    for r in rows:   # the nine-tap phase's launches at the flagship's rows
        if r["name"] in edsr_launches:
            r["launches_edsr"] = edsr_launches[r["name"]]
            r["launches"] += r["launches_edsr"]
    for r in u1_rows + [r for r in rows if "launches_edsr" in r]:
        log(f"kernel {r['name']}: max|d|={r['max_abs_err']:.3e} "
            f"max|d|/max|ref|={r['max_rel_err']:.3e} ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) library_ms={r['library_ms']} "
            f"launches={r['launches']} (config 001 edsr "
            f"{r.get('launches_edsr', r['launches'])}) "
            f"tflops={r['tflops']:.1f}")
    rows += u1_rows
    mark("the 001 edsr phases")

    # ---- the SwinIR generators without the unfold: the one-tap C = 192
    # instances
    su1_rows, su1_launches, su1_gens = swin_u1_phase(drive, check_image,
                                                     lq_s)
    unrowed = set(su1_launches) - {r["name"] for r in rows + su1_rows}
    if unrowed:
        raise AssertionError(f"phase swinir_u1 launched {unrowed}, which no "
                             "kernel row holds")
    for r in rows + su1_rows:
        if r["name"] in su1_launches:
            r["launches_swinir_u1"] = su1_launches[r["name"]]
            r["launches"] += r["launches_swinir_u1"]
    for r in su1_rows:
        log(f"kernel {r['name']}: max|d|={r['max_abs_err']:.3e} "
            f"max|d|/max|ref|={r['max_rel_err']:.3e} ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) library_ms={r['library_ms']} "
            f"launches={r['launches']} tflops={r['tflops']:.1f}")
    rows += su1_rows
    mark("the swinir_u1 phase")
    f32_model_checks(drive, lq, lq_s)
    swin_breakdown(swin, swin_tile)
    mark("the f32 models and the SwinIR breakdown")
    time_kernels(tree, restorer, swin, sw1, lq, lq_s, big,
                 {r["name"]: r["ms"] for r in sw1_rows},
                 edsr_gens["edsr"], edsr_gens["edsr_u1"],
                 {r["name"]: r["ms"] for r in u1_rows}, su1_gens,
                 {r["name"]: r["ms"] for r in su1_rows})
    del sw1, edsr_gens, su1_gens
    mark("time_kernels")

    # ---- training the 002 generator: rows 11 and 12 at the batch's
    # tokens, then the train path
    batch = train_batch(np.random.default_rng(4), TRAIN_B, TRAIN_LR,
                        TRAIN_QSIDE)
    fwd_row = swin_block_row(swin, batch["lq"])
    bwd_row, wgrad_row = check_swin_bwd(swin, batch)
    del batch
    train_path(drive, kind, smi, fwd_row, bwd_row, wgrad_row)
    log(f"kernel {fwd_row['name']}: max|d|={fwd_row['max_abs_err']:.3e} "
        f"max|d|/max|ref|={fwd_row['max_rel_err']:.3e} "
        f"ms={fwd_row['ms']:.4f} ms_noshift={fwd_row['ms_noshift']:.4f} "
        f"plain_ms={fwd_row['plain_ms']:.4f} "
        f"bound_ms={fwd_row['bound_ms']:.4f} ({fwd_row['bound_by']}) "
        f"launches={fwd_row['launches']} tflops={fwd_row['tflops']:.1f}")
    rows.append(fwd_row)
    log(f"kernel {bwd_row['name']}: max|d|={bwd_row['max_abs_err']:.3e} "
        f"max|d|/max|ref|={bwd_row['max_rel_err']:.3e} (dx - dy "
        f"{bwd_row['max_rel_err_dx']:.3e}) ms={bwd_row['ms']:.4f} "
        f"ms_noshift={bwd_row['ms_noshift']:.4f} "
        f"plain_ms={bwd_row['plain_ms']:.4f} "
        f"bound_ms={bwd_row['bound_ms']:.4f} ({bwd_row['bound_by']}) "
        f"launches={bwd_row['launches']} tflops={bwd_row['tflops']:.1f}")
    rows.append(bwd_row)
    log(f"kernel {wgrad_row['name']}: ms={wgrad_row['ms']:.4f} "
        f"bound_ms={wgrad_row['bound_ms']:.4f} ({wgrad_row['bound_by']}) "
        f"library_ms={wgrad_row['library_ms']:.4f} "
        f"launches={wgrad_row['launches']} "
        f"tflops={wgrad_row['tflops']:.1f}")
    rows.append(wgrad_row)
    conv_row = conv3x3_row()
    log(f"kernel {conv_row['name']}: max|d|={conv_row['max_abs_err']:.3e} "
        f"max|d|/max|ref|={conv_row['max_rel_err']:.3e} "
        f"ms={conv_row['ms']:.4f} plain_ms={conv_row['plain_ms']:.4f} "
        f"bound_ms={conv_row['bound_ms']:.4f} ({conv_row['bound_by']}) "
        f"library_ms={conv_row['library_ms']:.4f} "
        f"tflops={conv_row['tflops']:.1f} reproducible")
    rows.append(conv_row)

    mark("the train path")

    # ---- the eval entry points on the shipped 001 configs
    cli_launches = cli_phase(drive, kind, smi)
    unrowed = set(cli_launches) - {r["name"] for r in rows}
    if unrowed:
        raise AssertionError(f"the cli phase launched {unrowed}, which no "
                             "kernel row holds")
    for r in rows:
        if r["name"] in cli_launches:
            r["launches_cli"] = cli_launches[r["name"]]
            r["launches"] += r["launches_cli"]
            log(f"kernel {r['name']}: launches={r['launches']} (cli phase "
                f"{r['launches_cli']})")
    mark("the cli phase")

    # ---- classical training through the train CLI on the shipped configs
    train_launches, train_rows = train_cli_phase(drive, kind, smi)
    rows += train_rows
    unrowed = set(train_launches) - {r["name"] for r in rows}
    if unrowed:
        raise AssertionError(f"the train_cli phase launched {unrowed}, "
                             "which no kernel row holds")
    for r in rows:
        if r["name"] in train_launches:
            r["launches_train_cli"] = train_launches[r["name"]]
            r["launches"] += r["launches_train_cli"]
            log(f"kernel {r['name']}: launches={r['launches']} (train_cli "
                f"phase {r['launches_train_cli']})")
    for r in train_rows:
        log(f"kernel {r['name']}: max|d|={r['max_abs_err']:.3e} "
            f"max|d|/max|ref|={r['max_rel_err']:.3e} ms={r['ms']:.4f} "
            f"ms_noshift={r.get('ms_noshift', float('nan')):.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) library_ms={r['library_ms']} "
            f"launches={r['launches']}")
    mark("the train_cli phase")

    # ---- the real-world GAN stack of the 002 configs
    gan_launches = gan_phase(drive, kind, smi)
    train_row = {"swin_block": fwd_row["name"],
                 "swin_block_bwd": bwd_row["name"],
                 "swin_block_wgrad": wgrad_row["name"],
                 "conv3x3_f32": CONV_ROW}
    bwd_row["launches_gsum"] += gan_launches.pop("swin_block_gsum")
    gan_rows = {train_row.get(k, k): n for k, n in gan_launches.items()}
    unrowed = set(gan_rows) - {r["name"] for r in rows}
    if unrowed:
        raise AssertionError(f"the gan phase launched {unrowed}, which no "
                             "kernel row holds")
    for r in rows:
        if r["name"] in gan_rows:
            r["launches_gan"] = gan_rows[r["name"]]
            r["launches"] += r["launches_gan"]
            log(f"kernel {r['name']}: launches={r['launches']} (gan phase "
                f"{r['launches_gan']})")
    mark("the gan phase")

    # ---- the fixed-scale restorer: no kernel of the port on its path
    basic_phase(drive, kind, smi)
    mark("the basic phase")

    # ---- the JAX package's last public pieces: no kernel of the port
    aux_phase(drive, kind, smi)
    mark("the aux phase")

    # ---- several GPUs: NCCL at world 1, two ranks on the card over gloo,
    # tile groups in this process
    dist_launches = dist_phase(drive, kind, smi, restorer, lq)
    bwd_row["launches_gsum"] += dist_launches.pop("swin_block_gsum")
    dist_rows = {train_row.get(k, k): n for k, n in dist_launches.items()}
    unrowed = set(dist_rows) - {r["name"] for r in rows}
    if unrowed:
        raise AssertionError(f"the dist phase launched {unrowed}, which no "
                             "kernel row holds")
    for r in rows:
        if r["name"] in dist_rows:
            r["launches_dist"] = dist_rows[r["name"]]
            r["launches"] += r["launches_dist"]
            log(f"kernel {r['name']}: launches={r['launches']} (+ "
                f"{r['launches_dist']} dist)")
    mark("the dist phase")

    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
