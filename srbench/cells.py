"""The two kinds of cell the benchmark drives, chosen by the traffic mix's
``kind``: a closed loop of photographs through the restorer's
``forward_test`` (``photos``), and the generator's training step on a
pool of batches (``train_batches``).

Each cell function builds the program from the configuration file,
loads the seeded weights, makes the traffic, warms up every shape the
traffic uses, runs the window (traced, the window and then two profiled
stretches: see ``srbench.trace``), and then, with the program freed,
checks what it produced against the plain reference. ``fault`` (tests
only) breaks the program after its set-up.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from srbench import generate
from srbench.correct import picture_gap, train_numbers
from srbench.flops import ciaosr as fl
from srbench.reference.models import (CiaoSR, low_precision_,
                                      unrounded_names)
from srbench.reference.tiling import count_tiles, upscale_tiled
from srbench.reference.train import Adam, l1_step
from srbench.trace import Ranges, Trace, Traced, profiling
from srbench.weights import seeded_state_dict


@dataclass
class Ctx:
    root: Path
    workload: str
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    fault: Callable | None = None
    control: bool = False       # also read the float8 control (calibration)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _reference(gen_cfg: dict, sd: dict, device) -> CiaoSR:
    with torch.device(device):
        model = CiaoSR(gen_cfg)
    model.load_state_dict(sd)
    return model.eval().requires_grad_(False)


# ------------------------------------------------------------------ photos
def _eval_hooks(ranges: Ranges, gen, w: fl.Widths, scale: int) -> None:
    """Ranges around the trunk, the CSA, the Swin blocks and the decode,
    and the work each call needs."""

    def decode_work(args):
        x = args[0]
        parts = fl.tile_work(w, x.shape[0], x.shape[1], scale)
        ranges.note("step", fl.Work(sum(p.flops for k, p in parts.items()
                                        if k != "swin_blocks"), 0.0))
        return parts["decode"]

    ranges.around_method(gen, "decode_grid", "decode", decode_work)
    ranges.around_module(gen.encoder, "encoder")
    if hasattr(gen, "cs_attn"):
        ranges.around_module(
            gen.cs_attn, "csa",
            lambda a: fl.csa_work(a[0].shape[0], a[0].shape[1],
                                  a[0].shape[2], a[0].shape[3]))
    for m in gen.modules():
        if type(m).__name__ == "SwinBlock":
            ranges.around_module(
                m, "swin_block",
                lambda a: fl.swin_block_work(a[0].shape[0] * a[0].shape[1]
                                             * a[0].shape[2], w.enc))


def _picture_flops(w: fl.Widths, tiles: int, tile: int, scale: int) -> float:
    """Trunk, CSA and decode operations of one picture of ``tiles`` tiles
    (the Swin blocks are inside the trunk's count)."""
    return sum(p.flops for k, p in fl.tile_work(w, tiles, tile, scale).items()
               if k != "swin_blocks")


def _spread(name: str, seconds: list) -> str:
    q = np.percentile(np.asarray(seconds) * 1e3, [0, 25, 50, 75, 100])
    return f"{name} ms min/q1/median/q3/max " + " ".join(f"{v:.2f}" for v in q)


def photos(ctx: Ctx) -> dict:
    from ciaosr_torch.models.restorers import CiaoSRRestorer

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    scale = mix["scale"]
    if scale != int(scale):
        raise ValueError(f"scale {scale}: the photos traffic decodes at a "
                         "whole scale only")
    scale = int(scale)
    tile, overlap = int(cfg["test_cfg"]["tile"]), int(
        cfg["test_cfg"].get("tile_overlap", 32))
    widths = fl.Widths.of(cfg["generator"])
    gen_cfg = dict(cfg["generator"], dtype=cfg["precision"]["eval"],
                   use_kernels=True)
    restorer = CiaoSRRestorer(
        generator=gen_cfg, rgb_mean=cfg["rgb_mean"], rgb_std=cfg["rgb_std"],
        test_cfg=dict(cfg["test_cfg"], tile_batch=mix["tile_batch"]),
        device=dev, seed=0)
    sd = seeded_state_dict(cfg["generator"], ctx.seed, dev)
    restorer.generator.load_state_dict(sd)
    pics, loop = generate.photos(mix, ctx.seed, dev)
    tiles = [count_tiles(p.shape[0], p.shape[1], tile, overlap)
             for p in pics]
    if ctx.fault is not None:
        ctx.fault(restorer)
    # every tile-group shape this traffic makes: one picture a tile count
    for n in sorted(set(tiles)):
        restorer.forward_test(pics[tiles.index(n)], scale=scale)
    _sync(dev)
    setup_peak = _peak(dev)
    last = {}

    def pictures(stop):
        """Pictures in the loop's order until ``stop(count, seconds)``:
        (latencies, output MP, window seconds)."""
        lat, mp = [], 0.0
        t0 = t1 = time.perf_counter()
        while not stop(len(lat), t1 - t0):
            k = loop[len(lat) % len(loop)]
            ts = time.perf_counter()
            out = restorer.forward_test(pics[k], scale=scale)
            t1 = time.perf_counter()
            lat.append(t1 - ts)
            mp += out.shape[0] * out.shape[1] / 1e6
            last[k] = out
        return lat, mp, t1 - t0

    _reset_peak(dev)
    setup_s = time.perf_counter() - ctx.t_start
    lat, mp, window = pictures(lambda n, s: s >= ctx.seconds)
    window_peak = _peak(dev)
    result = {"attempted": len(lat), "failed": 0,
              "e2e": {"setup_s": setup_s, "mp_per_s": mp / window,
                      "image_p90_ms": float(np.percentile(lat, 90)) * 1e3},
              "notes": [_spread("picture", lat)]}
    if ctx.trace:
        flops = {n: _picture_flops(widths, n, tile, scale)
                 for n in set(tiles)}
        info = {"window_s": window, "items": len(lat), "output_mp": mp,
                "window_peak_bytes": window_peak,
                "step_flops": sum(flops[tiles[loop[i % len(loop)]]]
                                  for i in range(len(lat)))}
        n_trace = int(mix["trace_items"])
        with profiling(host=False) as prof:
            lat_b, mp_b, win_b = pictures(lambda n, s: n >= n_trace)
        light = Trace(prof.events(), win_b, None,
                      {"items": len(lat_b), "output_mp": mp_b})
        ranges = Ranges(dev)
        _eval_hooks(ranges, restorer.generator, widths, scale)
        with profiling() as prof:
            lat_c, mp_c, win_c = pictures(lambda n, s: n >= n_trace)
        ranges.remove()
        ranged = Trace(prof.events(), win_c, ranges,
                       {"items": len(lat_c), "output_mp": mp_c})
        result["trace"] = Traced(info, light, ranged)
        result["notes"].append(
            f"device-only profile: {result['trace'].slowdown():.4f} of the "
            "window's time a picture")
    result["memory_peak_bytes"] = max(setup_peak, _peak(dev))
    del restorer
    _free(dev)

    # the check: a sample of the finished pictures, the largest in it
    rng = np.random.default_rng(ctx.seed)
    done = sorted(last)
    big = max(done, key=lambda k: (tiles[k], pics[k].size))
    rest = [k for k in done if k != big]
    n_more = min(len(rest), int(mix["check_pictures"]) - 1)
    sample = [big] + sorted(rng.choice(rest, n_more, replace=False).tolist()
                            if n_more else [])
    ref = _reference(cfg["generator"], sd, dev)
    mean = cfg["rgb_mean"]
    gaps, ctrl = [], []
    control = None
    if ctx.control:
        control = low_precision_(_reference(cfg["generator"], sd, dev))
    for k in sample:
        want = upscale_tiled(ref.upscale, pics[k], scale, tile, overlap, mean,
                             dev)
        gaps.append(picture_gap(last[k], want))
        if control is not None:
            low = upscale_tiled(control.upscale, pics[k], scale, tile,
                                overlap, mean, dev)
            ctrl.append(picture_gap(low, want))
    result["numbers"] = {"max_pixel_gap": max(gaps)}
    if control is not None:
        result["control"] = {"max_pixel_gap": max(ctrl)}
    result["checked"] = [int(tiles[k]) for k in sample]
    return result


# ------------------------------------------------------------------- train
def _train_hooks(ranges: Ranges, gen, w: fl.Widths) -> None:
    """Ranges around each Swin block's forward and its backward."""
    def tokens(t):
        return t.shape[0] * t.shape[1] * t.shape[2]

    for m in gen.modules():
        if type(m).__name__ == "SwinBlock":
            ranges.around_module(
                m, "swin_block",
                lambda a: fl.swin_block_work(tokens(a[0]), w.enc))
            ranges.around_backward(
                m, "swin_block_bwd",
                lambda g: fl.swin_block_bwd_work(tokens(g[0]), w.enc))


def _snapshot(named) -> dict:
    return {k: v.detach().clone() for k, v in named}


def _reference_steps(cfg: dict, sd: dict, pool: list, dev,
                     low: bool = False) -> dict:
    """The reference's first three steps from ``sd`` on ``pool``; ``low``:
    the control (TF32 in every float32 product, float8 in the Swin
    blocks)."""
    ref = _reference(cfg["generator"], sd, dev).requires_grad_(True)
    if low:
        low_precision_(ref, [n for n, _ in ref.named_modules()
                             if n.endswith("residual_group")])
    names = [n for n, _ in unrounded_names(ref)]
    params = [p for _, p in unrounded_names(ref)]
    ocfg = cfg["optimizers"]["generator"]
    opt = Adam(params, ocfg["lr"], tuple(ocfg.get("betas", (0.9, 0.999))),
               ocfg.get("eps", 1e-8))
    ema = [p.detach().clone() for p in params]
    mean = torch.as_tensor(cfg["rgb_mean"], device=dev)
    target = "gt_unsharp" if cfg.get("is_use_sharpened_gt_in_pixel") \
        else "gt"
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = low
    torch.backends.cudnn.allow_tf32 = low
    try:
        losses, grad = [], None
        for k in range(3):
            b = pool[k]
            loss, grads = l1_step(ref, opt, ema,
                                  cfg["train_cfg"]["ema_momentum"],
                                  dict(lq=b["lq"], coord=b["coord"],
                                       cell=b["cell"], target=b[target]),
                                  mean)
            losses.append(float(loss))
            if k == 0:
                grad = dict(zip(names, [g.detach().clone() for g in grads]))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return {"losses": losses, "grad": grad,
            "params": {n: p.detach().clone() for n, p in zip(names, params)},
            "ema": dict(zip(names, ema))}


def train_batches(ctx: Ctx) -> dict:
    from ciaosr_torch.models.real_restorer import (GANTrainState,
                                                   RealCiaoSRRestorer)
    from ciaosr_torch.train.optim import build_optimizer

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    gen_cfg = dict(cfg["generator"], dtype=cfg["precision"]["train"],
                   use_kernels=True)
    res = RealCiaoSRRestorer(
        generator=gen_cfg, rgb_mean=cfg["rgb_mean"], rgb_std=cfg["rgb_std"],
        pixel_loss=cfg["pixel_loss"],
        is_use_sharpened_gt_in_pixel=cfg["is_use_sharpened_gt_in_pixel"],
        is_use_ema=True, train_cfg=cfg["train_cfg"],
        test_cfg=cfg["test_cfg"], device=dev, seed=0)
    sd = seeded_state_dict(cfg["generator"], ctx.seed, dev)
    res.generator.load_state_dict(sd)
    res.generator_ema.load_state_dict(sd)
    opt, sched = build_optimizer(res.generator.parameters(),
                                 dict(cfg["optimizers"]["generator"]),
                                 cfg.get("lr_config"))
    step = res.make_gan_train_step(opt, None, (sched, None))
    state = GANTrainState(0, opt, None, sched, None)
    pool = generate.train_batches(mix, ctx.seed, dev)
    if ctx.fault is not None:
        step = ctx.fault(res, step)
    b1 = tuple(cfg["optimizers"]["generator"].get("betas", (0.9, 0.999)))[0]

    # the first three steps, through the window's own call and feed
    named = list(res.generator.named_parameters())
    losses, grad = [], None
    for k in range(3):
        state, out = step(state, pool[k])
        losses.append(float(out["loss_pix"]))
        if k == 0:
            grad = {n: (opt.state[p]["exp_avg"] / (1 - b1)).clone()
                    if "exp_avg" in opt.state.get(p, {}) else
                    torch.zeros_like(p) for n, p in named}
    prog = {"losses": losses, "grad": grad,
            "params": _snapshot(named),
            "ema": _snapshot(res.generator_ema.named_parameters())}
    _sync(dev)
    setup_peak = _peak(dev)

    at = 3

    def steps(stop):
        """Steps on the pool, cycled, until ``stop(count, seconds)``, then
        a synchronize: (count, window seconds, each step's host seconds)."""
        nonlocal state, at
        n, each = 0, []
        t0 = t1 = time.perf_counter()
        while not stop(n, t1 - t0):
            state, _ = step(state, pool[at % len(pool)])
            at += 1
            n += 1
            t2 = time.perf_counter()
            each.append(t2 - t1)
            t1 = t2
        _sync(dev)
        return n, time.perf_counter() - t0, each

    b = mix["batch"]
    w = fl.Widths.of(cfg["generator"])
    _reset_peak(dev)
    setup_s = time.perf_counter() - ctx.t_start
    n, window, each = steps(lambda n, s: s >= ctx.seconds)
    window_peak = _peak(dev)
    result = {"attempted": n, "failed": 0,
              "e2e": {"setup_s": setup_s,
                      "train_samples_per_s": n * b / window},
              "notes": [_spread("step (host)", each)]}
    if ctx.trace:
        info = {"window_s": window, "items": n, "steps": n,
                "window_peak_bytes": window_peak,
                "step_least_s": fl.train_step_least_s(w, b, mix["lq_size"],
                                                      mix["queries"])}
        n_trace = int(mix["trace_steps"])
        with profiling(host=False) as prof:
            n_b, win_b, _ = steps(lambda k, s: k >= n_trace)
        light = Trace(prof.events(), win_b, None, {"items": n_b,
                                                   "steps": n_b})
        ranges = Ranges(dev)
        _train_hooks(ranges, res.generator, w)
        with profiling() as prof:
            n_c, win_c, _ = steps(lambda k, s: k >= n_trace)
        ranges.remove()
        ranged = Trace(prof.events(), win_c, ranges, {"items": n_c,
                                                      "steps": n_c})
        result["trace"] = Traced(info, light, ranged)
        result["notes"].append(
            f"device-only profile: {result['trace'].slowdown():.4f} of the "
            "window's time a step")
    result["memory_peak_bytes"] = max(setup_peak, _peak(dev))
    del res, opt, sched, step, state, named
    _free(dev)

    want = _reference_steps(cfg, sd, pool, dev)
    result["numbers"] = train_numbers(prog, want, sd)
    result["losses"] = {"program": prog["losses"], "reference":
                        want["losses"]}
    if ctx.control:
        low = _reference_steps(cfg, sd, pool, dev, low=True)
        result["control"] = train_numbers(low, want, sd)
        result["losses"]["control"] = low["losses"]
    return result


KINDS = {"photos": photos, "train_batches": train_batches}


def run(ctx: Ctx) -> dict:
    kind = ctx.mix["kind"]
    if kind not in KINDS:
        raise KeyError(f"traffic kind {kind!r}: one of {sorted(KINDS)}")
    return KINDS[kind](ctx)

