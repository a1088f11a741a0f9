#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ciaosr_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It
  1. prints the card (torch and nvidia-smi: name, power limit);
  2. builds the CUDA kernels from ciaosr_torch/csrc with nvcc;
  3. holds each kernel (bf16) against its plain PyTorch version (f32, same
     inputs) at the flagship shapes (the decode kernel's rational mode at
     ×2.5 on a 192 tile: 25 phases of 96²; its integer mode once more at
     the odd-width request's shapes), max|Δ|/max|ref| ≤ 1e-2, and
     times both with CUDA events (median of several runs after warm-up),
     next to the roofline bound and, where one PyTorch call computes the
     same function, that call's time;
  4. drives the flagship RDN-CiaoSR restorer (config 001 rdn, bf16
     compute, seeded random weights, full width) through the kernel
     route, path by path, with every launch counter set to 0 just before
     each path and read just after: ×4 (predict_tiled of a 256×256 image,
     192 tiles, overlap 32: 4 tiles, and two single-tile grid_predict
     requests); rational (predict_tiled at ×2.5 and ×7/3, a full-image
     ×2.5 predict); the per-query decoder (a target with more than 4096
     phases); an odd width at ×4. It checks each output and which kernels
     each path ran, and holds the kernel route against the plain f32
     route on small inputs at ×4, ×2.5, ×7/3 and the odd width;
  5. prints the kernels line, the card line, and the result line last.
Any failure exits non-zero. Without CUDA, or without the repository's
ciaosr_torch next to it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from fractions import Fraction

import numpy as np
import torch

# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
REL_TOL = 1e-2

FLAGSHIP = dict(
    type="LocalImplicitSRRDN",
    encoder=dict(type="RDN", in_channels=3, out_channels=3, mid_channels=64,
                 num_blocks=16, upscale_factor=4, num_layers=8,
                 channel_growth=64),
    imnet_q=dict(type="MLPRefiner", out_dim=3, hidden_list=[256] * 4),
    imnet_k=dict(type="MLPRefiner", out_dim=64, hidden_list=[256] * 4),
    imnet_v=dict(type="MLPRefiner", out_dim=64, hidden_list=[256] * 4),
    feat_unfold=True, eval_bsize=30000, dtype="bf16", use_kernels=True)
# the main path's request: an IMG × IMG image in TILE × TILE LR tiles
IMG, TILE, OVERLAP = 256, 192, 32
# LR shapes of the smaller requests (H, W). Each CSA geometry is one
# where the JAX package's fused_admission (ciaosr_tpu/models/csa.py)
# picks csa_stencil_fused, K4's TPU counterpart: an even height and a
# (reflect-padded) width that is a multiple of 16. ODD's width, 47, pads
# to 48 in the CSA and keeps the decode at W % 8 != 0, where the TPU
# runs its stacked decode kernel instead of the halo one.
SMALL, FULL, ODD = (48, 48), (96, 80), (60, 47)
TEST_CFG = dict(metrics=["PSNR", "SSIM"], crop_border=4, scale=4, tile=TILE,
                tile_overlap=32, convert_to="y")
RGB_MEAN = (0.4488, 0.4371, 0.4040)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 5, warm: int = 2) -> float:
    """Median CUDA-event time of fn() in ms, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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
    """f32 copies of the floating tensors in a tensor, tuple or dict."""
    if isinstance(x, dict):
        return {k: f32(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(f32(v) for v in x)
    return x.float() if x.is_floating_point() else x


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

    def run(name, source, replaces, kern, plain, flops, nbytes, library):
        with torch.inference_mode():
            got = kern()
            torch.cuda.synchronize()
            ref = plain()
            abs_err, err = errors(got, ref)
            del got, ref
            ms, plain_ms = time_ms(kern), time_ms(plain, reps=3, warm=1)
            lib_ms = time_ms(library) if library else None
        bms, by = bound_ms(flops, nbytes)
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=0, max_abs_err=abs_err,
                         max_rel_err=err, tol_rel=REL_TOL, ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=lib_ms))
        if not err <= REL_TOL:
            raise AssertionError(f"{name}: error {err:.3e} > {REL_TOL}")

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
    run("wt_hoist", "ciaosr_torch/csrc/wt_hoist.cu",
        "ciaosr_tpu/ops/pallas/decoder_kernel.py:762 (_wt_hoist_planes)",
        lambda: dk.wt_hoist(feature, pk["wkout"], pk["bkout"]),
        lambda: dk.wt_hoist_plain(feature.float(), pk["wkout"].float(),
                                  pk["bkout"]),
        2 * 9 * m * 9 * c * (hid + 1),
        m * c * 2 + 9 * c * hid * 2 + 9 * c * 4 + 9 * m * (hid * 2 + 4),
        None)

    def run_decode(name, replaces, maps, tabs, rational):
        """The decode kernel (integer or rational mode) on ``maps``, the
        outputs of K4, K1 and K2 at one LR shape."""
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
        dv = 9 * fc + maps[1].shape[-1]
        mlp = n_shift * (6 * hid * hid + hid * dv + hid) + dv * hid \
            + 3 * hid * hid + hid * 3
        nbytes = sum(t.numel() * t.element_size()
                     for t in (*maps[-1].values(), *tabs.values()))
        run(name, "ciaosr_torch/csrc/grid_decode.cu", replaces,
            lambda: kern(*maps[:6], maps[6], tabs, ss),
            lambda: plain(*f32(maps[:6]), f32(maps[6]), tabs, ss),
            2 * n_phase * m_out * mlp,
            fb * fh * fw * (2 * fc * 2 + 2 * hid * 2 + 9 * (hid * 2 + 4))
            + nbytes + n_phase * m_out * 3 * 4,
            None)

    run_decode("grid_decode",
               "ciaosr_tpu/ops/pallas/decoder_kernel.py:1329 "
               "(_grid_decode_halo)", int_maps, tabs, False)
    run_decode("grid_decode_rational",
               "ciaosr_tpu/ops/pallas/decoder_kernel.py:1224 "
               "(grid_decode_fused_rational)", rat_maps, tabs_r, True)
    run_decode("grid_decode@{}x{}".format(*feat_odd.shape[1:3]),
               "ciaosr_tpu/ops/pallas/decoder_kernel.py:255 "
               "(grid_decode_fused, assembly='stacked')",
               odd_maps, tabs_odd, False)
    hp, wp = match.shape[1:3]
    p_, l_ = hp * wp, keys.shape[1]
    run("csa_stencil", "ciaosr_torch/csrc/csa_stencil.cu",
        "ciaosr_tpu/ops/pallas/csa_attention.py:930 (csa_stencil_fused)",
        lambda: k4.csa_stencil(match, keys, embed, cs, 2),
        lambda: k4.csa_stencil_plain(match.float(), keys.float(),
                                     embed.float(), cs, 2),
        2 * b * p_ * l_ * (keys.shape[-1] + 4 * c),
        b * (p_ * match.shape[-1] * 2 + l_ * keys.shape[-1] * 2
             + p_ * c * 2 + 4 * p_ * c * 4),
        None)
    return rows


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from ciaosr_torch.models.restorers import CiaoSRRestorer
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

    log(f"build: {_build.build_all():.2f} s ({_build.build_dir()})")

    restorer = CiaoSRRestorer(FLAGSHIP, rgb_mean=RGB_MEAN,
                              test_cfg=TEST_CFG, device="cuda", seed=0)
    rng = np.random.default_rng(0)
    lq = rng.random((IMG, IMG, 3), dtype=np.float32)
    tile = torch.as_tensor(lq[:TILE, :TILE], device="cuda")[None]
    def lr(hw):
        return lq[:hw[0], :hw[1]]

    def hr(hw, s=4):
        return (round(s * hw[0]), round(s * hw[1]), 3)

    rows = check_kernels(restorer, tile,
                         torch.as_tensor(lr(ODD), device="cuda")[None])

    # ---- the main paths: requests through the entry points, each path
    # with the launch counters set to 0 just before it and read just after
    def drive(name, fn, ran, idle):
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

    def check_image(name, out, shape):
        out = out.cpu().numpy() if isinstance(out, torch.Tensor) else out
        if out.shape != shape or not np.isfinite(out).all() \
                or out.min() < 0 or out.max() > 1:
            raise AssertionError(f"{name}: bad output {out.shape} "
                                 f"[{out.min()}, {out.max()}], want {shape}")

    decode = ["f3p_build", "wt_hoist", "csa_stencil"]
    int_path = decode + ["grid_decode"]
    rat_path = decode + ["grid_decode_rational"]

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
        "x4", x4_requests, int_path, ["grid_decode_rational"])
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
        "rational", rational_requests, rat_path, ["grid_decode"])
    n25, n73 = round(IMG * 2.5), round(IMG * 7 / 3)
    check_image("predict_tiled x2.5", r25, (n25, n25, 3))
    check_image("predict_tiled x7/3", r73, (n73, n73, 3))
    check_image("predict x2.5 {}x{}".format(*FULL), full25, hr(FULL, 2.5))

    # 101·83 phases: more than the dense decode takes
    (pq, _, _) = drive("per-query", lambda: restorer.predict(
        lr(SMALL), (101, 83)), ["csa_stencil"],
        ["f3p_build", "wt_hoist", "grid_decode", "grid_decode_rational"])
    check_image("predict {}x{} -> 101x83 (per query)".format(*SMALL), pq,
                (101, 83, 3))

    (odd, launches_odd, _) = drive(
        "odd-width x4", lambda: restorer.predict(lr(ODD), hr(ODD)[:2]),
        int_path, ["grid_decode_rational"])
    check_image("predict {}x{} x4".format(*ODD), odd, hr(ODD))

    main_launches = dict(launches_x4,
                         grid_decode_rational=launches_rat[
                             "grid_decode_rational"])
    main_launches["grid_decode@{}x{}".format(*ODD)] = \
        launches_odd["grid_decode"]
    for r in rows:
        r["launches"] = main_launches[r["name"]]
        log(f"kernel {r['name']}: max|d|={r['max_abs_err']:.3e} "
            f"max|d|/max|ref|={r['max_rel_err']:.3e} ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) library_ms={r['library_ms']} "
            f"launches={r['launches']}")

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

    # ---- the kernel route against the plain f32 route on small inputs
    ref_r = CiaoSRRestorer(dict(FLAGSHIP, dtype=None, use_kernels=False),
                           rgb_mean=RGB_MEAN, device="cuda", seed=0)
    small = torch.as_tensor(lr(SMALL), device="cuda")[None]
    sn, on = "{}x{}".format(*SMALL), "{}x{}".format(*ODD)
    for name, fn in (
            (f"{sn} x4", lambda r: r.grid_predict(small, 4)),
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

    log(json.dumps({"kernels": rows}))
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
