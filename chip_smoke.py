#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ciaosr_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It
  1. prints the card (torch and nvidia-smi: name, power limit);
  2. builds the four CUDA kernels from ciaosr_torch/csrc with nvcc;
  3. holds each kernel (bf16) against its plain PyTorch version (f32, same
     inputs) at the flagship shapes, max|Δ|/max|ref| ≤ 1e-2, and times
     both with CUDA events (median of several runs after warm-up), next to
     the roofline bound and, where one PyTorch call computes the same
     function, that call's time;
  4. drives the flagship RDN-CiaoSR ×4 restorer (config 001 rdn, bf16
     compute, seeded random weights, full width) through the kernel route:
     predict_tiled of a 256×256 image (192 tiles, overlap 32: 4 tiles)
     and two single-tile grid_predict requests, with every launch counter
     set to 0 just before and read just after; checks the output and that
     every kernel ran; checks the kernel route against the plain f32
     route on a small input;
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
TEST_CFG = dict(metrics=["PSNR", "SSIM"], crop_border=4, scale=4, tile=192,
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


def check_kernels(restorer, lq_tile: torch.Tensor) -> list[dict]:
    """Each kernel vs its plain version on the main path's tensors of one
    flagship tile (bf16 kernel, f32 plain on the same values)."""
    from ciaosr_torch.ops.kernels import csa_stencil as k4
    from ciaosr_torch.ops.kernels import decoder as dk

    net = restorer.generator
    s, dt = 4, torch.bfloat16
    with torch.inference_mode():
        feature = net.gen_feature(restorer.normalize(lq_tile)).contiguous()
        match, keys, embed = net.cs_attn.stencil_inputs(feature, 2, dt)
        csa = net.nl_feature(feature, use_kernel=True).to(dt).contiguous()
        b, h, w, c = feature.shape
        pk = dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, c, s, dt)
        tabs = dk.decoder_tables(s, h, w, net.local_size, feature.device)
        gk, gv = dk.f3p_build(feature, csa, pk["wk0"], pk["wvu"], pk["wvc"])
        wt, ck = dk.wt_hoist(feature, pk["wkout"], pk["bkout"])
    m = b * h * w
    n_phase, n_shift = tabs["dys"].shape
    hid, dv = 256, 9 * c + csa.shape[-1]
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
    mlp = n_shift * (6 * hid * hid + hid * dv + hid) + dv * hid \
        + 3 * hid * hid + hid * 3
    w_bytes = sum(v.numel() * v.element_size() for v in pk.values())
    run("grid_decode", "ciaosr_torch/csrc/grid_decode.cu",
        "ciaosr_tpu/ops/pallas/decoder_kernel.py:1329 (_grid_decode_halo)",
        lambda: dk.grid_decode(feature, csa, gk, gv, wt, ck, pk, tabs, ss),
        lambda: dk.grid_decode_plain(*f32((feature, csa, gk, gv, wt, ck)),
                                     f32(pk), tabs, ss),
        2 * n_phase * m * mlp,
        m * (2 * c * 2 + 2 * hid * 2 + 9 * (hid * 2 + 4)) + w_bytes
        + n_phase * m * 3 * 4,
        None)
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
    the kernel route, and the profiler's device-busy share of one
    grid_predict request with its top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ciaosr_torch.models.ciaosr import pixel_shuffle
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
                                   s, dt)
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
                dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, c, s,
                                dt),
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
    lq = rng.random((256, 256, 3), dtype=np.float32)
    tile = torch.as_tensor(lq[:192, :192], device="cuda")[None]
    rows = check_kernels(restorer, tile)

    # ---- the main path: a few requests through the entry points
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = restorer.predict_tiled(lq, 4, tile=192, tile_overlap=32)
    t1 = time.perf_counter()
    singles = [restorer.grid_predict(
        torch.as_tensor(lq[i:i + 192, j:j + 192], device="cuda")[None], 4)
        for i, j in ((0, 64), (64, 0))]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    log(f"main path launches: {launches}")
    if out.shape != (1024, 1024, 3) or not np.isfinite(out).all() \
            or out.min() < 0 or out.max() > 1:
        raise AssertionError(f"bad predict_tiled output {out.shape} "
                             f"[{out.min()}, {out.max()}]")
    for o in singles:
        if o.shape != (1, 768, 768, 3) or not bool(torch.isfinite(o).all()):
            raise AssertionError(f"bad grid_predict output {o.shape}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    for r in rows:
        r["launches"] = launches[r["name"]]
        log(f"kernel {r['name']}: max|d|={r['max_abs_err']:.3e} "
            f"max|d|/max|ref|={r['max_rel_err']:.3e} ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) library_ms={r['library_ms']} "
            f"launches={r['launches']}")

    # warm timing of the whole tiled request
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    restorer.predict_tiled(lq, 4, tile=192, tile_overlap=32)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    tile_ms = [(t4 - t3) / 4 * 1e3,
               (t2 - t1) / 2 * 1e3]
    log(f"e2e ({kind}; {smi}): predict_tiled 256->1024 x4, 4 tiles: first "
        f"{(t1 - t0) * 1e3:.1f} ms, warm {(t4 - t3) * 1e3:.1f} ms = "
        f"{tile_ms[0]:.1f} ms/tile, {1024 * 1024 / 1e6 / (t4 - t3):.3f} "
        f"MP/s; single-tile grid_predict {tile_ms[1]:.1f} ms/tile")

    # ---- the kernel route against the plain f32 route on a small input
    ref_r = CiaoSRRestorer(dict(FLAGSHIP, dtype=None, use_kernels=False),
                           rgb_mean=RGB_MEAN, device="cuda", seed=0)
    small = torch.as_tensor(lq[:48, :40], device="cuda")[None]
    got = restorer.grid_predict(small, 4)
    ref = ref_r.grid_predict(small, 4)
    e2e_abs, e2e_rel = errors(got, ref)
    log(f"e2e kernel route (bf16) vs plain route (f32), 48x40 x4: "
        f"max|d|={e2e_abs:.3e} max|d|/max|ref|={e2e_rel:.3e}")
    if not e2e_rel <= REL_TOL:
        raise AssertionError(f"kernel route disagrees: {e2e_rel:.3e}")

    breakdown(restorer, tile)

    log(json.dumps({"kernels": rows}))
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
