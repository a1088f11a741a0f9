"""The yardstick: traffic from the seed, the tiling, the operation counts,
the trace reduction, and the plain reference against the program's own
plain route (CPU, small sizes)."""

from __future__ import annotations

import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from srbench import generate
from srbench.flops import ciaosr as fl
from srbench.reference.models import CiaoSR
from srbench.reference.tiling import count_tiles, tile_grid
from srbench.tests._tiny import SEED, real_config, real_mix, tiny_config, \
    tiny_mix
from srbench.trace import Trace, Traced, gaps, merged, overlap
from srbench.weights import seeded_state_dict

CPU = torch.device("cpu")


# ----------------------------------------------------------------- traffic
def test_photos_follow_the_seed():
    mix = tiny_mix("x4.photos")
    a, loop_a = generate.photos(mix, SEED, CPU)
    b, loop_b = generate.photos(mix, SEED, CPU)
    c, _ = generate.photos(mix, SEED + 1, CPU)
    assert loop_a == loop_b == mix["loop"]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))
    sizes = generate.photo_sizes(mix)
    assert [p.shape[:2] for p in a] == [p.shape[:2] for p in c] == sizes
    assert all(0 <= p.min() and p.max() <= 1 for p in a)


def test_real_photo_sizes():
    mix = real_mix("x4.photos")
    sizes = generate.photo_sizes(mix)
    assert len(sizes) == 12 and sum(h > w for h, w in sizes) == 3
    assert {max(s) for s in sizes} == {510}


def test_train_batches_follow_the_seed():
    mix = tiny_mix("train.l1")
    a = generate.train_batches(mix, SEED, CPU)
    b = generate.train_batches(mix, SEED, CPU)
    c = generate.train_batches(mix, SEED + 1, CPU)
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert not torch.equal(a[0]["lq"], c[0]["lq"])
    cells = sorted(float(x["cell"][i, 0, 0]) for x in a
                   for i in range(mix["batch"]))
    cells_c = sorted(float(x["cell"][i, 0, 0]) for x in c
                     for i in range(mix["batch"]))
    assert cells == cells_c   # the same HR sizes, in another order
    x = a[0]
    assert x["lq"].shape == (mix["batch"], mix["lq_size"], mix["lq_size"], 3)
    assert x["coord"].shape == (mix["batch"], mix["queries"], 2)
    assert x["coord"].abs().max() < 1


@pytest.mark.parametrize("config", ["rdn001", "swinir002"])
def test_tiles_match_the_program(config):
    from ciaosr_torch.models.restorers import tile_layout

    cfg = real_config(config)["test_cfg"]
    for h, w in generate.photo_sizes(real_mix("x4.photos")):
        tile, hs, ws = tile_layout(h, w, 4, cfg["tile"], cfg["tile_overlap"])
        assert (tile, hs, ws) == tile_grid(h, w, cfg["tile"],
                                           cfg["tile_overlap"])
        assert count_tiles(h, w, cfg["tile"], cfg["tile_overlap"]) in (
            (6, 9) if config == "rdn001" else (15, 20))


# ------------------------------------------------------------------- flops
def _counted(fn) -> float:
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


@pytest.mark.parametrize("config", ["rdn001", "swinir002"])
def test_trunk_flops_at_real_widths(config):
    gen = real_config(config)["generator"]
    w = fl.Widths.of(gen)
    with torch.device("meta"):
        model = CiaoSR(gen)
        x = torch.zeros(2, 3, 16, 24)
    assert _counted(lambda: model.trunk(x)) == fl.trunk_flops(w, 2 * 16 * 24)


def test_csa_flops_at_real_widths():
    gen = real_config("rdn001")["generator"]
    with torch.device("meta"):
        model = CiaoSR(gen)
        f = torch.zeros(1, 64, 16, 24)
    assert _counted(lambda: model.cs_attn(f)) == fl.csa_reference_flops(
        1, 16, 24, 64)
    assert fl.csa_work(1, 16, 24, 64).flops < fl.csa_reference_flops(
        1, 16, 24, 64)


@pytest.mark.parametrize("config", ["rdn001", "swinir002"])
def test_decoder_flops_at_real_widths(config):
    gen = real_config(config)["generator"]
    w = fl.Widths.of(gen)
    b, h, lw, q = 1, 6, 8, 50
    with torch.device("meta"):
        model = CiaoSR(gen)
        unf = torch.zeros(b, w.dk, h, lw)
        val = torch.zeros(b, w.dv, h, lw)
        coord = torch.zeros(b, q, 2)
        cell = torch.full((b, q, 2), 0.1)
    assert _counted(lambda: model.query_rgb(unf, val, coord, cell)) == \
        fl.per_query_flops(w, b * q)
    # the dense decode needs less than the per-query decode of its pixels
    assert fl.decode_work(w, b, h, lw, 4).flops < fl.per_query_flops(
        w, b * h * lw * 16)


def test_train_step_flops_at_real_widths():
    cfg = real_config("swinir002")
    gen = cfg["generator"]
    w = fl.Widths.of(gen)
    b, lr, q = 2, 16, 64
    with torch.device("meta"):
        model = CiaoSR(gen)
        x = torch.zeros(b, 3, lr, lr)
        coord = torch.zeros(b, q, 2)
        cell = torch.full((b, q, 2), 0.1)

    def step():
        model(x, coord, cell).abs().mean().backward()

    f32, bf16 = fl.train_step_flops(w, b, lr, q)
    assert _counted(step) == pytest.approx(f32 + bf16, rel=1e-12)
    assert fl.train_step_least_s(w, b, lr, q) == pytest.approx(
        f32 / fl.PEAK_F32 + bf16 / fl.PEAK_BF16)


def test_tile_work_of_the_cells():
    rdn = fl.tile_work(fl.Widths.of(real_config("rdn001")["generator"]),
                       1, 192, 4)
    assert rdn["decode"].flops == pytest.approx(3.177e12, rel=1e-3)
    assert rdn["trunk"].flops == pytest.approx(1.619e12, rel=1e-3)
    assert rdn["csa"].flops == pytest.approx(0.3728e12, rel=1e-3)
    sw = fl.tile_work(fl.Widths.of(real_config("swinir002")["generator"]),
                      1, 128, 4)
    assert sw["csa"].flops == 0 and sw["swin_blocks"].flops > 0


# ------------------------------------------------------------------- trace
def test_interval_arithmetic():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 7), (10, 11)]
    u = merged(iv)
    assert u == [(0, 3), (5, 7), (10, 11)]
    assert sum(e - s for s, e in u) == 6
    assert gaps(iv, 0, 12) == [(3, 5), (7, 10), (11, 12)]
    assert overlap(u, 2, 10.5) == 1 + 2 + 0.5
    assert overlap(u, 3, 5) == 0


def _ev(name, start, end, device=True, kernels=(), parent=None):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=SimpleNamespace(name="CUDA" if device else "CPU"),
        kernels=[SimpleNamespace(name=k) for k in kernels],
        cpu_parent=parent)


def test_trace_reduction_and_readers():
    from srbench.run import reader
    from srbench.tests._tiny import ROOT
    from srbench.trace import Ranges

    ranges = Ranges(CPU)
    ranges.log = [("decode", 0), ("csa", 0), ("csa", 1), ("decode", 1)]
    ranges.note("decode", fl.Work(2e9, 0.0))
    ranges.note("csa", fl.Work(1e9, 0.0))
    conv = _ev("aten::convolution", 0, 100, device=False)
    events = [
        _ev("spin_kernel", 0, 1), _ev("spin_kernel", 10, 11),
        _ev("k4", 12, 20), _ev("spin_kernel", 21, 22),
        _ev("k3", 30, 60), _ev("spin_kernel", 70, 71),
        _ev("cudnn_fprop", 80, 90), _ev("Memcpy DtoH", 95, 100),
        _ev("aten::cudnn_convolution", 0, 100, device=False,
            kernels=["cudnn_fprop"], parent=conv),
        _ev("aten::add", 0, 100, device=False, kernels=["k3"]),
    ]
    t = Trace(events, 200e-6, ranges, {"items": 2, "steps": 2,
                                       "output_mp": 1.0})
    assert t.busy_s == pytest.approx(57e-6)
    assert t.range_dev["csa"] == pytest.approx(8e-6)       # 11..21: k4
    assert t.range_dev["decode"] == pytest.approx(40e-6)   # 1..70
    assert t.op_dev("convolution") == pytest.approx(10e-6)
    assert t.device_s("Memcpy") == pytest.approx(5e-6)
    # the window's own counts; the device-only stretch has no ranges
    light = Trace(events, 400e-6, None, {"items": 2, "steps": 2})
    assert light.range_dev == {} and light.busy_s == t.busy_s
    tr = Traced({"window_s": 2.0, "items": 20, "steps": 20,
                 "window_peak_bytes": 2 ** 30, "step_flops": 4e13,
                 "step_least_s": 0.05}, light, t)
    assert tr.slowdown() == pytest.approx(2e-3)
    read = {n: reader(ROOT, n) for n in (
        "csa_roofline.eval", "decode_roofline.eval", "device_idle_share.eval",
        "conv_dev_ms_per_step", "copy_dev_ms_per_image", "peak_mem_gib.eval",
        "step_mfu.eval", "step_mfu.train", "encoder_dev_ms_per_mp")}
    assert read["csa_roofline.eval"](tr) == pytest.approx(
        1e9 / fl.PEAK_BF16 / 8e-6 * 100)
    assert read["decode_roofline.eval"](tr) == pytest.approx(
        2e9 / fl.PEAK_BF16 / 32e-6 * 100)
    assert read["device_idle_share.eval"](tr) == pytest.approx(
        (1 - 57 / 400) * 100)
    assert read["conv_dev_ms_per_step"](tr) == pytest.approx(5e-3)
    assert read["copy_dev_ms_per_image"](tr) == pytest.approx(2.5e-3)
    assert read["peak_mem_gib.eval"](tr) == 1.0
    assert read["step_mfu.eval"](tr) == pytest.approx(
        4e13 / 2.0 / fl.PEAK_BF16 * 100)
    assert read["step_mfu.train"](tr) == pytest.approx(0.05 * 20 / 2.0 * 100)
    assert read["encoder_dev_ms_per_mp"](tr) is None      # no trunk range
    assert [n for n, _ in t.top_ops(2)] == ["k3", "cudnn_fprop"]
    # each idle gap named by the host operator over it and what ends it
    assert t.idle_gaps(1) == [["aten::add, before spin_kernel",
                               pytest.approx(10e-6)]]       # 60..70
    assert light.idle_gaps(1)[0][0] == "aten::add, before spin_kernel"
    # a log the markers do not match reads nothing (never a share of 0)
    ranges.log = ranges.log[:-1]
    t2 = Trace(events, 200e-6, ranges, {})
    assert read["csa_roofline.eval"](Traced({}, light, t2)) is None


# --------------------------------------------------------------- reference
def _port(cfg, sd, **kw):
    from ciaosr_torch.models.builder import build_generator

    gen = build_generator(dict(cfg["generator"], **kw), device="cpu")
    gen.load_state_dict(sd)
    return gen


@pytest.mark.parametrize("config", ["rdn001", "swinir002"])
def test_reference_matches_the_program_plain_route(config):
    cfg = tiny_config(config)
    sd = seeded_state_dict(cfg["generator"], SEED, CPU)
    ref = CiaoSR(cfg["generator"])
    ref.load_state_dict(sd)
    port = _port(cfg, sd)
    x = torch.rand(2, 12, 16, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = ref.upscale(x.permute(0, 3, 1, 2), 4)
        got = port.decode_grid(x, 4)
    assert (got - want).abs().max() < 1e-4
    # the training forward at random queries
    q = 40
    g = torch.Generator().manual_seed(2)
    coord = torch.rand(2, q, 2, generator=g) * 2 - 1
    cell = torch.full((2, q, 2), 2 / 48)
    with torch.no_grad():
        want = ref(x.permute(0, 3, 1, 2), coord, cell)
        got = port(x, coord, cell)
    assert (got - want).abs().max() < 1e-4


def test_weights_follow_the_seed_and_load_into_the_program():
    cfg = tiny_config("swinir002")
    a = seeded_state_dict(cfg["generator"], SEED, CPU)
    b = seeded_state_dict(cfg["generator"], SEED, CPU)
    c = seeded_state_dict(cfg["generator"], SEED + 1, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    port = _port(cfg, a)
    assert set(port.state_dict()) == set(a)
    ln = [k for k in a if k.endswith("norm1.weight")]
    assert ln and all(torch.all(a[k] == 1) for k in ln)


def test_limits_files_hold_their_readings():
    from srbench.tests._tiny import ROOT

    for path in (ROOT / "srbench" / "limits").glob("*.json"):
        for name, v in json.loads(path.read_text()).items():
            assert v["lower"] < v["limit"] < v["upper"], (path.name, name)
            assert v["limit"] / v["lower"] > v["upper"] / v["limit"]
            assert math.isfinite(v["limit"])
