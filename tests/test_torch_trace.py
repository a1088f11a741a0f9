"""The port's spans and counters (``ciaosr_torch/core/trace.py``) and their
call sites: off, nothing is recorded, no clock or event is read and
nothing is allocated; on, spans nest with their parents and request ids,
``drain`` clears, the counters carry the kernel wrappers' launches without
touching ``kernels.LAUNCHES``; ``predict_tiled`` and both train steps give
their span trees on a tiny CPU generator; and a span lies where the
profiler's trace puts the work inside it (CPU here; on the card, a
``device=True`` span around one ``torch.cuda._sleep`` starts before that
kernel, and its events time it). The card tests are marked ``cuda`` and
skip without one; this file imports no JAX, so on the card run
``python -m pytest --noconftest -q tests/test_torch_trace.py``.
"""

import math
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.autograd.profiler import record_function

from ciaosr_torch.core import trace
from ciaosr_torch.ops import kernels

RDN_SMALL = dict(
    type="LocalImplicitSRRDN",
    encoder=dict(type="RDN", in_channels=3, mid_channels=16, num_blocks=2,
                 num_layers=3, channel_growth=8),
    imnet_q=dict(type="MLPRefiner", out_dim=3, hidden_list=[32, 32]),
    imnet_k=dict(type="MLPRefiner", out_dim=1, hidden_list=[32, 32]),
    imnet_v=dict(type="MLPRefiner", out_dim=1, hidden_list=[32, 32]),
    use_kernels=True)
SWIN_SMALL = dict(
    type="LocalImplicitSRSWINIR", window_size=8,
    encoder=dict(type="SwinIR", embed_dim=12, depths=(2, 2),
                 num_heads=(3, 3)),
    imnet_q=dict(type="MLPRefiner", out_dim=3, hidden_list=[32, 32]),
    imnet_k=dict(type="MLPRefiner", out_dim=1, hidden_list=[32, 32]),
    imnet_v=dict(type="MLPRefiner", out_dim=1, hidden_list=[32, 32]),
    non_local_attn=False, use_kernels=True)
RGB_MEAN = (0.4488, 0.4371, 0.4040)


@pytest.fixture(autouse=True)
def fresh():
    """Every test starts and ends with tracing off and nothing recorded."""
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def _by_name(rec) -> dict:
    out = {}
    for s in rec["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def _parent(rec, s):
    return None if s["parent"] is None else rec["spans"][s["parent"]]


def _ancestors(rec, s) -> list:
    names = []
    while (s := _parent(rec, s)) is not None:
        names.append(s["name"])
    return names


# ------------------------------------------------------------------ module
def test_off_records_nothing_reads_no_clock_and_allocates_nothing(
        monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("read while tracing is off")

    monkeypatch.setattr(trace.time, "time_ns", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b", device=True, request=3)

    def calls(n):
        for _ in range(n):
            with trace.span("outer", device=True):
                with trace.span("inner"):
                    trace.count("things", 5)

    calls(10)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        calls(2000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, trace.__file__)]
    grown = [d for d in after.filter_traces(only).compare_to(
        before.filter_traces(only), "lineno") if d.size_diff or d.count_diff]
    assert grown == []
    monkeypatch.undo()
    rec = trace.drain()
    assert rec["spans"] == []
    assert {k for k, v in rec["counts"].items() if v} == set()


@pytest.mark.parametrize("request_id", [None, 7])
def test_nesting_gives_parents_and_request_ids(request_id):
    trace.enable()
    with trace.span("root", request=request_id):
        with trace.span("a"):
            with trace.span("a.1"):
                pass
        with trace.span("b"):
            pass
    with trace.span("root"):
        with trace.span("c"):
            pass
    seen = {}

    def other_thread():   # its own stack: a root of its own
        with trace.span("thread.root"):
            with trace.span("thread.child"):
                seen["enabled"] = trace.enabled()

    t = threading.Thread(target=other_thread)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and seen["enabled"]
    rec = trace.drain()
    by = _by_name(rec)
    first, second = by["root"]
    assert first["parent"] is None and second["parent"] is None
    assert _parent(rec, by["a"][0]) is first
    assert _parent(rec, by["a.1"][0]) is by["a"][0]
    assert _parent(rec, by["b"][0]) is first
    assert _parent(rec, by["c"][0]) is second
    assert _parent(rec, by["thread.child"][0]) is by["thread.root"][0]
    assert by["thread.root"][0]["parent"] is None
    want_first = 0 if request_id is None else request_id
    for name in ("root", "a", "a.1", "b"):
        assert by[name][0]["request"] == want_first
    ids = {second["request"], by["c"][0]["request"]}
    assert len(ids) == 1 and ids != {want_first}
    assert by["thread.child"][0]["request"] == \
        by["thread.root"][0]["request"]
    for s in rec["spans"]:
        assert 0 < s["start_ns"] <= s["end_ns"]
        assert s["device_ms"] is None
        p = _parent(rec, s)
        if p is not None:
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]


def test_drain_clears_and_enable_restarts():
    trace.enable()
    with trace.span("x"):
        trace.count("n", 2)
    trace.count("n")
    rec = trace.drain()
    assert [s["name"] for s in rec["spans"]] == ["x"]
    assert rec["counts"]["n"] == 3
    rec = trace.drain()
    assert rec["spans"] == [] and "n" not in rec["counts"]
    trace.disable()
    with trace.span("after"):
        trace.count("n")
    assert trace.drain()["spans"] == []
    trace.enable()
    with trace.span("y"):
        pass
    assert trace.drain()["spans"][0]["request"] == 0


def test_counts_carry_launches_and_leave_LAUNCHES_as_it_was(monkeypatch):
    for k in kernels.LAUNCHES:
        monkeypatch.setitem(kernels.LAUNCHES, k, 10)
    trace.enable()
    kernels.LAUNCHES["wt_hoist"] += 3
    kernels.LAUNCHES["swin_block"] += 1
    rec = trace.drain()
    assert {k for k in rec["counts"] if k.startswith("launch.")} == \
        {"launch." + k for k in kernels.LAUNCHES}
    assert rec["counts"]["launch.wt_hoist"] == 3
    assert rec["counts"]["launch.swin_block"] == 1
    assert rec["counts"]["launch.grid_decode"] == 0
    assert kernels.LAUNCHES["wt_hoist"] == 13
    assert kernels.LAUNCHES["swin_block"] == 11
    kernels.LAUNCHES["wt_hoist"] += 2      # counted since the last drain
    assert trace.drain()["counts"]["launch.wt_hoist"] == 2
    kernels.reset_launches()               # a reset in between: from 0
    kernels.LAUNCHES["wt_hoist"] += 1
    assert trace.drain()["counts"]["launch.wt_hoist"] == 1
    assert kernels.LAUNCHES["wt_hoist"] == 1


# ------------------------------------------------------------- call sites
def _restorer(gen: dict, tile_batch: int):
    from ciaosr_torch.models.restorers import CiaoSRRestorer
    torch.manual_seed(0)
    return CiaoSRRestorer(gen, rgb_mean=RGB_MEAN,
                          test_cfg=dict(tile=16, tile_overlap=8,
                                        tile_batch=tile_batch),
                          device="cpu", seed=0)


EVAL_TREE = {
    "restorer.picture": None,
    "restorer.upload": "restorer.picture",
    "restorer.stack": "restorer.picture",
    "restorer.decode": "restorer.picture",
    "restorer.overlap_add": "restorer.picture",
    "restorer.download": "restorer.picture",
    "generator.encoder": "restorer.decode",
    "decoder.tables": "restorer.decode",
    "decoder.pack": "restorer.decode",
    "decoder.k1": "restorer.decode",
    "decoder.k2": "restorer.decode",
    "decoder.k3": "restorer.decode",
    "decoder.shuffle": "restorer.decode",
}


@pytest.mark.parametrize("gen, scale, tile_batch", [
    (RDN_SMALL, 2, 3), (RDN_SMALL, "5/2", 4), (SWIN_SMALL, 2, 2)],
    ids=["rdn-x2-tb3", "rdn-x5/2-tb4", "swin-x2-tb2"])
def test_predict_tiled_span_tree(gen, scale, tile_batch):
    from ciaosr_torch.models.restorers import tile_layout
    res = _restorer(gen, tile_batch)
    rng = np.random.default_rng(1)
    pics = [rng.random((24, 20, 3), np.float32),
            rng.random((16, 32, 3), np.float32)]
    plain = [res.forward_test(p, scale=scale) for p in pics]
    trace.enable()
    traced = [res.forward_test(p, scale=scale) for p in pics]
    rec = trace.drain()
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)
    tree = dict(EVAL_TREE)
    if gen is RDN_SMALL:
        tree["generator.csa"] = "restorer.decode"
    else:
        tree["swin.block"] = "generator.encoder"
    by = _by_name(rec)
    assert set(by) == set(tree)
    for name, parent in tree.items():
        for s in by[name]:
            p = _parent(rec, s)
            assert (p and p["name"]) == parent, name
            assert s["device_ms"] is None
    roots = by["restorer.picture"]
    assert [r["request"] for r in roots] == [0, 1]
    for s in rec["spans"]:
        root = s
        while root["parent"] is not None:
            root = rec["spans"][root["parent"]]
        assert s["request"] == root["request"]
    tiles = [len(hs) * len(ws) for _, hs, ws in
             (tile_layout(*p.shape[:2], scale, 16, 8) for p in pics)]
    groups = [math.ceil(t / tile_batch) for t in tiles]
    c = rec["counts"]
    assert c["restorer.pictures"] == 2
    assert c["restorer.tiles"] == sum(tiles)
    assert c["restorer.groups"] == c["decoder.packs"] \
        == c["decoder.table_builds"] == sum(groups)
    for k, r in enumerate(roots):
        mine = [s for s in rec["spans"] if s["request"] == r["request"]]
        assert sum(s["name"] == "decoder.pack" for s in mine) == groups[k]
        assert sum(s["name"] == "restorer.decode" for s in mine) \
            == groups[k]
    assert c["restorer.h2d_bytes"] == sum(p.size * 4 for p in pics)
    assert c["restorer.d2h_bytes"] > 0
    if gen is SWIN_SMALL:   # packed on the first call, kept since
        assert "swin.packs" not in c
        assert c["swin.pack_hits"] == len(by["swin.block"]) > 0


def _gan_step():
    from ciaosr_torch.models.real_restorer import (GANTrainState,
                                                   RealCiaoSRRestorer)
    from ciaosr_torch.train.optim import build_optimizer
    torch.manual_seed(0)
    res = RealCiaoSRRestorer(
        generator=SWIN_SMALL, rgb_mean=RGB_MEAN,
        pixel_loss=dict(type="L1Loss", loss_weight=1.0, reduction="mean"),
        is_use_sharpened_gt_in_pixel=True, is_use_ema=True,
        train_cfg=dict(disc_steps=1, disc_init_steps=0, ema_momentum=0.999),
        device="cpu", seed=0)
    opt, sched = build_optimizer(res.generator.parameters(),
                                 dict(type="Adam", lr=2e-4))
    step = res.make_gan_train_step(opt, None, (sched, None))
    return step, GANTrainState(0, opt, None, sched, None)


def _classical_step():
    from ciaosr_torch.models.restorers import CiaoSRRestorer
    from ciaosr_torch.train.optim import build_optimizer
    from ciaosr_torch.train.trainer import TrainState, make_train_step
    torch.manual_seed(0)
    res = CiaoSRRestorer(SWIN_SMALL, rgb_mean=RGB_MEAN, device="cpu", seed=0)
    opt, sched = build_optimizer(res.generator.parameters(),
                                 dict(type="Adam", lr=2e-4))
    return (make_train_step(res, opt, sched),
            TrainState(0, res.generator, opt, sched))


def _batch(b: int = 2, lq: int = 16, q: int = 64) -> dict:
    g = torch.Generator().manual_seed(3)
    coord = torch.rand(b, q, 2, generator=g) * 2 - 1
    return {"lq": torch.rand(b, lq, lq, 3, generator=g),
            "gt": torch.rand(b, q, 3, generator=g),
            "gt_unsharp": torch.rand(b, q, 3, generator=g),
            "coord": coord,
            "cell": torch.full((b, q, 2), 2.0 / (2 * lq))}


@pytest.mark.parametrize("make, phases", [
    (_gan_step, ["train.forward", "train.backward", "train.optimizer",
                 "train.ema"]),
    (_classical_step, ["train.forward", "train.backward",
                       "train.optimizer"])], ids=["gan", "classical"])
def test_train_step_spans(make, phases):
    step, state = make()
    batch = _batch()
    state, _ = step(state, batch)     # the first step, untraced
    trace.enable(events=True)
    for _ in range(2):
        state, _ = step(state, batch)
    rec = trace.drain()
    by = _by_name(rec)
    roots = by["train.step"]
    assert [r["request"] for r in roots] == [1, 2]
    assert rec["counts"]["train.steps"] == 2
    for r in roots:
        i = rec["spans"].index(r)
        kids = [s["name"] for s in rec["spans"] if s["parent"] == i]
        assert kids == phases
    for name in phases:
        assert len(by[name]) == 2
        assert all(s["request"] == _parent(rec, s)["request"]
                   for s in by[name])
    # the Swin blocks run under the forward, each re-packed after the
    # update that changed its weights
    assert {_parent(rec, s)["name"] for s in by["swin.block"]} == \
        {"generator.encoder"}
    assert {_ancestors(rec, s)[-2] for s in by["swin.block"]} == \
        {"train.forward"}
    assert rec["counts"]["swin.packs"] == len(by["swin.block"])
    assert "train.all_reduce" not in by and "train.disc" not in by


def test_spans_share_the_profiler_clock():
    """A span around a ``record_function`` block lies, mapped by the
    trace's start, around the profiled event, both edges within 500 µs."""
    trace.enable()
    acts = [torch.profiler.ProfilerActivity.CPU]
    x = torch.ones(256, 256)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            with trace.span("clocked"):
                with record_function("clocked_block"):
                    for _ in range(20):
                        x = (x @ x).clamp(-1, 1)
            time.sleep(0.002)
    spans = trace.drain()["spans"]
    start = prof.profiler.kineto_results.trace_start_ns()
    events = sorted((ev.time_range.start, ev.time_range.end)
                    for ev in prof.events() if ev.name == "clocked_block")
    assert len(events) == len(spans) == 3
    for s, (lo, hi) in zip(spans, events):
        s_lo = (s["start_ns"] - start) / 1e3
        s_hi = (s["end_ns"] - start) / 1e3
        assert s_lo <= lo and hi <= s_hi, (s_lo, lo, hi, s_hi)
        assert lo - s_lo < 500 and s_hi - hi < 500, (s_lo, lo, hi, s_hi)


# ------------------------------------------------------------------- card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("device events and the device's trace need a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_device_span_starts_before_its_kernel_on_the_card(card):
    torch.cuda.synchronize(card)
    trace.enable(events=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with trace.span("slept", device=True):
            torch.cuda._sleep(2_000_000)
        torch.cuda.synchronize(card)
    (s,) = trace.drain()["spans"]
    start = prof.profiler.kineto_results.trace_start_ns()
    kernels_ = [ev for ev in prof.events() if "spin_kernel" in ev.name
                and getattr(ev.device_type, "name", "") == "CUDA"]
    assert len(kernels_) == 1
    k = kernels_[0].time_range
    assert (s["start_ns"] - start) / 1e3 <= k.start
    assert s["device_ms"] is not None
    assert s["device_ms"] >= 0.9 * (k.end - k.start) / 1e3


@pytest.mark.cuda
def test_predict_tiled_waits_apart_and_times_its_decodes_on_the_card(card):
    from ciaosr_torch.models.restorers import CiaoSRRestorer
    torch.manual_seed(0)
    res = CiaoSRRestorer(dict(RDN_SMALL, use_kernels=False),
                         rgb_mean=RGB_MEAN,
                         test_cfg=dict(tile=16, tile_overlap=8,
                                       tile_batch=2), device=card, seed=0)
    pic = np.random.default_rng(1).random((24, 20, 3), np.float32)
    res.forward_test(pic, scale=2)
    trace.enable(events=True)
    res.forward_test(pic, scale=2)
    rec = trace.drain()
    by = _by_name(rec)
    assert _parent(rec, by["restorer.wait"][0])["name"] == \
        "restorer.download"
    for name in ("restorer.decode", "generator.encoder", "generator.csa"):
        assert all(s["device_ms"] is not None and s["device_ms"] > 0
                   for s in by[name]), name
    assert all(s["device_ms"] is None for s in by["restorer.upload"])
