"""Tiny stand-ins for the benchmark's configurations and traffic, for runs
on the CPU: every width cut, every other key as the real file has it."""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 7   # above 32 signed bits, as the benchmark's seeds may be


def real_config(name: str) -> dict:
    return json.loads((ROOT / "srbench" / "configs" / f"{name}.json")
                      .read_text())


def real_mix(name: str) -> dict:
    return json.loads((ROOT / "srbench" / "traffic" / f"{name}.json")
                      .read_text())


def tiny_config(name: str) -> dict:
    """The configuration cut to a CPU test's size, computing in float32:
    the CPU runs the program's plain route, whose bf16 rounding is not the
    kernels' (the comparison with the limits is a check of the faults, not
    of the card's precision)."""
    c = real_config(name)
    c["precision"] = {k: "float32" for k in c["precision"]}
    enc = c["generator"]["encoder"]
    if enc["type"] == "RDN":
        enc.update(mid_channels=16, num_blocks=2, num_layers=2,
                   channel_growth=8)
        c["test_cfg"].update(tile=24, tile_overlap=8)
    else:
        enc.update(embed_dim=12, depths=[2, 2], num_heads=[2, 2])
        c["test_cfg"].update(tile=16, tile_overlap=8)
    for k in ("imnet_q", "imnet_k", "imnet_v"):
        c["generator"][k]["hidden_list"] = [32, 32]
    return c


def tiny_mix(name: str) -> dict:
    m = real_mix(name)
    if m["kind"] == "photos":
        m.update(long_side=40, short_sides=[24, 30, 36], portrait_at=[1],
                 loop=[2, 0, 1], tile_batch=2, trace_items=3,
                 check_pictures=2)
    else:
        m.update(batch=2, lq_size=16, queries=64, pool=4, trace_steps=2)
    return m


def run_tiny(config: str, traffic: str, *, trace=False, fault=None,
             control=False, seconds=0.5, seed=SEED, cfg=None, mix=None):
    from srbench.cells import Ctx, run

    ctx = Ctx(root=ROOT, workload="tiny", cfg=cfg or tiny_config(config),
              mix=mix or tiny_mix(traffic), seed=seed, seconds=seconds,
              trace=trace, device=torch.device("cpu"),
              t_start=time.perf_counter(), fault=fault, control=control)
    return run(ctx)
