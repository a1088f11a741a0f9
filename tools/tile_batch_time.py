"""Warm time a tile of the flagship's ``predict_tiled`` (config 001 rdn,
chip_smoke.py's seeded weights and 256² picture: 4 tiles of 192, overlap
32) at ×4 and ×2.5, for each ``test_cfg["tile_batch"]`` given, on one CUDA
card, for the tree this script is run from: the host clock around each of
CALLS calls that end in a synchronize (median, min, max) and
torch.profiler's CUDA time of one more call, each over the picture's
tiles, and the peak memory. A tree without tile groups decodes one tile a
call whatever ``tile_batch`` says. Copied into another checkout (e.g. the
parent commit from ``git archive``), it times that tree; run trees in
turns in one call to compare them.

    python3 tools/tile_batch_time.py [TILE_BATCH ...]    (default: 1 2 4)
"""

import statistics
import sys
import time
from fractions import Fraction
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
# the repository root in place of tools/ (whose profile.py would shadow the
# standard library's, which torch imports)
sys.path[0] = str(ROOT)

import chip_smoke as cs  # noqa: E402
from ciaosr_torch.models.restorers import (CiaoSRRestorer,  # noqa: E402
                                           tile_layout)

CALLS = 10
SCALES = (4, Fraction(5, 2))


def tile_ms(res, lq: np.ndarray, scale) -> tuple:
    """(host ms a tile: median, min, max; device ms a tile; tiles)."""
    _, hs, ws = tile_layout(cs.IMG, cs.IMG, scale, cs.TILE, cs.OVERLAP)
    n = len(hs) * len(ws)

    def call():
        res.predict_tiled(lq, scale, cs.TILE, cs.OVERLAP)
        torch.cuda.synchronize()

    call()
    ts = []
    for _ in range(CALLS):
        t = time.perf_counter()
        call()
        ts.append((time.perf_counter() - t) * 1e3 / n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
    dev = sum(e.device_time_total for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA) / 1e3 / n
    return statistics.median(ts), min(ts), max(ts), dev, n


def main() -> int:
    if not torch.cuda.is_available():
        print("tile_batch_time: needs a CUDA card", file=sys.stderr)
        return 1
    batches = [int(a) for a in sys.argv[1:]] or [1, 2, 4]
    res = CiaoSRRestorer(cs.FLAGSHIP, rgb_mean=cs.RGB_MEAN,
                         test_cfg=cs.TEST_CFG, device="cuda", seed=0)
    lq = np.random.default_rng(0).random((cs.IMG, cs.IMG, 3),
                                         dtype=np.float32)
    for b in batches:
        res.test_cfg = dict(cs.TEST_CFG, tile_batch=b)
        for s in SCALES:
            torch.cuda.reset_peak_memory_stats()
            med, lo, hi, dev, n = tile_ms(res, lq, s)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"{ROOT}: flagship x{s} {cs.IMG}² ({n} tiles of "
                  f"{cs.TILE}), tile_batch {b}: host ms a tile over {CALLS} "
                  f"calls median {med:.2f} min {lo:.2f} max {hi:.2f}; "
                  f"device ms a tile of one profiled call {dev:.2f}; peak "
                  f"{peak:.2f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
