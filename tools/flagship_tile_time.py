"""Warm time of one flagship ×4 192² LR tile (``grid_predict``, config
001 rdn, chip_smoke.py's seeded weights and image) on one CUDA card, for
the tree this script is run from: the host clock around each of 20 calls
(each ends in a synchronize: median, min, max), and torch.profiler's
device time of one more call with its largest kernels. The tile is
host-bound, so its wall time moves little when a kernel gets faster; the
device time says what the kernels gained. Copied into another checkout
(e.g. the parent commit from ``git archive``), it times that tree; run
trees in turns in one call to compare them.

    python3 tools/flagship_tile_time.py
"""

import statistics
import sys
import time
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
from ciaosr_torch.models.restorers import CiaoSRRestorer  # noqa: E402

CALLS, WARM = 20, 3


def main() -> int:
    if not torch.cuda.is_available():
        print("flagship_tile_time: needs a CUDA card", file=sys.stderr)
        return 1
    res = CiaoSRRestorer(cs.FLAGSHIP, rgb_mean=cs.RGB_MEAN, device="cuda",
                         seed=0)
    lq = np.random.default_rng(0).random((cs.IMG, cs.IMG, 3),
                                         dtype=np.float32)
    tile = torch.as_tensor(lq[:cs.TILE, :cs.TILE], device="cuda")[None]
    for _ in range(WARM):
        res.grid_predict(tile, 4)
    torch.cuda.synchronize()
    ts = []
    for _ in range(CALLS):
        t = time.perf_counter()
        res.grid_predict(tile, 4)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res.grid_predict(tile, 4)
        torch.cuda.synchronize()
    evs = sorted(((e.device_time_total, e.count, e.key)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA), reverse=True)
    print(f"{ROOT}: flagship x4 {cs.TILE}² tile, host ms over {CALLS} "
          f"calls: median {statistics.median(ts):.2f} min {min(ts):.2f} "
          f"max {max(ts):.2f}; device ms of one profiled call "
          f"{sum(t for t, _, _ in evs) / 1e3:.2f}")
    for t, n, key in evs[:6]:
        print(f"  {t / 1e3:8.3f} ms x{n:<4d} {key[:70]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
