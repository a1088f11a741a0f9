"""Warm train-step time of the SwinIR-CiaoSR 002 generator on one CUDA
card, for the tree this script is run from: ``make_train_step`` at the
002 batch (chip_smoke.py's constants, seeded batches), 30 steps, the
median and quartiles of the last 25 (host clock around each step, which
ends in a synchronize) and the median of CUDA events around the same
steps. Copied into another checkout (e.g. the parent commit from ``git
archive``), it times that tree; run trees in turns in one call to
compare them.

    python3 tools/train_step_time.py
"""

import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
# the repository root in place of tools/ (whose profile.py would shadow the
# standard library's, which torch imports)
sys.path[0] = str(ROOT)

import chip_smoke as cs  # noqa: E402
from ciaosr_torch.models.restorers import CiaoSRRestorer  # noqa: E402
from ciaosr_torch.train.optim import build_optimizer  # noqa: E402
from ciaosr_torch.train.trainer import TrainState, make_train_step  # noqa

STEPS, WARM = 30, 5


def main() -> int:
    if not torch.cuda.is_available():
        print("train_step_time: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = CiaoSRRestorer(cs.SWIN_002, rgb_mean=cs.RGB_MEAN, device="cuda",
                         seed=0)
    opt, sched = build_optimizer(res.generator.parameters(), cs.TRAIN_OPT,
                                 cs.TRAIN_LR_CFG)
    state = TrainState(0, res.generator, opt, sched)
    step = make_train_step(res, opt, sched)
    rng = np.random.default_rng(4)
    batches = [cs.train_batch(rng, cs.TRAIN_B, cs.TRAIN_LR, cs.TRAIN_QSIDE)
               for _ in range(STEPS)]
    host, dev = [], []
    for bt in batches:
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t = time.perf_counter()
        a.record()
        state, _ = step(state, bt)
        b.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
        dev.append(a.elapsed_time(b))
    w = host[WARM:]
    print(f"train step ({ROOT.name}): median {statistics.median(w):.1f} "
          f"ms, quartiles {np.percentile(w, 25):.1f}-"
          f"{np.percentile(w, 75):.1f}, events median "
          f"{statistics.median(dev[WARM:]):.1f} ms over {len(w)} warm "
          f"steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
