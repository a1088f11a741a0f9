"""How much room config 001 swinir's route checks have under their limit:
``chip_smoke.py``'s comparison of the kernel route (bf16) with the plain
f32 route of the same weights (a 192² tile's encoder features, its CSA
output, its ×4 output, and the ×4 output of a 72² request), repeated over
seeded weights and images. Seed s builds both models from seed s and the
LR image from ``numpy.random.default_rng(2 + s)``; seed 0 is
``chip_smoke.py``'s own reading.

    python3 tools/swin001_route_spread.py [n_seeds]   # default 4

Runs on one CUDA card. Prints the card's ``nvidia-smi`` name and power
limit, one line per seed, then one JSON object: per check, each seed's
max|Δ|/max|ref|, their largest and the limit.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from ciaosr_torch.models.restorers import CiaoSRRestorer  # noqa: E402
from ciaosr_torch.ops.kernels import _build  # noqa: E402


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    if not torch.cuda.is_available():
        print("swin001_route_spread: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    # the f32 references compute in full f32, as in chip_smoke.py
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    spread: dict = {}
    for seed in range(n):
        sw = CiaoSRRestorer(cs.SWIN_001, rgb_mean=cs.RGB_MEAN,
                            test_cfg=cs.SWIN_001_TEST_CFG, device="cuda",
                            seed=seed)
        lq_s = np.random.default_rng(2 + seed).random(
            (cs.SWIN_IMG, cs.SWIN_IMG, 3), dtype=np.float32)
        errs = cs.swin001_route_errors(sw, lq_s, seed)
        print(f"seed {seed}: " + "; ".join(
            f"{k} {r:.3e}" for k, (_, r) in errs.items()), flush=True)
        for k, (_, r) in errs.items():
            spread.setdefault(k, []).append(r)
        del sw
    print(json.dumps({k: {"rel": v, "max": max(v), "limit": cs.REL_TOL}
                      for k, v in spread.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
