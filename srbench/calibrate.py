"""Readings that set the limits of ``correct``: for each seed, one cell
run (a short window at the cell's own load, in one process so that the
kernels load once) with the program's numbers, the float8 control's
(TF32 and float8 Swin blocks for the training cell) and, for a training
cell, the numbers of planted faults.

    python3 -m srbench.calibrate --workload <name> --seeds 1 2 3 \
        --seconds 5 [--faults half_batch] [--no-control] --out <file.jsonl>

One JSON line a reading is appended to ``--out``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--no-control", action="store_true")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    root = Path.cwd()

    from srbench import faults as fl_
    from srbench.run import cache_dirs, config_of, find_cell

    cache_dirs(root)
    import torch

    from srbench.cells import Ctx, run

    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = find_cell(bench, args.workload)
    cfg = config_of(root, bench, cell["config"])
    mix = json.loads((root / "srbench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    dev = torch.device("cuda", 0)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    table = {**fl_.EVAL, **fl_.TRAIN}
    for seed in args.seeds:
        for fault in [None, *args.faults]:
            t0 = time.perf_counter()
            ctx = Ctx(root=root, workload=cell["name"], cfg=cfg, mix=mix,
                      seed=seed, seconds=args.seconds, trace=False,
                      device=dev, t_start=t0,
                      fault=table[fault] if fault else None,
                      control=fault is None and not args.no_control)
            r = run(ctx)
            line = {"workload": cell["name"], "seed": seed, "fault": fault,
                    "numbers": r["numbers"], "control": r.get("control"),
                    "e2e": r["e2e"], "attempted": r["attempted"],
                    "checked": r.get("checked"), "losses": r.get("losses"),
                    "seconds": time.perf_counter() - t0}
            with out.open("a") as f:
                f.write(json.dumps(line) + "\n")
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
