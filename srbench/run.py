"""Run one benchmark cell of the CiaoSR port once, on the card.

    python3 -m srbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository root. The cell, its configuration and its traffic
mix are found by name through ``BENCHMARK.json``: the configuration file
it names, ``srbench/traffic/<traffic>.json``, ``srbench/limits/
<workload>.json`` and, with ``--trace 1``, one reader
``srbench/metrics/<metric>.py`` for each per-layer metric the cell lists.
The last line of standard output is the result, one JSON object; the
numbers compared for ``correct`` end standard error and the result line.
Exits 2, printing no result, without enough CUDA devices, and 3 if JAX or
the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ciaosr_tpu")


def cache_dirs(root: Path) -> None:
    """Compiler caches at fixed paths inside the checkout (the port's own
    nvcc builds already go to ciaosr_torch/_build/)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(root / "srbench" / "_cache" / sub))


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"srbench: no workload {workload!r} in BENCHMARK.json")


def config_of(root: Path, bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise SystemExit(f"srbench: no configuration {name!r}")


def reports(metric: dict, cell: dict) -> bool:
    """Whether ``cell`` reports the per-layer ``metric``: its ``workloads``
    list, which every per-layer metric has, names the cell."""
    if "workloads" not in metric:
        raise SystemExit(f"srbench: per-layer metric {metric['name']!r} "
                         "lists no workloads")
    return cell["name"] in metric["workloads"]


def reader(root: Path, name: str):
    path = root / "srbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"srbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def build_result(root: Path, bench: dict, cell: dict, out: dict,
                 trace: bool, device) -> dict:
    import torch

    from srbench.correct import judge, load_limits

    e2e_defs = [m for m in bench["end_to_end"]
                if "workloads" not in m or cell["name"] in m["workloads"]]
    metrics = {}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": int(cell.get("chips", 1)),
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if trace:
        tr = out["trace"]
        for m in bench["per_layer"]:
            if reports(m, cell):
                value = reader(root, m["name"])(tr)
                if value is not None and math.isfinite(value):
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = tr.light.busy_s
        dev["window_s"] = tr.light.window_s
    else:
        for m in e2e_defs:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    ok, checks = judge(out["numbers"], load_limits(root, cell["name"]))
    result = {"correct": ok, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": out["trace"].light.top_ops(),
                               "idle_gaps": out["trace"].light.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    cache_dirs(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = find_cell(bench, args.workload)

    import torch

    need = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"srbench: {args.workload} needs {need} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    from srbench.cells import Ctx, run

    ctx = Ctx(root=root, workload=cell["name"],
              cfg=config_of(root, bench, cell["config"]),
              mix=json.loads((root / "srbench" / "traffic"
                              / f"{cell['traffic']}.json").read_text()),
              seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              device=device, t_start=T_START)
    out = run(ctx)
    result = build_result(root, bench, cell, out, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"srbench: loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    for note in out.get("notes", []):
        print(f"srbench: {note}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
