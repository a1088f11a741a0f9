"""Where the time of K1's one-tap mode goes (``f3p_build`` with one tap:
g_k = feature @ W_k0, g_v = feature @ W_vu + csa @ W_vc), on one CUDA card,
for the tree this script is run from, at ``chip_smoke.py``'s shapes of its
three one-tap instances (seeded bf16 maps and weights):

  @u1           (C, DC) = (64, 64),   one 192² map (001 edsr_u1's tile)
  @C180@u1      (192, 0),   one 256² map (the 002 generator's tile)
  @C180+csa@u1  (192, 192), one 192² map (001 swinir's tile)

For the wrapper and for its library yardstick (one ``torch.matmul`` of
[feature | csa] by [[W_k0, W_vu], [0, W_vc]]) it prints:

  device  torch.profiler's CUDA time a launch (K1: its kernel; the
          yardstick: every kernel of the call), median of ROUNDS profiles
          of CALLS calls
  events  chip_smoke.time_ms: CUDA events around 10 calls enqueued back
          to back, over 10 (what chip_smoke.py's kernel rows report)
  lone    CUDA events around one call after a synchronize (median)
  host    the host's time to return from one call (CALLS calls enqueued
          back to back, no synchronize inside), µs
  entry   (K1 only) the host time of the C entry point alone, ctypes
          prototype set once: the launcher's tensor maps and launch
          without the wrapper's checks and allocations, µs
  split   (K1 only) µs of the wrapper's parts, each alone: its checks
          (instance, taps, five tensors), the outputs' allocation as two
          tensors and as one, the current stream (``_build.stream_ptr``,
          and the raw pointer alone)

and one JSON line. Copied into another checkout (e.g. the parent commit
from ``git archive``), it times that tree; run trees in turns in one call
to compare them.

With ``--ablate`` it only times the one-tap kernel (device time, as
above) against copies of it with one class of work taken out (these
compute wrong values and serve timing only) or with other ring depths:

  noB      the weight tiles loaded in their ring's first round only
  noA      the feature and CSA tiles loaded in their ring's first round only
  nostore  no stores of the outputs
  nomma    no wgmma products
  aNbM     N-deep ring of feature and CSA tiles and M-deep ring of
           weight tiles (aN: M = 3)

    python3 tools/k1_u1_probe.py [LABEL]
    python3 tools/k1_u1_probe.py --ablate
"""

import ctypes
import json
import re
import statistics
import subprocess
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
from ciaosr_torch.ops.kernels import _build  # noqa: E402
from ciaosr_torch.ops.kernels import decoder as dk  # noqa: E402

CASES = (("f3p_build@u1", 192, 192, 64, 64),
         ("f3p_build@C180@u1", 256, 256, 192, 0),
         ("f3p_build@C180+csa@u1", 192, 192, 192, 192))
CALLS, ROUNDS, HID = 50, 5, 256


def depth(a: int, b: int) -> tuple:
    """The rings' depths at every instance: ``a`` feature / CSA tiles,
    ``b`` weight tiles."""
    return (r"constexpr int U1_ASTAGES = \d+, U1_ASTAGES_CSA = \d+, "
            r"U1_BSTAGES = \d+;",
            f"constexpr int U1_ASTAGES = {a}, U1_ASTAGES_CSA = {a}, "
            f"U1_BSTAGES = {b};")


# (name, [(pattern, replacement), ...]) on csrc/f3p_build.cu, each
# pattern matched once, in the one-tap kernel
VARIANTS = (
    ("noB", [(r"mbar_expect_tx\(&fullb\[s\], B_BYTES\);",
              "mbar_expect_tx(&fullb[s], g < U1_BSTAGES ? B_BYTES : 0);"),
             (r"for \(int j = 0; j < HID / 64; \+\+j\)(\s*tma_load_2d\("
              r"bt \+ j \* SLAB, wmap, &fullb)",
              r"for (int j = 0; j < (g < U1_BSTAGES ? HID / 64 : 0); ++j)\1")]),
    ("noA", [(r"mbar_expect_tx\(&fulla\[s\], A_BYTES\);(\s*)tma_load_2d\(",
              r"mbar_expect_tx(&fulla[s], g < AST ? A_BYTES : 0);"
              r"\1if (g < AST) tma_load_2d(")]),
    ("nostore", [(r"if \(r < M\)", "if (r < 0)")]),
    ("nomma", [(r"wgmma_m64n256k16<1>\(acc, desc_sw128\(a \+ 32 \* k, 16, 1024\),"
                r"\s*desc_sw128\(bt \+ 2048 \* k, SLAB, 1024\),\s*"
                r"kc > 0 \|\| k > 0\);", ";")]),
    ("a3", [depth(3, 3)]), ("a4", [depth(4, 3)]), ("a5", [depth(5, 3)]),
    ("a6", [depth(6, 3)]), ("a4b2", [depth(4, 2)]),
)


def build_variants() -> dict:
    """Compile the copies (in parallel) into the git-ignored build tree;
    return each one's ``f3p_build`` entry point."""
    src = (_build.CSRC / "f3p_build.cu").read_text()
    out = _build.build_dir() / "k1_u1_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS:
        text = src
        for pat, rep in subs:
            text, n = re.subn(pat, rep, text)
            if n != 1:
                raise RuntimeError(f"{name}: {pat!r} matched {n} times")
        (out / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fns[name] = ctypes.CDLL(str(out / f"lib{name}.so")).f3p_build
    return fns


def inputs(h: int, w: int, c: int, dc: int, seed: int = 0):
    rng = np.random.default_rng(seed)

    def bf16(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                               * scale, device="cuda").to(torch.bfloat16)

    feat, csa = bf16(1, h, w, c), bf16(1, h, w, dc) if dc else None
    wk0, wvu, wvc = (bf16(c, HID, scale=0.05), bf16(c, HID, scale=0.05),
                     bf16(dc, HID, scale=0.05))
    return feat, csa, wk0, wvu, wvc


def device_ms(fn, key: str | None) -> tuple[float, int]:
    """Median over ROUNDS of the profiler's CUDA time a call of ``fn``'s
    kernels whose name holds ``key`` (None: every kernel), and the
    launches a call."""
    per, count = [], 0
    for _ in range(ROUNDS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and (key is None or key in e.key)]
        n = sum(e.count for e in evs)
        per.append(sum(e.device_time_total for e in evs) / 1e3 / CALLS)
        count = n / CALLS
    return statistics.median(per), count


def lone_ms(fn) -> float:
    ts = []
    for _ in range(20):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def host_us(fn) -> float:
    """Median over ROUNDS of the host's µs a call, CALLS calls enqueued."""
    ts = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(CALLS):
            fn()
        ts.append((time.perf_counter() - t) * 1e6 / CALLS)
        torch.cuda.synchronize()
    return statistics.median(ts)


def entry_point(feat, csa, wk0, wvu, wvc, fn=None):
    """The C entry point (``fn``: a copy's) with its prototype set once, on
    outputs made once: a call is the launcher alone."""
    fn = fn or _build.load("f3p_build").f3p_build
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    b, h, w, c = feat.shape
    dc = 0 if csa is None else csa.shape[-1]
    gk = torch.empty(b, h, w, HID, device="cuda", dtype=torch.bfloat16)
    gv = torch.empty_like(gk)
    args = [t.data_ptr() if t is not None else None
            for t in (feat, csa, wk0, wvu, wvc, gk, gv)]
    stream = torch.cuda.current_stream().cuda_stream
    taps = wk0.shape[0] // c

    def call():
        if fn(*args, b, h, w, c, dc, taps, stream):
            raise RuntimeError("f3p_build: launch failed")
    return call


def host_split(feat, csa, wk0, wvu, wvc) -> dict:
    b, h, w, c = feat.shape
    dc = 0 if csa is None else csa.shape[-1]
    tb = _build.check_tensor

    def checks():
        dk._check_instance(c, dc, None, "f3p_build")
        taps = dk.taps_of(wk0.shape[0], c, "f3p_build")
        dk._check_instance(c, dc, taps, "f3p_build")
        tb(feat, (b, h, w, c), "feature")
        if csa is not None:
            tb(csa, (b, h, w, dc), "csa")
        tb(wk0, (taps * c, HID), "wk0")
        tb(wvu, (taps * c, HID), "wvu")
        tb(wvc, (dc, HID), "wvc")

    def alloc():
        gk = torch.empty(b, h, w, HID, device=feat.device,
                         dtype=torch.bfloat16)
        torch.empty_like(gk)

    raw = torch._C._cuda_getCurrentRawStream
    return {"checks": host_us(checks), "alloc": host_us(alloc),
            "alloc once": host_us(
                lambda: feat.new_empty((2, b, h, w, HID)).unbind(0)),
            "stream": host_us(lambda: _build.stream_ptr(feat.device)),
            "raw stream": host_us(lambda: raw(torch._C._cuda_getDevice()))}


def ablate(smi: str) -> None:
    """Device ms a launch of the kernel and of each copy, in turns."""
    fns = build_variants()
    out = {"card": smi, "cases": {}}
    with torch.inference_mode():
        for name, h, w, c, dc in CASES:
            args = inputs(h, w, c, dc)
            calls = {"kernel": entry_point(*args)}
            calls.update({k: entry_point(*args, fn=f)
                          for k, f in fns.items()})
            ts = {k: [] for k in calls}
            for _ in range(3):
                for k, call in calls.items():
                    ts[k].append(device_ms(call, "f3p")[0])
            row = {k: statistics.median(t) for k, t in ts.items()}
            out["cases"][name] = row
            print(f"ablate {name}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in row.items()) + f" ms [{smi}]",
                flush=True)
    print(json.dumps(out))


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_u1_probe: no CUDA card", file=sys.stderr)
        return 1
    label = sys.argv[1] if len(sys.argv) > 1 else str(ROOT)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    _build.build_all()
    if label == "--ablate":
        ablate(smi)
        return 0
    out = {"label": label, "card": smi, "cases": []}
    with torch.inference_mode():
        for name, h, w, c, dc in CASES:
            feat, csa, wk0, wvu, wvc = inputs(h, w, c, dc)
            x = feat if csa is None else torch.cat([feat, csa], -1)
            w_lib = torch.zeros(c + dc, 2 * HID, device="cuda",
                                dtype=torch.bfloat16)
            w_lib[:c, :HID], w_lib[:c, HID:] = wk0, wvu
            w_lib[c:, HID:] = wvc
            kern = lambda: dk.f3p_build(feat, csa, wk0, wvu, wvc)  # noqa
            lib = lambda: torch.matmul(x, w_lib)  # noqa: E731
            entry = entry_point(feat, csa, wk0, wvu, wvc)
            got, ref = kern(), dk.f3p_build_plain(
                feat.float(), None if csa is None else csa.float(),
                wk0.float(), wvu.float(), wvc.float())
            err = cs.errors(got, ref)[1]
            row = {"name": name, "max_rel_err": err}
            for key, fn, dev_key in (("kernel", kern, "f3p"),
                                     ("library", lib, None)):
                fn()
                dev, n = device_ms(fn, dev_key)
                row[key] = {"device_ms": dev, "launches_a_call": n,
                            "events_ms": cs.time_ms(fn, reps=20),
                            "lone_ms": lone_ms(fn), "host_us": host_us(fn)}
            row["kernel"]["entry_us"] = host_us(entry)
            row["kernel"]["split_us"] = host_split(feat, csa, wk0, wvu, wvc)
            out["cases"].append(row)
            k, lb = row["kernel"], row["library"]
            print(f"{label} {name}: kernel device {k['device_ms']:.4f} ms "
                  f"(x{k['launches_a_call']:g} a call), events "
                  f"{k['events_ms']:.4f}, lone {k['lone_ms']:.4f}, host "
                  f"{k['host_us']:.1f} us (entry point {k['entry_us']:.1f})"
                  f"; library device {lb['device_ms']:.4f} "
                  f"(x{lb['launches_a_call']:g}), events "
                  f"{lb['events_ms']:.4f}, lone {lb['lone_ms']:.4f}, host "
                  f"{lb['host_us']:.1f} us; max rel err {err:.2e} [{smi}]",
                  flush=True)
            print(f"{label} {name}: wrapper parts alone (us): " + ", ".join(
                f"{k} {v:.1f}" for k, v in k["split_us"].items()),
                flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
