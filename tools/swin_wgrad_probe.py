"""Row 12's weight-gradient kernel (``swin_wgrad_sm90`` in ``ciaosr_torch/
csrc/swin_block_bwd_sm90.cu``) and its sum kernel (``swin_gsum_kernel``) at
several token-chunk counts: the measurement behind ``WGRAD_SPLITS``.

On seeded bf16 pairs at the 002 training batch's T = 24576 tokens (384
windows of NT = 64) and seeded window partials (6 heads, 64 tokens a
window), for each chunk count: the weight-gradient kernel alone, the sum
kernel on its partials, and the two in turn; beside them four
``torch.matmul(a.t(), b)`` calls on the same pairs (the library
yardstick, which the port never calls). One CUDA card, under a minute:

    python3 tools/swin_wgrad_probe.py

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
object of ms: ``events`` (CUDA events, median of 7 samples of 10 calls
after warm-up; a call's host dispatch, overlapped with the device's work,
shows where it is the longer), ``device`` (torch.profiler over 10 calls,
after 10 with the profiler warming up: a call's device kernels' time a
launch, the total over the launches seen, as a profiler can miss a
call's launches) and ``launches`` (the launches seen; a call of each
kernel is one launch, four ``torch.matmul`` are several).
``WGRAD_SPLITS`` is set to each count in turn for its calls.
"""

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ciaosr_torch.ops.kernels import _build  # noqa: E402
from ciaosr_torch.ops.kernels import swin_block as sb  # noqa: E402

T, HEADS = 24576, 6
SPLITS = (8, 12, 16, 24, 32)


def sample_ms(fn, n: int = 10) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def with_splits(s: int):
    """sb.swin_block_wgrad(pairs) at s token chunks."""
    def call(pairs):
        sb.WGRAD_SPLITS = s
        return sb.swin_block_wgrad(pairs)
    return call


def device_ms(fn, n: int = 10) -> tuple[float, int]:
    """(device ms a launch, launches seen) over n calls of fn, profiled
    after n calls with the profiler warming up."""
    seen = {}
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: seen.update(
                     evs=p.key_averages())) as prof:
        for _ in range(2):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            prof.step()
    evs = [e for e in seen["evs"] if e.device_type == DeviceType.CUDA]
    launches = sum(e.count for e in evs)
    return (sum(e.device_time_total for e in evs) / max(launches, 1) / 1e3,
            launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("swin_wgrad_probe: needs a CUDA card", file=sys.stderr)
        return 1
    _build.build_all()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    pairs = [torch.randn(T, width, device="cuda", generator=g).to(
        torch.bfloat16) for _, width in sb._PAIRS]
    lw = sum(size for _, size in sb._VECTORS) + HEADS * sb.NT * sb.NT
    wpart = torch.randn(T // sb.NT, lw, device="cuda", generator=g)
    gsum = _build.load("swin_block_bwd_sm90").swin_block_gsum
    gsum.restype = ctypes.c_int
    gsum.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_void_p]
    stream = _build.stream_ptr(pairs[0].device)
    calls = {"4 x torch.matmul": lambda: [
        torch.matmul(a.t(), b) for a, b in zip(pairs[0::2], pairs[1::2])]}
    for s in SPLITS:
        wgrad = with_splits(s)
        part = wgrad(pairs)
        ns, ld = part.shape
        flat = torch.empty(lw + ld, device="cuda")

        def sum_call(part=part, ns=ns, ld=ld, flat=flat):
            err = gsum(_build.ptr(wpart), wpart.shape[0], lw,
                       _build.ptr(part), ns, ld, _build.ptr(flat), stream)
            _build.check(err, "swin_block_gsum")

        calls[f"wgrad@{s}"] = lambda wgrad=wgrad: wgrad(pairs)
        calls[f"gsum@{s}"] = sum_call
        calls[f"wgrad+gsum@{s}"] = (
            lambda wgrad=wgrad, sum_call=sum_call: (wgrad(pairs), sum_call()))
    for call in calls.values():
        call()
    torch.cuda.synchronize()
    ts = {name: [] for name in calls}
    for _ in range(7):
        for name, call in calls.items():
            ts[name].append(sample_ms(call))
    device, launches = {}, {}
    for name, call in calls.items():
        if "+" not in name:
            device[name], launches[name] = device_ms(call)
    sb.WGRAD_SPLITS = SPLITS[0]
    print(json.dumps({"events": {name: statistics.median(t)
                                 for name, t in ts.items()},
                      "device": device, "launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
