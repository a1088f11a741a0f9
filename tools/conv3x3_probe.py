"""The f32 3×3 conv kernel (csrc/conv3x3_f32_sm90.cu) on one CUDA card,
against cuDNN's ``F.conv2d`` in f32 with TF32 off, at the SwinIR trunk's
square convs: the 002 training batch (6 × 64² × 180) and 001 swinir's
(10 × 48² × 180). For each: ptxas's report of the kernel (registers,
spills), the largest error of the kernel and of cuDNN against float64
(relative to the largest output), the same bits on two launches, the
wrapper's time (CUDA events over ``CALLS`` calls back to back, median of
``ROUNDS`` after warm-up; it includes the weight's re-layout), each one's
device time by kernel name (profiler), the bound (2·9·Cin·Cout·B·H·W FLOP
at the f32 peak of 67 TFLOP/s) and the kernel's share of it.

    python3 tools/conv3x3_probe.py
"""

import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
# the repository root in place of tools/ (whose profile.py would shadow the
# standard library's, which torch imports)
sys.path[0] = str(ROOT)

from ciaosr_torch.ops.kernels import _build  # noqa: E402
from ciaosr_torch.ops.kernels import conv3x3 as c3  # noqa: E402

SHAPES = ((6, 64, 64, 180), (10, 48, 48, 180))
PEAK_F32 = 67e12
CALLS, ROUNDS = 20, 5


def events_ms(fn) -> float:
    """Median over ROUNDS of CALLS calls back to back, ms a call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(ROUNDS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(CALLS):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / CALLS)
    return statistics.median(out)


def device_ms(fn) -> dict:
    """Device ms a call of each kernel ``fn`` launches (profiler, CALLS
    calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: round(e.device_time_total / 1e3 / CALLS, 4)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def main() -> int:
    if not torch.cuda.is_available():
        print("conv3x3_probe: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {smi}; build {_build.build_all():.1f} s", flush=True)
    log = (_build.build_dir() / "conv3x3_f32_sm90.log").read_text()
    print("ptxas:", " | ".join(ln.strip() for ln in log.splitlines()
                               if "conv3x3" in ln or "registers" in ln
                               or "spill" in ln), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    for b, h, w, c in SHAPES:
        x = torch.randn(b, h, w, c, device="cuda", generator=g)
        wt = (torch.rand(c, c, 3, 3, device="cuda", generator=g) * 2 - 1) \
            / (9 * c) ** 0.5
        bias = (torch.rand(c, device="cuda", generator=g) * 2 - 1) \
            / (9 * c) ** 0.5
        xv = x.permute(0, 3, 1, 2)
        got = c3.conv3x3(x, wt, bias)
        lib = F.conv2d(xv, wt, bias, padding=1).permute(0, 2, 3, 1)
        ref = F.conv2d(xv.double(), wt.double(), bias.double(),
                       padding=1).permute(0, 2, 3, 1)
        scale = float(ref.abs().max())
        flop = 2 * 9 * c * c * b * h * w
        kernel_ms = events_ms(lambda: c3.conv3x3(x, wt, bias))
        lib_ms = events_ms(lambda: F.conv2d(xv, wt, bias, padding=1))
        dev = device_ms(lambda: c3.conv3x3(x, wt, bias))
        conv_dev = sum(v for k, v in dev.items() if "conv3x3" in k)
        row = {
            "shape": f"{b}x{h}x{w}x{c}", "card": smi,
            "kernel_ms": round(kernel_ms, 4),
            "kernel_device_ms": round(conv_dev, 4),
            "wrapper_kernels": dev,
            "library_ms": round(lib_ms, 4),
            "library_kernels": device_ms(
                lambda: F.conv2d(xv, wt, bias, padding=1)),
            "bound_ms": round(flop / PEAK_F32 * 1e3, 4),
            "tflops": round(flop / conv_dev / 1e9, 2),
            "peak_share": round(flop / PEAK_F32 * 1e3 / conv_dev, 4),
            "err_kernel_vs_f64": float((got.double() - ref).abs().max())
            / scale,
            "err_cudnn_vs_f64": float((lib.double() - ref).abs().max())
            / scale,
            "kernel_vs_cudnn": float((got - lib).abs().max()) / scale,
            "same_bits": all(torch.equal(c3.conv3x3(x, wt, bias), got)
                             for _ in range(3)),
        }
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
