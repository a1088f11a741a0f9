"""Where the 002 GAN step's time goes on one CUDA card, with cuDNN's
heuristic convolution algorithms, with its benchmarked ones and with the
SwinIR convs fed an NCHW-contiguous map: the shipped 002 gan model
(``chip_smoke.py``'s phase "gan": f32 params, the kernel route, TF32
off, synthetic VGG19) at the 002 batch. The SwinIR encoder hands its
convs a permuted (B, H, W, C) map, which is channels-last in memory.
For ``torch.backends.cudnn.benchmark`` False, then True, then False with
the convs' input made NCHW-contiguous (``models.swinir.conv`` wrapped in
this process only): the median CUDA-event
time of the GAN step and of the generator alone (the L1 forward and
backward) over the last STEPS - WARM of STEPS seeded batches, and in one
profiled generator forward and backward the device time of cuDNN's FFT
convolution kernels (names with "fft" or a complex "cf32" GEMM) beside
the total, and the operators whose kernels take the most device time.

    python3 tools/gan_step_probe.py
"""

import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
# the repository root in place of tools/ (whose profile.py would shadow the
# standard library's, which torch imports)
sys.path[0] = str(ROOT)

import chip_smoke as cs  # noqa: E402

STEPS, WARM = 8, 3


def timed(fn) -> float:
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def fft_share(res, bt, top: int = 6) -> tuple[float, float, str]:
    """(device ms of FFT-convolution kernels, device ms of all kernels,
    the ``top`` operators by the device time of the kernels they launch,
    with their input shapes) in one generator forward and backward, after
    one warm-up. The two sums come from a profile of CUDA kernels alone,
    each counted once; the operators from a second one with the CPU's
    operators and their shapes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def profiled(activities, by_shape=False):
        # the events are read in the trace handler: the profiler clears
        # them when its cycle ends
        seen = {}
        with profile(activities=activities, record_shapes=by_shape,
                     on_trace_ready=lambda p: seen.update(evs=p.key_averages(
                         group_by_input_shape=by_shape)),
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            for _ in range(2):
                res.train_forward(bt["lq"], bt["gt"], bt["coord"],
                                  bt["cell"])[0].backward()
                torch.cuda.synchronize()
                prof.step()
        return seen["evs"]

    kernels = [e for e in profiled([ProfilerActivity.CUDA])
               if e.device_type == DeviceType.CUDA]
    fft = sum(e.device_time_total for e in kernels
              if "fft" in e.key.lower() or "cf32" in e.key) / 1e3
    total = sum(e.device_time_total for e in kernels) / 1e3
    ops = profiled([ProfilerActivity.CPU, ProfilerActivity.CUDA], True)
    ops = sorted((e for e in ops if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::")),
                 key=lambda e: -e.self_device_time_total)[:top]
    names = "; ".join(f"{e.key} {e.input_shapes} "
                      f"{e.self_device_time_total / 1e3:.1f} ms x{e.count}"
                      for e in ops)
    return fft, total, names


def main() -> int:
    if not torch.cuda.is_available():
        print("gan_step_probe: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    os.environ["CIAOSR_VGG19_SYNTHETIC"] = "1"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cs.Config.fromfile(cs.config_path("002_real_gan_"))
    res = cs.gan_restorer(cfg)
    state, step = cs.gan_optimizers(res, cfg)
    rng = np.random.default_rng(7)
    batches = [cs.gan_batch(rng, cs.TRAIN_B, cs.TRAIN_LR, cs.TRAIN_QSIDE)
               for _ in range(STEPS)]
    import ciaosr_torch.models.swinir as swinir

    conv = swinir.conv
    for bench, nchw in ((False, False), (True, False), (False, True)):
        torch.backends.cudnn.benchmark = bench
        swinir.conv = (lambda x, *a, **k: conv(x.contiguous(), *a, **k)) \
            if nchw else conv
        gan, gen = [], []
        for bt in batches:
            gan.append(timed(lambda: step(state, bt)))
        for bt in batches:
            state.g_opt.zero_grad(set_to_none=True)
            gen.append(timed(lambda: res.train_forward(
                bt["lq"], bt["gt"], bt["coord"], bt["cell"])[0].backward()))
        fft, total, names = fft_share(res, batches[0])
        print(f"cudnn.benchmark={bench}, conv input "
              f"{'NCHW-contiguous' if nchw else 'channels-last'} ({smi}): "
              f"GAN step "
              f"{statistics.median(gan[WARM:]):.1f} ms (first "
              f"{gan[0]:.1f}), generator alone (L1 forward + backward) "
              f"{statistics.median(gen[WARM:]):.1f} ms; profiled generator "
              f"forward + backward: device {total:.1f} ms, of which cuDNN "
              f"FFT convolution kernels {fft:.1f} ms; operators by their "
              f"kernels' device time: {names}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
