"""Where K2 (``wt_sm90`` in ``ciaosr_torch/csrc/wt_hoist_sm90.cu``) spends
its time: times of the kernel against copies of it with one phase
removed, at the main path's shapes.

  noform     the A operand's formation: the window loads (ldmatrix) and
             the bf16 products (A is a constant)
  nommas     the products (wgmma), wt's and ck's
  nowstream  the weight stream (the producer's W_kout loads; the products
             read whatever the ring holds)
  nowindow   the feature window loads (TMA)
  nostore    the wt stores (TMA; the staging writes stay)
  nockmma    ck's product (m64n8k16)

The copies compute wrong values and serve timing only; the drop in time
against the kernel is what that phase costs on top of the rest (phases
that overlap one another cost less alone than their sum). No copy drops
the staging writes: ptxas then drops the products whose accumulators are
never read, and the copy measures less than the products. Beside them,
one ``torch.matmul`` of a pre-built qk (9·M × DK, bf16) by W_kout: the
product alone, as a yardstick (no single PyTorch call computes K2, which
also forms qk, its nine shifts and ck). Seeded bf16 maps and weights at
the flagship's 192² tile (C = 64), SwinIR-CiaoSR 002's 256² tile and
config 001 swinir's 192² tile (C = 180 zero-padded to 192) and the
one-tap instance's 192² tile (C = 64, ``feat_unfold=False``). One CUDA
card, about a minute:

    python3 tools/wt_hoist_probe.py

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
object: per shape, the kernel's ms and each copy's (CUDA events, median
of 7 samples of 10 calls after warm-up, the kernel and the copies
interleaved), the yardstick's, and the kernel's bound (max of the
function's FLOPs at the real width over 989 TFLOP/s and its bytes over
3.35 TB/s).
"""

import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ciaosr_torch.ops.kernels import _build  # noqa: E402

HID = 256
# name: (B, H, W, C padded, C real, taps)
SHAPES = {"flagship 192x192": (1, 192, 192, 64, 64, 9),
          "SwinIR 002 256x256": (1, 256, 256, 192, 180, 9),
          "001 swinir 192x192": (1, 192, 192, 192, 180, 9),
          "one tap 192x192": (1, 192, 192, 64, 64, 1)}
ONE = r"\1[0] = \1[1] = \1[2] = \1[3] = 0x3f803f80u;"
# (name, [(pattern, replacement), ...]) on the kernel's source
VARIANTS = (
    ("noform", [(r"ldsm_x4\((q|k), [^;]*;", ONE)]),
    ("nommas", [(r"wgmma_m64n256k16_rs<1>\([^;]*;", ";"),
                (r"wgmma_m64n8k16_rs\([^;]*;", ";")]),
    ("nowstream", [(r"mbar_expect_tx\(&full\[s\], B_BYTES\);",
                    "mbar_arrive(&full[s]);"),
                   (r"tma_load_2d\(bt \+ j \* SLAB[^;]*;", ";")]),
    ("nowindow", [(r"mbar_expect_tx\(&wfull\[wb\], WIN_BYTES\);",
                   "mbar_arrive(&wfull[wb]);"),
                  (r"tma_load_4d\(smem \+ WIN_OFF[^;]*;", ";")]),
    ("nostore", [(r"tma_store_4d\(tm_out[^;]*;", ";")]),
    ("nockmma", [(r"wgmma_m64n8k16_rs\([^;]*;", ";")]),
)


def build_variants() -> dict:
    """Compile the copies (in parallel) into the git-ignored build tree;
    return each one's ``wt_hoist`` entry point."""
    src = (_build.CSRC / "wt_hoist_sm90.cu").read_text()
    out = _build.build_dir() / "wt_hoist_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS:
        text = src
        for pat, rep in subs:
            text, n = re.subn(pat, rep, text)
            if n < 1:
                raise RuntimeError(f"{name}: {pat!r} not found in the kernel")
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
        fns[name] = ctypes.CDLL(str(out / f"lib{name}.so")).wt_hoist
    return fns


def kernel_call(fn, feat, wk, bk, taps):
    """A closure that launches ``fn`` (the kernel or a copy) as
    ``decoder.wt_hoist`` does (outputs allocated once)."""
    b, h, w, c = feat.shape
    wt = torch.empty(9, b, h, w, HID, device="cuda", dtype=torch.bfloat16)
    ck = torch.empty(9, b, h, w, device="cuda")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    args = [_build.ptr(t) for t in (feat, wk, bk, wt, ck)]
    stream = _build.stream_ptr(feat.device)

    def call():
        _build.check(fn(*args, b, h, w, c, taps, stream), "probe copy")
    return call


def sample_ms(call, n: int = 10) -> float:
    a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        call()
    e.record()
    e.synchronize()
    return a.elapsed_time(e) / n


def main() -> int:
    if not torch.cuda.is_available():
        print("wt_hoist_probe: needs a CUDA card", file=sys.stderr)
        return 1
    _build.build_all()
    fns = build_variants()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    kernel = _build.load("wt_hoist_sm90").wt_hoist
    result = {}
    for name, (b, h, w, c, real, taps) in SHAPES.items():
        feat = torch.randn(b, h, w, c, device="cuda", generator=g).to(
            torch.bfloat16)
        feat[..., real:] = 0
        wk = (torch.randn(taps, c, HID, device="cuda", generator=g)
              * 0.05).to(torch.bfloat16)
        wk[:, real:] = 0
        wk = wk.reshape(taps * c, HID).contiguous()
        bk = torch.randn(taps * c, device="cuda", generator=g).to(
            torch.bfloat16).float()
        m = b * h * w
        qk = torch.randn(9 * m, taps * c, device="cuda", generator=g).to(
            torch.bfloat16)
        calls = {"kernel": kernel_call(kernel, feat, wk, bk, taps)}
        for vname, fn in fns.items():
            calls[vname] = kernel_call(fn, feat, wk, bk, taps)
        calls["torch.matmul(qk, W_kout)"] = (
            lambda qk=qk, wk=wk: torch.matmul(qk, wk))
        for call in calls.values():
            call()
        torch.cuda.synchronize()
        ts = {k: [] for k in calls}
        for _ in range(7):
            for k, call in calls.items():
                ts[k].append(sample_ms(call))
        dk_ = taps * real
        flops = 2 * 9 * m * dk_ * (HID + 1)
        nbytes = (m * real * 2 + dk_ * HID * 2 + dk_ * 4
                  + 9 * m * (HID * 2 + 4))
        result[name] = {k: statistics.median(t) for k, t in ts.items()}
        result[name]["bound_ms"] = max(flops / 989e12, nbytes / 3.35e12) * 1e3
        del feat, wk, bk, qk, calls
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
