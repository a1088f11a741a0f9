"""Where the Hopper Swin block kernel (``ciaosr_torch/csrc/
swin_block_sm90.cu``, row 11) spends its time: times of the kernel
against copies of it with one phase removed.

  noxload   the x loads (x1 starts at 0)
  noln      both LayerNorms (xn keeps what it held)
  noqkv     the [q | k | v] products (the ring is still consumed)
  nosoftmax the relative bias, the mask and the exponentials
  nospv     the score and P @ v products
  nowp      the output projection's products
  nomlp     the MLP's products
  nogelu    the GELU (z passes through)
  nostore   the y stores

The copies compute wrong values and serve timing only; the drop in time
against the kernel is what that phase costs on top of the rest (phases
that overlap one another cost less alone than their sum). Runs on one
CUDA card at the main path's shapes (the SwinIR 256^2 tile's tokens,
shifted and not, and the 002 training batch's 6 x 64 x 64), C = 180,
6 heads, hidden 360, seeded random weights and maps.

    python3 tools/swin_block_probe.py

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
object: per shape, the kernel's ms and each copy's (CUDA events, median of
7 samples of 10 calls after warm-up, the kernel and the copies
interleaved).
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

from ciaosr_torch.models.swinir import SwinBlock  # noqa: E402
from ciaosr_torch.ops.kernels import _build  # noqa: E402
from ciaosr_torch.ops.kernels import swin_block as sb  # noqa: E402

SHAPES = (((1, 256, 256), 4), ((1, 256, 256), 0), ((6, 64, 64), 4))
# (name, [(pattern, replacement), ...]) on the kernel's source
VARIANTS = (
    ("noxload", [(r"const float\* src = P\.x \+ tok \+ 2 \* q4;",
                  "continue;\n    const float* src = P.x;")]),
    ("noln", [(r"layer_norm\(x1, V \+ V_G[12], V \+ V_B[12], C, xn\);",
               ";")]),
    ("noqkv", [(r"wgmma_m64n96k16<0>\([^;]*;", ";")]),
    ("nosoftmax", [(r"sc\[4 \* j \+ k\] \+= bt\[[^;]*;", ";"),
                   (r"if \(masked\) \{", "if (false) {"),
                   (r"__expf\(l - mx\[h\]\)", "(l - mx[h])")]),
    ("nospv", [(r"wgmma_m64n(64|32)k16_rs<0>\([^;]*;", ";")]),
    ("nowp", [(r"wgmma_m64n192k16_rs<1>\(x1, of\[k\][^;]*;", ";")]),
    ("nomlp", [(r"wgmma_m64n64k16<1>\([^;]*;", ";"),
               (r"wgmma_m64n192k16_rs<1>\(x1, gf\[k\][^;]*;", ";")]),
    ("nogelu", [(r"return 0\.5f \* z \* \(1\.f \+ erff\([^;]*;",
                 "return z;")]),
    ("nostore", [(r"float\* dst = P\.out \+ tok \+ 2 \* q4;",
                  "continue;\n    float* dst = P.out;")]),
)


def build_variants() -> dict:
    """Compile the copies (in parallel) into the git-ignored build tree;
    return each one's ``swin_block`` entry point."""
    src = (_build.CSRC / "swin_block_sm90.cu").read_text()
    out = _build.build_dir() / "swin_block_probe"
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
        fns[name] = ctypes.CDLL(str(out / f"lib{name}.so")).swin_block
    return fns


def launch(fn, x, pk, ws, shift, max_ctas):
    """Call a copy with the arguments ``sb.launch_swin_block`` passes."""
    b, h, w, c = x.shape
    heads = pk["bias"].shape[0]
    out = torch.empty_like(x)
    args = [x, *(pk[k] for k in sb._FWD_TENSORS), out]
    ptrs = (ctypes.c_void_p * len(args))(*(t.data_ptr() for t in args))
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    _build.check(fn(ctypes.cast(ptrs, ctypes.c_void_p), b, h, w, c, heads,
                    ws, shift, float(c // heads) ** -0.5, max_ctas,
                    _build.stream_ptr(x.device)), "probe copy")
    return out


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
        print("swin_block_probe: needs a CUDA card", file=sys.stderr)
        return 1
    _build.build_all()
    fns = build_variants()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    torch.manual_seed(0)
    g = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result = {}
    for shape, shift in SHAPES:
        blk = SwinBlock(180, 6, 8, shift).cuda()
        with torch.no_grad():
            for p in blk.parameters():
                p.normal_(std=0.05 if p.dim() == 2 else 0.5)
        pk = blk.packed(8, torch.bfloat16)
        with torch.inference_mode():
            x = torch.randn(*shape, 180, device="cuda", generator=g)
            calls = {"kernel": lambda: sb.swin_block(x, pk, 8, shift),
                     "one CTA a pair": lambda: sb.launch_swin_block(
                         x, pk, 8, shift, 0)}
            for name, fn in fns.items():
                calls[name] = (lambda f: lambda: launch(
                    f, x, pk, 8, shift, sms))(fn)
            for call in calls.values():
                call()
            torch.cuda.synchronize()
            ts = {name: [] for name in calls}
            for _ in range(7):
                for name, call in calls.items():
                    ts[name].append(sample_ms(call))
        result["{}x{}x{} shift {}".format(*shape, shift)] = {
            name: statistics.median(t) for name, t in ts.items()}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
