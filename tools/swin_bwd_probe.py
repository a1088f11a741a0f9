"""Where row 12's window kernel (``swin_bwd_sm90`` in ``ciaosr_torch/csrc/
swin_block_bwd_sm90.cu``) spends its time: times of the kernel against
copies of it with one phase removed.

  nopass1mm  pass 1's products ([q|k|v], S, P @ v, the projection)
  nomlpmm    pass 2's products (z, dh, dyn)
  nodo       the do = dx1 @ wp^T product
  noattnmm   pass 3's attention products (S, dP, dv, dq, dk)
  nodxn      pass 3's dxn product
  nocolsum   the column sums of the vector partials
  nopairs    the stores of the bf16 pairs (pass 3 then reads q, k, v
             from whatever the dqkv pair held)
  nobiaspart the stores of the bias-table partial
  nocolbar   colsum's two barriers (its shuffles and sums stay)
  nobars     every warpgroup barrier
  nomaploads the f32 loads of x, dy, x1 and dx1 (pass 1 and both LN')
  nomapstores the f32 stores of x1, dx1 and dx
  noqkvscratch pass 1's q, k, v stores into the dqkv pair
  nohdz      the hdn and dz1 stores
  nohalfout  the o, dq, dk and dv stores
  nogelu     GELU and its derivative (z passes through)

The copies compute wrong values and serve timing only; the drop in time
against the kernel is what that phase costs on top of the rest (phases
that overlap one another cost less alone than their sum). Only the window
kernel is launched (not the weight-gradient and sum kernels). Runs on one
CUDA card at the 002 training batch's token map (6 x 64 x 64, C = 180, 6
heads, hidden 360), shifted and not, seeded random weights and maps.

    python3 tools/swin_bwd_probe.py

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

SHAPES = (((6, 64, 64), 4), ((6, 64, 64), 0))
OFF = r"if (false) \g<0>"
# (name, [(pattern, replacement), ...]) on the kernel's source
VARIANTS = (
    ("nopass1mm", [(r"wgmma_m64n96k16<0>\([^;]*;", ";"),
                   (r"wgmma_m64n64k16_rs<0>\(sc[^;]*;", ";"),
                   (r"wgmma_m64n32k16_rs<0>\(o[^;]*;", ";"),
                   (r"wgmma_m64n192k16_rs<1>\(x1[^;]*;", ";")]),
    ("nomlpmm", [(r"wgmma_m64n64k16<1>\(z[^;]*;", ";"),
                 (r"wgmma_m64n64k16<0>\(dh[^;]*;", ";"),
                 (r"wgmma_m64n192k16_rs<0>\(dyn[^;]*;", ";")]),
    ("nodo", [(r"wgmma_m64n192k16_rs<0>\(dof[^;]*;", ";")]),
    ("noattnmm", [(r"wgmma_m64n64k16<0>\((sc|dp)[^;]*;", ";"),
                  (r"wgmma_m64n64k16<1, [01]>\([^;]*;", ";")]),
    ("nodxn", [(r"wgmma_m64n64k16_rs<1>\(dxn[^;]*;", ";")]),
    ("nocolsum", [(r"constexpr int N = 2 \* G;", "return;\n  constexpr int N = 2 * G;"),
                  (r"(const int t = threadIdx\.x & 127;\n)(  bar_sync)",
                   r"\1  return;\n\2")]),
    ("nopairs", [(r"__stcs\(reinterpret_cast<(unsigned int|uint4)\*>\(p\), v\);",
                  ";"),
                 (r"\*reinterpret_cast<(uint32_t|__nv_bfloat162)\*>\(dst( \+ "
                  r"2?\s?\*?\s?CP)?\) = (qv|kv|v2);", OFF)]),
    ("nobiaspart", [(r"if \(rows\[h\] >= n \|\| c >= n\) continue;",
                     "continue;")]),
    ("nocolbar", [(r"(const int t = threadIdx\.x & 127;\n)  bar_sync\(bar, 128\);",
                   r"\1"),
                  (r"(rd\[3 \* CP \+ col\]\);\n)  bar_sync\(bar, 128\);",
                   r"\1")]),
    ("nobars", [(r"bar_sync\(bar, 128\);", ";")]),
    ("nomaploads", [(r"if \(tok < 0\) return v;", "return v;")]),
    ("nomapstores", [(r"if \(tok < 0\) return;", "return;")]),
    ("noqkvscratch", [(r"\*reinterpret_cast<(uint32_t|__nv_bfloat162)\*>"
                       r"\(dst( \+ 2?\s?\*?\s?CP)?\) = (qv|kv|v2);", OFF)]),
    ("nohdz", [(r"st_cs\(P\.(hdn|dz1) \+ at", OFF)]),
    ("nohalfout", [(r"st_cs\(dst \+ \(size_t\)row \* ld", OFF)]),
    ("nogelu", [(r"const float phi = 0\.5f \* \(1\.f \+ erff\([^;]*;",
                 "const float phi = z;"),
                (r"d = phi \+ z \* 0\.3989422804014327f[^;]*;", "d = phi;")]),
)


def build_variants() -> dict:
    """Compile the copies (in parallel) into the git-ignored build tree;
    return each one's ``swin_block_bwd`` entry point."""
    src = (_build.CSRC / "swin_block_bwd_sm90.cu").read_text()
    out = _build.build_dir() / "swin_bwd_probe"
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
        fns[name] = ctypes.CDLL(str(out / f"lib{name}.so")).swin_block_bwd
    return fns


def window_call(fn, x, dy, pk, ws, shift):
    """A closure that launches a copy's window kernel with the arguments
    ``sb.swin_block_bwd`` passes it (outputs allocated once)."""
    b, h, w, c = x.shape
    heads, n = pk["bias"].shape[0], ws * ws
    nwin = b * (h // ws) * (w // ws)
    lw = sum(size for _, size in sb._VECTORS) + heads * n * n
    dx = torch.empty_like(x)
    pairs = [torch.empty(nwin * sb.NT, width, device=x.device,
                         dtype=torch.bfloat16) for _, width in sb._PAIRS]
    part = torch.empty(nwin, lw, device=x.device)
    args = [x, dy, *(pk[k] for k in sb._FWD_TENSORS), dx, *pairs, part]
    ptrs = (ctypes.c_void_p * len(args))(*(t.data_ptr() for t in args))
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    stream = _build.stream_ptr(x.device)

    def call():
        _build.check(fn(ctypes.cast(ptrs, ctypes.c_void_p), b, h, w, c,
                        heads, ws, shift, float(c // heads) ** -0.5, stream),
                     "probe copy")
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
        print("swin_bwd_probe: needs a CUDA card", file=sys.stderr)
        return 1
    _build.build_all()
    fns = build_variants()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    torch.manual_seed(0)
    g = torch.Generator(device="cuda").manual_seed(0)
    kernel = _build.load("swin_block_bwd_sm90").swin_block_bwd
    result = {}
    for shape, shift in SHAPES:
        blk = SwinBlock(180, 6, 8, shift).cuda()
        with torch.no_grad():
            for p in blk.parameters():
                p.normal_(std=0.05 if p.dim() == 2 else 0.5)
        pk = blk.packed(8, torch.bfloat16)
        x, dy = (torch.randn(*shape, 180, device="cuda", generator=g)
                 for _ in range(2))
        calls = {"kernel": window_call(kernel, x, dy, pk, 8, shift)}
        for name, fn in fns.items():
            calls[name] = window_call(fn, x, dy, pk, 8, shift)
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
