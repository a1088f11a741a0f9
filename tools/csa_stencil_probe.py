"""Where the stencil-form CSA kernel
(``ciaosr_torch/csrc/csa_stencil_sm90.cu``, K4 and row 6) spends its
time: times of the kernel against copies of it with one phase of the PV
kernel's key-tile loop removed.

  nop       the normalized attention's exp2 and its stores to shared memory
  nostencil the 9-point stencil's loads and adds (M is zero)
  noscores  the halo scores' wgmma for every key tile after the first
  nopv      the M @ phases wgmma
  nokeys    the key halo's TMA copies after the first tile (the scores
            read tile 0's keys again)
  nophases  the phase planes' TMA copies after the first tile

The copies compute wrong values and serve timing only; the drop in time
against the kernel is what that phase costs on top of the rest (phases
that overlap one another cost less alone than their sum). Runs on one
CUDA card at the geometries of the main path (K4 on the flagship 192^2
tile, row 6 at 192 x 512 and 40 x 1024), on seeded random maps.

    python3 tools/csa_stencil_probe.py

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
object: per geometry, the kernel's ms and each copy's (CUDA events,
median of 5 after one warm call, the kernel and the copies interleaved).
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
from ciaosr_torch.ops.kernels import csa_stencil as st  # noqa: E402

GEOMETRIES = ((192, 192), (192, 512), (40, 1024))
# (name, pattern, replacement) on the kernel's source; a dict replaces
# each match by its entry
VARIANTS = (
    ("nop", r"if \(mine\)", "if (false)"),
    ("nostencil", r"mv\[lx\] \+= src\[lx\];", ";"),
    ("noscores", r"(mbar_wait\(kbar, \(j \+ 1\) & 1\);)\s*issue_scores\(\);",
     r"\1"),
    ("nopv", r"wgmma_m64n128k16<1>\(acc,[^;]*;", ";"),
    ("nokeys", r"mbar_wait\(kbar, \(j \+ 1\) & 1\);|"
     r"if \(tid == 0 && j \+ 2 < nt\)|if \(tid == 0 && nt > 1\)",
     {"mbar_wait(kbar, (j + 1) & 1);": "",
      "if (tid == 0 && j + 2 < nt)": "if (false)",
      "if (tid == 0 && nt > 1)": "if (false)"}),
    ("nophases", r"mbar_wait\(pbar, j & 1\);|if \(tid == 0 && j \+ 1 < nt\)"
     r"(?=\s*load_phases)",
     {"mbar_wait(pbar, j & 1);": "if (j == 0) mbar_wait(pbar, 0);",
      "if (tid == 0 && j + 1 < nt)": "if (false)"}),
)


def build_variants() -> dict:
    """Compile the copies (in parallel) into the git-ignored build tree;
    return each one's ``csa_stencil_sm90`` entry point."""
    src = (_build.CSRC / "csa_stencil_sm90.cu").read_text()
    out = _build.build_dir() / "csa_stencil_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, pat, rep in VARIANTS:
        if isinstance(rep, dict):
            rep = (lambda d: lambda m: d[m.group(0)])(rep)
        text, n = re.subn(pat, rep, src, flags=re.S)
        if n < 1:
            raise RuntimeError(f"{name}: pattern not found in the kernel")
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
        fns[name] = ctypes.CDLL(str(out / f"lib{name}.so")).csa_stencil_sm90
    return fns


def launch(fn, match, keys, embed):
    """Call a copy with the arguments ``st.launch_stencil_sm90`` passes."""
    b, hp, wp, _ = match.shape
    m_buf = torch.empty(b, hp * wp, device="cuda")
    l_buf = torch.empty_like(m_buf)
    out = torch.empty(b, 2 * hp, 2 * wp, st.C, device="cuda")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    _build.check(fn(*(_build.ptr(t) for t in (match, keys, embed, m_buf,
                                              l_buf, out)),
                    b, hp, wp, 10.0, _build.stream_ptr(match.device)),
                 "probe copy")
    return out


def once_ms(call) -> float:
    a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    call()
    e.record()
    e.synchronize()
    return a.elapsed_time(e)


def main() -> int:
    if not torch.cuda.is_available():
        print("csa_stencil_probe: needs a CUDA card", file=sys.stderr)
        return 1
    _build.build_all()
    fns = build_variants()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    with torch.inference_mode():
        for hp, wp in GEOMETRIES:
            match = torch.randn(1, hp, wp, st.CR, device="cuda",
                                generator=g).bfloat16()
            keys = torch.nn.functional.normalize(torch.randn(
                1, hp * wp // 4, 9 * st.CR, device="cuda", generator=g),
                dim=-1).bfloat16()
            embed = torch.randn(1, hp, wp, st.C, device="cuda",
                                generator=g).bfloat16()
            calls = {"kernel": lambda: st.csa_stencil_fused(
                match, keys, embed, 10.0, 2)}
            for name, fn in fns.items():
                calls[name] = (lambda f: lambda: launch(f, match, keys,
                                                        embed))(fn)
            for call in calls.values():
                call()
            torch.cuda.synchronize()
            ts = {name: [] for name in calls}
            for _ in range(5):
                for name, call in calls.items():
                    ts[name].append(once_ms(call))
            result[f"{hp}x{wp}"] = {name: statistics.median(t)
                                    for name, t in ts.items()}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
