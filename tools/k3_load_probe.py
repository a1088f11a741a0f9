"""Where K3's integer kernel (``ciaosr_torch/csrc/grid_decode_sm90.cu``)
spends the time that its tensor cores do not: times of the kernel against
copies of it with one class of global loads replaced by a constant.

  nox   the value modulation's gathers of the feature (u's 3x3 taps) and
        of csa, by 1.0
  nog   the first layers' loads of g_k and g_v, by a constant row
  nowt  the logit's loads of the wt planes, by 1.0

The copies compute wrong values and serve timing only; the drop in time
against the kernel is what those loads cost on top of the rest. Runs on
one CUDA card, at the three shapes of the main paths: the flagship decoder
(C = 64 with CSA) on a 192^2 map at x4, the same without the unfold (the
one-tap instance of feat_unfold=False: u is the feature, the gathers one
pixel) and SwinIR-CiaoSR's (C = 180, padded to 192) on a 256^2 map at
x4, on seeded random maps and weights.

    python3 tools/k3_load_probe.py

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
object: per shape, the kernel's ms and each copy's (CUDA events, median
of 5 after one warm call, the kernel and the copies interleaved).
"""

import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ciaosr_torch.models.builder import build_generator  # noqa: E402
from ciaosr_torch.ops.kernels import _build  # noqa: E402
from ciaosr_torch.ops.kernels import decoder as dk  # noqa: E402

IMNET = dict(type="MLPRefiner", hidden_list=[256] * 4)
FLAGSHIP = dict(
    type="LocalImplicitSRRDN",
    encoder=dict(type="RDN", in_channels=3, mid_channels=64, num_blocks=2,
                 num_layers=2, channel_growth=64),
    imnet_q=dict(IMNET, out_dim=3), imnet_k=dict(IMNET, out_dim=64),
    imnet_v=dict(IMNET, out_dim=64), dtype="bf16", use_kernels=True)
FLAGSHIP_U1 = dict(FLAGSHIP, feat_unfold=False)
SWINIR = dict(
    type="LocalImplicitSRSWINIR", window_size=8,
    encoder=dict(type="SwinIR", embed_dim=180, depths=[2], num_heads=[6]),
    imnet_q=dict(IMNET, out_dim=3), imnet_k=dict(IMNET, out_dim=64),
    imnet_v=dict(IMNET, out_dim=64), non_local_attn=False, dtype="bf16",
    use_kernels=True)
# (name, pattern, replacement) on the kernel's source
VARIANTS = (
    ("nox", r"const float2 x =\s*xs \?[^;]*;",
     "const float2 x = make_float2(1.f, 1.f);"),
    ("nog", r"uint4 gv = ld8\([^;]*;", "uint4 gv = make_uint4(q, q, q, q);"),
    ("nowt", r"const float2 wv = __bfloat1622float2\([^;]*;",
     "const float2 wv = make_float2(1.f, 1.f);"),
)


def build_variants() -> dict:
    """Compile the copies (in parallel) into the git-ignored build tree;
    return each one's ``grid_decode`` entry point."""
    src = (_build.CSRC / "grid_decode_sm90.cu").read_text()
    out = _build.build_dir() / "k3_load_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, pat, rep in VARIANTS:
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
        fns[name] = ctypes.CDLL(str(out / f"lib{name}.so")).grid_decode
    return fns


def launch(fn, feature, csa, gk, gv, wt, ck, pk, tabs, ss):
    """Call an entry point with the argument list of ``dk.grid_decode``."""
    b, h, w, _ = feature.shape
    n_phase, n_shift = tabs["dys"].shape
    c, dc = dk.widths(feature, csa)
    taps = dk.taps_of(pk["wk0"].shape[0], c, "probe copy")
    out = torch.empty(b, n_phase, h, w, 3, device=feature.device)
    args = [feature, csa, gk, gv, wt, ck, *(pk[k] for k in dk._DECODE_ORDER),
            tabs["dys"], tabs["dxs"], tabs["rely"], tabs["relx"], out]
    ptrs = (ctypes.c_void_p * len(args))(*(dk._ptr(t) for t in args))
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    _build.check(fn(ctypes.cast(ptrs, ctypes.c_void_p), b, h, w, c, dc,
                    taps, n_phase, n_shift, float(ss),
                    _build.stream_ptr(feature.device)), "probe copy")
    return out


def once_ms(call) -> float:
    a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    call()
    e.record()
    e.synchronize()
    return a.elapsed_time(e)


def maps(net, hw: int, c: int, c_pad: int, with_csa: bool, seed: int):
    """Seeded feature (and csa) maps, the packed decoder and K1/K2's maps
    at x4 on an hw^2 LR map."""
    rng = np.random.default_rng(seed)
    feat = torch.as_tensor(rng.standard_normal((1, hw, hw, c_pad)).astype(
        np.float32) * 0.5, device="cuda")
    feat[..., c:] = 0
    feat = feat.bfloat16().contiguous()
    csa = (torch.as_tensor(rng.standard_normal((1, hw, hw, 64)).astype(
        np.float32) * 0.5, device="cuda").bfloat16().contiguous()
        if with_csa else None)
    pk = dk.pack_decoder(net.imnet_k, net.imnet_v, net.imnet_q, c,
                         (0.5, 0.5), torch.bfloat16, c_pad=c_pad)
    gk, gv = dk.f3p_build(feat, csa, pk["wk0"], pk["wvu"], pk["wvc"])
    wt, ck = dk.wt_hoist(feat, pk["wkout"], pk["bkout"])
    return (feat, csa, gk, gv, wt, ck, pk), dk.decoder_tables(
        4, hw, hw, net.local_size, "cuda")


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_load_probe: needs a CUDA card", file=sys.stderr)
        return 1
    _build.build_all()
    fns = build_variants()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    result = {}
    with torch.inference_mode():
        for label, cfg, hw, c, c_pad, with_csa in (
                ("C64@192x192", FLAGSHIP, 192, 64, 64, True),
                ("C64u1@192x192", FLAGSHIP_U1, 192, 64, 64, True),
                ("C180@256x256", SWINIR, 256, 180, 192, False)):
            net = build_generator(cfg, device="cuda", seed=1)
            mp, tabs = maps(net, hw, c, c_pad, with_csa, seed=hw)
            calls = {"kernel": lambda: dk.grid_decode(*mp, tabs, 1.0)}
            for name, fn in fns.items():
                calls[name] = (lambda f: lambda: launch(f, *mp, tabs, 1.0))(fn)
            for call in calls.values():
                call()
            torch.cuda.synchronize()
            ts = {name: [] for name in calls}
            for _ in range(5):
                for name, call in calls.items():
                    ts[name].append(once_ms(call))
            result[label] = {name: statistics.median(t)
                             for name, t in ts.items()}
            del net, mp, tabs
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
