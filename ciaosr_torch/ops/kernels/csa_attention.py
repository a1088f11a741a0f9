"""Rows 6-8: the CSA middle as attention over the (3s)²C value bank —
wrappers and plain versions.

Counterparts of ciaosr_tpu/ops/pallas/csa_attention.py::csa_attention
(row 7, the one-launch kernel of csrc/csa_flash.cu),
::csa_attention_overlap_add (row 8: row 7's kernel, then the paste of
csrc/csa_paste.cu) and ::csa_fused (row 6). With q_i the 3×3 match
neighbourhood of query pixel i (9Cr), k_l the normalized key patches and
v_l the (3s)×(3s) stride-s patches of the embedding:

- ``csa_attention(q, k, v, scale)``: softmax(q·kᵀ·scale)·v over explicit
  banks, (B, P, 9Cr) × (B, L, 9Cr) × (B, L, (3s)²C) → (B, P, (3s)²C);
- ``csa_attention_overlap_add(q, k, v_pm, scale, hp, wp, s)``: the same
  over a plane-major bank (``plane_major_perm``), pasted by the
  (3s, 3s) stride-s overlap-add → (B, s·Hp, s·Wp, C). On the card, row
  7's kernel on v_pm (a column permutation of V permutes only the output
  columns) writes the plane-major kernels k_pm (B, P, (3s)²C) f32, and
  ``plane_overlap_add`` pastes them: each output element is written once,
  its nine sources added in a fixed order, so two calls give the same
  bits;
- ``csa_fused(match, keys, embed, scale, s)``: the banks assembled from the
  match map and the embedding, then as row 8. This is the stencil form's
  function of the stencil form's inputs, so on the card it launches K4's
  kernel (csrc/csa_stencil_sm90.cu, ops/kernels/csa_stencil.py); its
  plain version stays the bank form.

Outputs are f32. The kernels take bf16 at s = 2 and the flagship's
(Cr, C) = (32, 64); rows 6 and 7 also at (96, 192), config 001 swinir's
(90, 180) zero-padded: row 7's banks are Dk = 864, Dv = 6912, and row 6
launches K4's wide pair over blocks of output rows
(``csa_stencil.wide_blocks``). Row 8, which nothing calls, takes the
flagship pair only.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ciaosr_torch.ops import kernels
from ciaosr_torch.ops.kernels import _build
from ciaosr_torch.ops.kernels.csa_stencil import (C, INSTANCES, S,
                                                  launch_stencil_sm90,
                                                  row_blocks)
from ciaosr_torch.ops.neighborhood import extract_patches_same, overlap_add

# the bank widths (Dk, Dv) of each compiled (Cr, C) pair; the flagship's
# first
BANKS = tuple((9 * cr, 9 * S * S * c) for cr, c in INSTANCES)


def csa_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v in f32, over blocks of query rows."""
    kt, vf = k.float().transpose(1, 2), v.float()
    return torch.cat([torch.softmax(q[:, i:j].float() @ kt * scale, -1) @ vf
                      for i, j in row_blocks(q.shape[1], k.shape[1])], 1)


def csa_attention_overlap_add_plain(q: torch.Tensor, k: torch.Tensor,
                                    v_pm: torch.Tensor, scale: float,
                                    hp: int, wp: int,
                                    s: int) -> torch.Tensor:
    """Row 7 on the plane-major bank, its columns put back in tap-major
    order, then ``overlap_add``."""
    b = q.shape[0]
    c = v_pm.shape[-1] // (9 * s * s)
    k_pm = csa_attention_plain(q, k, v_pm, scale)
    k_tm = k_pm.reshape(b, hp * wp, 3, 3, s, s, c).permute(
        0, 1, 2, 4, 3, 5, 6).reshape(b, hp * wp, -1)
    return overlap_add(k_tm, hp, wp, s, c)


def plane_overlap_add_plain(k_pm: torch.Tensor, hp: int, wp: int,
                            s: int) -> torch.Tensor:
    """Row 8's paste on plane-major kernels k_pm (B, Hp·Wp, 9s²C), in f32:
    output block (y, x) sums, over the taps (t, r) in the order (0, 0) ..
    (2, 2), plane (t, r) of query pixel (y − t + 1, x − r + 1), sources off
    the grid dropped → (B, s·Hp, s·Wp, C). ``overlap_add`` of the
    tap-major columns, added in csrc/csa_paste.cu's order."""
    b = k_pm.shape[0]
    sc = k_pm.shape[-1] // 9
    planes = F.pad(k_pm.float().reshape(b, hp, wp, 9, sc),
                   (0, 0, 0, 0, 1, 1, 1, 1))
    out = torch.zeros(b, hp, wp, sc, dtype=torch.float32,
                      device=k_pm.device)
    for t in range(3):
        for r in range(3):
            out = out + planes[:, 2 - t:2 - t + hp, 2 - r:2 - r + wp,
                               3 * t + r]
    c = sc // (s * s)
    return out.reshape(b, hp, wp, s, s, c).permute(0, 1, 3, 2, 4, 5).reshape(
        b, s * hp, s * wp, c)


def csa_fused_plain(match: torch.Tensor, keys: torch.Tensor,
                    embed: torch.Tensor, scale: float,
                    s: int) -> torch.Tensor:
    """The banks (``extract_patches_same``), row 7 and ``overlap_add``:
    the JAX package's einsum + _overlap_add route."""
    _, hp, wp, c = embed.shape
    q = extract_patches_same(match.float(), 3, 1)
    v = extract_patches_same(embed.float(), 3 * s, s)
    return overlap_add(csa_attention_plain(q, keys, v, scale), hp, wp, s, c)


def _call(name: str, fn, tensors, ints, floats, dev) -> None:
    """Call the kernel entry point ``fn`` with ``tensors``' pointers, then
    ``ints``, ``floats`` and the current stream; raise on the error it
    returns, naming ``name``."""
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * len(
        ints) + [ctypes.c_float] * len(floats) + [ctypes.c_void_p]
    _build.check(fn(*(_build.ptr(t) for t in tensors), *ints,
                    *(float(f) for f in floats), _build.stream_ptr(dev)),
                 name)


def _check_banks(name: str, q, k, v,
                 banks=BANKS) -> tuple[int, int, int]:
    """Raise unless the kernel takes these banks (widths in ``banks``);
    returns (B, P, L)."""
    b, p, dk = q.shape
    l_, dv = k.shape[1], v.shape[-1]
    if (dk, dv) not in banks:
        built = " or ".join(f"Dk={p}, Dv={q}" for p, q in banks)
        raise ValueError(f"{name} kernel is built for {built} (s={S}); got "
                         f"Dk={dk}, Dv={dv}")
    _build.check_tensor(q, (b, p, dk), "q")
    _build.check_tensor(k, (b, l_, dk), "k")
    _build.check_tensor(v, (b, l_, dv), "v")
    return b, p, l_


def csa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """Row 7 on CUDA tensors, the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return csa_attention_plain(q, k, v, scale)
    b, p, l_ = _check_banks("csa_attention", q, k, v)
    dk, dv = q.shape[-1], v.shape[-1]
    out = torch.empty(b, p, dv, device=q.device, dtype=torch.float32)
    _call("csa_attention", _build.load("csa_flash").csa_attention,
          (q, k, v, out), (b, p, l_, dk, dv), (scale,), q.device)
    kernels.LAUNCHES["csa_attention"] += 1
    return out


def _paste(name: str, k_pm: torch.Tensor, hp: int, wp: int,
           s: int) -> torch.Tensor:
    """csrc/csa_paste.cu on k_pm (B, Hp·Wp, 2304) f32; uncounted."""
    b = k_pm.shape[0]
    if s != S:
        raise ValueError(f"{name} is built for s={S}; got s={s}")
    _build.check_tensor(k_pm, (b, hp * wp, BANKS[0][1]), "k_pm",
                        torch.float32)
    out = torch.empty(b, s * hp, s * wp, C, device=k_pm.device,
                      dtype=torch.float32)
    _call(name, _build.load("csa_paste").plane_overlap_add, (k_pm, out),
          (b, hp, wp), (), k_pm.device)
    return out


def plane_overlap_add(k_pm: torch.Tensor, hp: int, wp: int,
                      s: int) -> torch.Tensor:
    """Row 8's paste alone on CUDA tensors (counted under its own name;
    row 8 counts its two launches as one call), the plain version on CPU
    tensors."""
    if k_pm.device.type == "cpu":
        return plane_overlap_add_plain(k_pm, hp, wp, s)
    out = _paste("plane_overlap_add", k_pm, hp, wp, s)
    kernels.LAUNCHES["plane_overlap_add"] += 1
    return out


def csa_attention_overlap_add(q: torch.Tensor, k: torch.Tensor,
                              v_pm: torch.Tensor, scale: float, hp: int,
                              wp: int, s: int) -> torch.Tensor:
    """Row 8 on CUDA tensors (row 7's kernel into a k_pm scratch, then the
    paste; one count a call), the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return csa_attention_overlap_add_plain(q, k, v_pm, scale, hp, wp, s)
    name = "csa_attention_overlap_add"
    b, p, l_ = _check_banks(name, q, k, v_pm, BANKS[:1])
    if s != S or p != hp * wp:
        raise ValueError(f"{name} needs s={S} and P = Hp·Wp; got s={s}, "
                         f"P={p}, Hp×Wp={hp}×{wp}")
    dk, dv = BANKS[0]
    k_pm = torch.empty(b, p, dv, device=q.device, dtype=torch.float32)
    _call(name, _build.load("csa_flash").csa_attention, (q, k, v_pm, k_pm),
          (b, p, l_, dk, dv), (scale,), q.device)
    out = _paste(name, k_pm, hp, wp, s)
    kernels.LAUNCHES[name] += 1
    return out


def csa_fused(match: torch.Tensor, keys: torch.Tensor, embed: torch.Tensor,
              scale: float, s: int) -> torch.Tensor:
    """Row 6 on CUDA tensors (K4's kernels: the same function of the same
    inputs), the plain version (the bank form) on CPU tensors."""
    if match.device.type == "cpu":
        return csa_fused_plain(match, keys, embed, scale, s)
    return launch_stencil_sm90("csa_fused", match, keys, embed, scale, s)
