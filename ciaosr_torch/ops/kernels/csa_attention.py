"""Rows 6-8: the CSA middle as attention over the (3s)²C value bank —
wrappers and plain versions.

Counterparts of ciaosr_tpu/ops/pallas/csa_attention.py::csa_attention
(row 7, the one-launch kernel of csrc/csa_flash.cu),
::csa_attention_overlap_add (row 8, the two-pass kernel of
csrc/csa_attention.cu) and ::csa_fused (row 6). With q_i the 3×3 match
neighbourhood of query pixel i (9Cr), k_l the normalized key patches and
v_l the (3s)×(3s) stride-s patches of the embedding:

- ``csa_attention(q, k, v, scale)``: softmax(q·kᵀ·scale)·v over explicit
  banks, (B, P, 9Cr) × (B, L, 9Cr) × (B, L, (3s)²C) → (B, P, (3s)²C);
- ``csa_attention_overlap_add(q, k, v_pm, scale, hp, wp, s)``: the same
  over a plane-major bank (``plane_major_perm``), pasted by the
  (3s, 3s) stride-s overlap-add → (B, s·Hp, s·Wp, C);
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


def csa_fused_plain(match: torch.Tensor, keys: torch.Tensor,
                    embed: torch.Tensor, scale: float,
                    s: int) -> torch.Tensor:
    """The banks (``extract_patches_same``), row 7 and ``overlap_add``:
    the JAX package's einsum + _overlap_add route."""
    _, hp, wp, c = embed.shape
    q = extract_patches_same(match.float(), 3, 1)
    v = extract_patches_same(embed.float(), 3 * s, s)
    return overlap_add(csa_attention_plain(q, keys, v, scale), hp, wp, s, c)


def _launch(name: str, tensors, ints, scale: float, dev,
            lib: str = "csa_attention") -> None:
    fn = getattr(_build.load(lib), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * len(
        ints) + [ctypes.c_float, ctypes.c_void_p]
    err = fn(*(_build.ptr(t) for t in tensors), *ints, float(scale),
             _build.stream_ptr(dev))
    kernels.LAUNCHES[name] += 1
    _build.check(err, name)


def _stats(b: int, p: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    m_buf = torch.empty(b, p, device=dev, dtype=torch.float32)
    return m_buf, torch.empty_like(m_buf)


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
    _launch("csa_attention", (q, k, v, out), (b, p, l_, dk, dv), scale,
            q.device, "csa_flash")
    return out


def csa_attention_overlap_add(q: torch.Tensor, k: torch.Tensor,
                              v_pm: torch.Tensor, scale: float, hp: int,
                              wp: int, s: int) -> torch.Tensor:
    """Row 8 on CUDA tensors, the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return csa_attention_overlap_add_plain(q, k, v_pm, scale, hp, wp, s)
    b, p, l_ = _check_banks("csa_attention_overlap_add", q, k, v_pm,
                            BANKS[:1])
    if s != S or p != hp * wp:
        raise ValueError(f"csa_attention_overlap_add needs s={S} and "
                         f"P = Hp·Wp; got s={s}, P={p}, Hp×Wp={hp}×{wp}")
    out = torch.zeros(b, s * hp, s * wp, C, device=q.device,
                      dtype=torch.float32)
    _launch("csa_attention_overlap_add",
            (q, k, v_pm, *_stats(b, p, q.device), out), (b, hp, wp, l_),
            scale, q.device)
    return out


def csa_fused(match: torch.Tensor, keys: torch.Tensor, embed: torch.Tensor,
              scale: float, s: int) -> torch.Tensor:
    """Row 6 on CUDA tensors (K4's kernels: the same function of the same
    inputs), the plain version (the bank form) on CPU tensors."""
    if match.device.type == "cpu":
        return csa_fused_plain(match, keys, embed, scale, s)
    return launch_stencil_sm90("csa_fused", match, keys, embed, scale, s)
