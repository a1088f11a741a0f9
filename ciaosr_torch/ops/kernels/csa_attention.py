"""Rows 6-8: the CSA middle as attention over the (3s)²C value bank —
wrappers and plain versions.

Counterparts of ciaosr_tpu/ops/pallas/csa_attention.py::csa_attention
(row 7, the one-launch kernel of csrc/csa_flash.cu),
::csa_attention_overlap_add (row 8) and ::csa_fused (row 6) (one two-pass
template in csrc/csa_attention.cu). With q_i the 3×3 match
neighbourhood of query pixel i (9Cr), k_l the normalized key patches and
v_l the (3s)×(3s) stride-s patches of the embedding:

- ``csa_attention(q, k, v, scale)``: softmax(q·kᵀ·scale)·v over explicit
  banks, (B, P, 9Cr) × (B, L, 9Cr) × (B, L, (3s)²C) → (B, P, (3s)²C);
- ``csa_attention_overlap_add(q, k, v_pm, scale, hp, wp, s)``: the same
  over a plane-major bank (``plane_major_perm``), pasted by the
  (3s, 3s) stride-s overlap-add → (B, s·Hp, s·Wp, C);
- ``csa_fused(match, keys, embed, scale, s)``: the banks assembled from the
  match map and the embedding, then as row 8; the output is the stencil
  form's (ops/kernels/csa_stencil.py).

Outputs are f32. The kernels take bf16 at Cr = 32, C = 64, s = 2 only.
"""

from __future__ import annotations

import ctypes

import torch

from ciaosr_torch.ops import kernels
from ciaosr_torch.ops.kernels import _build
from ciaosr_torch.ops.kernels.csa_stencil import (C, CR, S, check_inputs,
                                                  row_blocks)
from ciaosr_torch.ops.neighborhood import extract_patches_same, overlap_add

DK, DV = 9 * CR, 9 * S * S * C


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


def _check_banks(name: str, q, k, v) -> tuple[int, int, int]:
    """Raise unless the kernel takes these banks; returns (B, P, L)."""
    b, p, dk = q.shape
    l_, dv = k.shape[1], v.shape[-1]
    if (dk, dv) != (DK, DV):
        raise ValueError(f"{name} kernel is built for Dk={DK}, Dv={DV} "
                         f"(Cr={CR}, C={C}, s={S}); got Dk={dk}, Dv={dv}")
    _build.check_tensor(q, (b, p, DK), "q")
    _build.check_tensor(k, (b, l_, DK), "k")
    _build.check_tensor(v, (b, l_, DV), "v")
    return b, p, l_


def csa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """Row 7 on CUDA tensors, the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return csa_attention_plain(q, k, v, scale)
    b, p, l_ = _check_banks("csa_attention", q, k, v)
    out = torch.empty(b, p, DV, device=q.device, dtype=torch.float32)
    _launch("csa_attention", (q, k, v, out), (b, p, l_), scale, q.device,
            "csa_flash")
    return out


def csa_attention_overlap_add(q: torch.Tensor, k: torch.Tensor,
                              v_pm: torch.Tensor, scale: float, hp: int,
                              wp: int, s: int) -> torch.Tensor:
    """Row 8 on CUDA tensors, the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return csa_attention_overlap_add_plain(q, k, v_pm, scale, hp, wp, s)
    b, p, l_ = _check_banks("csa_attention_overlap_add", q, k, v_pm)
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
    """Row 6 on CUDA tensors, the plain version on CPU tensors."""
    if match.device.type == "cpu":
        return csa_fused_plain(match, keys, embed, scale, s)
    b, hp, wp = check_inputs("csa_fused", match, keys, embed, s)
    out = torch.zeros(b, s * hp, s * wp, C, device=match.device,
                      dtype=torch.float32)
    _launch("csa_fused",
            (match, keys, embed, *_stats(b, hp * wp, match.device), out),
            (b, hp, wp), scale, match.device)
    return out
