"""K4: the CSA middle (average=True) — wrapper and plain version.

Counterpart of ciaosr_tpu/ops/pallas/csa_attention.py::csa_stencil_fused;
the kernel is csrc/csa_stencil.cu. Contract: match (B, Hp, Wp, Cr), keys
(B, L, 9Cr) L2-normalized 3×3 key patches of the s-downsampled match map
(L = Hp/s · Wp/s), embed (B, Hp, Wp, C). Returns (B, s·Hp, s·Wp, C) f32,
before the down conv and the /6.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ciaosr_torch.ops import kernels
from ciaosr_torch.ops.kernels import _build
from ciaosr_torch.ops.neighborhood import extract_patches_same

# the shapes the kernel is compiled for
CR, C, S = 32, 64, 2


def phase_planes(embed: torch.Tensor, s: int) -> torch.Tensor:
    """(B, Hp, Wp, C) → (B, L, s²C):
    P_l[(a, b), c] = embed[s·ly + a, s·lx + b, c]."""
    b, hp, wp, c = embed.shape
    ph = embed.reshape(b, hp // s, s, wp // s, s, c)
    return ph.permute(0, 1, 3, 2, 4, 5).reshape(b, (hp // s) * (wp // s),
                                                s * s * c)


def csa_stencil_plain(match: torch.Tensor, keys: torch.Tensor,
                      embed: torch.Tensor, scale: float,
                      s: int) -> torch.Tensor:
    """Scores, softmax over L, the 9-point diagonal stencil on the
    attention map, one (P, L)@(L, s²C) product, pixel shuffle — in f32
    (ciaosr_tpu/models/csa.py::_stencil_reconstruct)."""
    b, hp, wp, c = embed.shape
    hq, wq = hp // s, wp // s
    x_nb = extract_patches_same(match.float(), 3, 1)          # (B, P, 9Cr)
    attn = torch.softmax(x_nb @ keys.float().transpose(1, 2) * scale, -1)
    a5 = F.pad(attn.reshape(b, hp, wp, hq, wq), (1, 1, 1, 1, 1, 1, 1, 1))
    m = sum(a5[:, dy:dy + hp, dx:dx + wp, dy:dy + hq, dx:dx + wq]
            for dy in range(3) for dx in range(3))
    out = m.reshape(b, hp * wp, hq * wq) @ phase_planes(embed.float(), s)
    return out.reshape(b, hp, wp, s, s, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(b, hp * s, wp * s, c)


def csa_stencil(match: torch.Tensor, keys: torch.Tensor,
                embed: torch.Tensor, scale: float, s: int) -> torch.Tensor:
    """K4 on CUDA tensors, the plain version on CPU tensors."""
    if match.device.type == "cpu":
        return csa_stencil_plain(match, keys, embed, scale, s)
    b, hp, wp, c = embed.shape
    cr = match.shape[-1]
    l_ = (hp // s) * (wp // s)
    if (s, c, cr) != (S, C, CR):
        raise ValueError(f"csa_stencil kernel is built for s={S}, C={C}, "
                         f"Cr={CR}; got s={s}, C={c}, Cr={cr}")
    _build.check_tensor(match, (b, hp, wp, CR), "match")
    _build.check_tensor(keys, (b, l_, 9 * CR), "keys")
    _build.check_tensor(embed, (b, hp, wp, C), "embed")
    if hp % s or wp % s:
        raise ValueError(f"csa_stencil needs Hp, Wp divisible by {s}")
    dev = match.device
    m_buf = torch.empty(b, hp * wp, device=dev, dtype=torch.float32)
    l_buf = torch.empty_like(m_buf)
    out = torch.empty(b, s * hp, s * wp, C, device=dev, dtype=torch.float32)
    lib = _build.load("csa_stencil")
    fn = lib.csa_stencil
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    err = fn(_build.ptr(match), _build.ptr(keys), _build.ptr(embed),
             _build.ptr(m_buf), _build.ptr(l_buf), _build.ptr(out),
             b, hp, wp, float(scale), _build.stream_ptr(dev))
    kernels.LAUNCHES["csa_stencil"] += 1
    _build.check(err, "csa_stencil")
    return out
