"""K1-K3: the integer-scale dense-grid decode chain — wrappers, plain
versions and host tables.

Counterparts in ciaosr_tpu/ops/pallas/decoder_kernel.py:
  f3p_build   ← _build_f3p (K1, csrc/f3p_build.cu)
  wt_hoist    ← _wt_hoist_planes (K2, csrc/wt_hoist.cu)
  grid_decode ← _grid_decode_halo, integer mode (K3, csrc/grid_decode.cu)
plus host copies of _phase_tables, _split_first_layer/_pack_weights and
models/ciaosr.py::shift_offsets.

Weights enter packed (``pack_decoder``): tap-major unfold blocks, (in, out)
matrices in the compute dtype, f32 biases, the cell terms folded into the
first-layer bias, imnet_v's output layer and imnet_q's first layer split
at 9C. The decoder reads u (the 3×3 unfold) nowhere from memory: K2 and K3
rebuild it from the raw feature.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn as nn

from ciaosr_torch.ops import kernels
from ciaosr_torch.ops.kernels import _build
from ciaosr_torch.ops.neighborhood import (shift_edge, tap_major_perm,
                                           unfold_nhwc)

# the widths the kernels are compiled for
C, DC, HID, N_HIDDEN = 64, 64, 256, 4

# the 3×3 edge-clamped shifts d = (dy, dx) in the order of the wt planes
SHIFTS9 = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def shift_offsets(local_size: int) -> list[tuple[int, int]]:
    """The local-ensemble shift set: 1 → [(0,0)]; 2 → 4 diagonals;
    3 → full 3×3."""
    if local_size == 1:
        return [(0, 0)]
    step = 4 - local_size
    return [(i, j) for i in range(-1, 2, step) for j in range(-1, 2, step)]


def phase_tables(s: int, h: int, w: int, shifts):
    """Per-(phase, shift) integer offsets (dy, dx) and rel rows with the
    border correction: dys, dxs (P, S) int32, rely (P, S, H), relx
    (P, S, W) f32, phases p = a·s + b."""
    def axis_consts(n_, big_n):
        rel = (2.0 * np.arange(s) + 1.0) / s - 1.0
        rx = (1.0 - 2.0 / big_n) / (n_ - 1)
        d = {0: np.zeros(s, np.int64)}
        for sign in (-1, 1):
            d[sign] = np.round(rel / 2 + sign * (n_ * rx / 2)
                               + n_ * 1e-6 / 2).astype(np.int64)
        return rel, d

    rel_y, dy_tab = axis_consts(h, s * h)
    rel_x, dx_tab = axis_consts(w, s * w)
    phases = [(a, b) for a in range(s) for b in range(s)]
    n_phase, n_shift = len(phases), len(shifts)
    dys = np.zeros((n_phase, n_shift), np.int32)
    dxs = np.zeros((n_phase, n_shift), np.int32)
    rely = np.zeros((n_phase, n_shift, h), np.float32)
    relx = np.zeros((n_phase, n_shift, w), np.float32)
    m_h, m_w = np.arange(h), np.arange(w)
    for p, (a, b) in enumerate(phases):
        for si, (vy, vx) in enumerate(shifts):
            dy = int(dy_tab[int(np.sign(vy))][a]) if vy else 0
            dx = int(dx_tab[int(np.sign(vx))][b]) if vx else 0
            dys[p, si], dxs[p, si] = dy, dx
            dye = np.clip(m_h + dy, 0, h - 1) - m_h
            dxe = np.clip(m_w + dx, 0, w - 1) - m_w
            rely[p, si] = rel_y[a] - 2.0 * dye
            relx[p, si] = rel_x[b] - 2.0 * dxe
    return dys, dxs, rely, relx


def pack_decoder(imnet_k: nn.Module, imnet_v: nn.Module, imnet_q: nn.Module,
                 c: int, scale: int, dtype: torch.dtype) -> dict:
    """Decoder weights in kernel layout from the reference-layout MLPs.

    The MLPs' unfold blocks are channel-major (c·9 + tap); the packed ones
    are tap-major (tap·C + c). Matrices are (in, out) in ``dtype``;
    biases, rel rows and the out layers feeding f32 dot products are f32
    (rounded through ``dtype`` where the kernel multiplies them as such)."""
    dk = 9 * c
    perm = torch.as_tensor(tap_major_perm(c))
    lk, lv, lq = imnet_k.linears, imnet_v.linears, imnet_q.linears
    if not len(lk) == len(lv) == len(lq):
        raise ValueError("imnet_k/v/q need the same depth")
    dv = lv[0].in_features - 4
    vperm = torch.cat([perm, torch.arange(dk, dv)])
    cell = 2.0 / scale

    def mat(w):  # torch (out, in) weight → (in, out) in dtype
        return w.t().contiguous().to(dtype)

    def f32(t):
        return t.detach().float().contiguous()

    def first(lin, cols, main):
        w = lin.weight.detach()
        return (mat(w[:, cols]),
                f32(torch.stack([w[:, main], w[:, main + 1]])),
                f32(lin.bias + cell * (w[:, main + 2] + w[:, main + 3])))

    wk0, krel, kb0 = first(lk[0], perm, dk)
    wv0, vrel, vb0 = first(lv[0], vperm, dv)
    kout, vout = lk[-1], lv[-1]
    return {
        "wk0": wk0, "krel": krel, "kb0": kb0,
        "wvu": wv0[:dk].contiguous(), "wvc": wv0[dk:].contiguous(),
        "vrel": vrel, "vb0": vb0,
        "kw": torch.stack([mat(l.weight.detach()) for l in lk[1:-1]]),
        "kb": torch.stack([f32(l.bias) for l in lk[1:-1]]),
        "vw": torch.stack([mat(l.weight.detach()) for l in lv[1:-1]]),
        "vb": torch.stack([f32(l.bias) for l in lv[1:-1]]),
        # imnet_k out layer, hoisted: wt = qk @ W, ck = qk · b (tap-major)
        "wkout": kout.weight.detach()[perm].contiguous().to(dtype),
        "bkout": f32(kout.bias.detach()[perm].to(dtype)),
        "vout": mat(vout.weight.detach()[vperm]),
        "vbout": f32(vout.bias.detach()[vperm]),
        "qw0": mat(lq[0].weight.detach()[:, vperm]),
        "qb0": f32(lq[0].bias),
        "qw": torch.stack([mat(l.weight.detach()) for l in lq[1:-1]]),
        "qb": torch.stack([f32(l.bias) for l in lq[1:-1]]),
        "qwout": f32(lq[-1].weight.detach().to(dtype)),
        "qbout": f32(lq[-1].bias),
    }


def decoder_tables(scale: int, h: int, w: int, local_size: int,
                   device) -> dict:
    dys, dxs, rely, relx = phase_tables(scale, h, w,
                                        shift_offsets(local_size))
    return {k: torch.as_tensor(v, device=device)
            for k, v in (("dys", dys), ("dxs", dxs), ("rely", rely),
                         ("relx", relx))}


# ------------------------------------------------------------------ K1 --

def f3p_build_plain(feature, csa, wk0, wvu, wvc):
    """g_k = u@W_k0, g_v = u@W_vu + csa@W_vc with u = unfold(feature)."""
    u = unfold_nhwc(feature)
    return u @ wk0, u @ wvu + csa @ wvc


def f3p_build(feature, csa, wk0, wvu, wvc):
    """K1 on CUDA tensors, the plain version on CPU tensors. feature,
    csa: (B, H, W, 64); W_k0, W_vu: (576, 256); W_vc: (64, 256).
    Returns g_k, g_v (B, H, W, 256)."""
    if feature.device.type == "cpu":
        return f3p_build_plain(feature, csa, wk0, wvu, wvc)
    b, h, w, _ = feature.shape
    _build.check_tensor(feature, (b, h, w, C), "feature")
    _build.check_tensor(csa, (b, h, w, DC), "csa")
    _build.check_tensor(wk0, (9 * C, HID), "wk0")
    _build.check_tensor(wvu, (9 * C, HID), "wvu")
    _build.check_tensor(wvc, (DC, HID), "wvc")
    gk = torch.empty(b, h, w, HID, device=feature.device,
                     dtype=torch.bfloat16)
    gv = torch.empty_like(gk)
    fn = _build.load("f3p_build").f3p_build
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    err = fn(*(_build.ptr(t) for t in (feature, csa, wk0, wvu, wvc, gk, gv)),
             b, h, w, _build.stream_ptr(feature.device))
    kernels.LAUNCHES["f3p_build"] += 1
    _build.check(err, "f3p_build")
    return gk, gv


# ------------------------------------------------------------------ K2 --

def wt_hoist_plain(feature, wkout, bkout):
    """wt_d = (u ⊙ u_d)@W_kout, ck_d = (u ⊙ u_d)·b_kout for the nine
    edge-clamped shifts d; u_d = u read at clamp(p + d)."""
    u = unfold_nhwc(feature)
    wts, cks = [], []
    for dy, dx in SHIFTS9:
        qk = u * shift_edge(u, dy, dx)
        wts.append(qk @ wkout)
        cks.append(qk @ bkout.to(qk.dtype))
    return torch.stack(wts), torch.stack(cks)


def wt_hoist(feature, wkout, bkout):
    """K2 on CUDA tensors, the plain version on CPU tensors. feature
    (B, H, W, 64), W_kout (576, 256), b_kout (576,) f32. Returns wt
    (9, B, H, W, 256) and ck (9, B, H, W) f32."""
    if feature.device.type == "cpu":
        return wt_hoist_plain(feature, wkout, bkout)
    b, h, w, _ = feature.shape
    _build.check_tensor(feature, (b, h, w, C), "feature")
    _build.check_tensor(wkout, (9 * C, HID), "wkout")
    _build.check_tensor(bkout, (9 * C,), "bkout", torch.float32)
    wt = torch.empty(9, b, h, w, HID, device=feature.device,
                     dtype=torch.bfloat16)
    ck = torch.empty(9, b, h, w, device=feature.device, dtype=torch.float32)
    fn = _build.load("wt_hoist").wt_hoist
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    err = fn(*(_build.ptr(t) for t in (feature, wkout, bkout, wt, ck)),
             b, h, w, _build.stream_ptr(feature.device))
    kernels.LAUNCHES["wt_hoist"] += 1
    _build.check(err, "wt_hoist")
    return wt, ck


# ------------------------------------------------------------------ K3 --

def _mlp_hidden(h, ws, bs):
    for w_, b_ in zip(ws, bs):
        h = torch.relu(h @ w_ + b_)
    return h


def grid_decode_plain(feature, csa, gk, gv, wt, ck, pk: dict, tabs: dict,
                      softmax_scale: float):
    """Per phase: four k-paths (first layer from the shifted g_k plus the
    rel terms, hidden layers, logit = wt·h + ck), softmax over the shifts,
    four v-paths blended into outv, then imnet_q. Returns (B, P, H, W, 3)."""
    dys, dxs = tabs["dys"].tolist(), tabs["dxs"].tolist()
    rely, relx = tabs["rely"], tabs["relx"]
    u = unfold_nhwc(feature)
    dt = gk.dtype
    out = []
    for p in range(len(dys)):
        logits, preds = [], []
        for i, (dy, dx) in enumerate(zip(dys[p], dxs[p])):
            ry = rely[p, i][None, :, None, None].to(dt)
            rx = relx[p, i][None, None, :, None].to(dt)

            def first(g, rel, b0):
                return torch.relu(shift_edge(g, dy, dx) + ry * rel[0]
                                  + rx * rel[1] + b0)

            hk = _mlp_hidden(
                first(gk, pk["krel"].to(dt), pk["kb0"].to(dt)),
                pk["kw"].to(dt), pk["kb"].to(dt))
            d = SHIFTS9.index((dy, dx))
            logits.append((wt[d] * hk).sum(-1) + ck[d].to(dt))
            hv = _mlp_hidden(
                first(gv, pk["vrel"].to(dt), pk["vb0"].to(dt)),
                pk["vw"].to(dt), pk["vb"].to(dt))
            x = torch.cat([shift_edge(u, dy, dx), shift_edge(csa, dy, dx)],
                          -1)
            preds.append(x * (hv @ pk["vout"].to(dt) + pk["vbout"].to(dt)))
        attn = torch.softmax(torch.stack(logits, -1) / softmax_scale, -1)
        outv = sum(attn[..., i:i + 1] * preds[i] for i in range(len(preds)))
        hq = torch.relu(outv @ pk["qw0"].to(dt) + pk["qb0"].to(dt))
        hq = _mlp_hidden(hq, pk["qw"].to(dt), pk["qb"].to(dt))
        out.append(hq @ pk["qwout"].to(dt).t() + pk["qbout"].to(dt))
    return torch.stack(out, 1)


_DECODE_ORDER = ("kw", "vw", "vout", "qw0", "qw", "kb", "vb", "vbout",
                 "qb0", "qb", "krel", "kb0", "vrel", "vb0", "qwout",
                 "qbout")


def grid_decode(feature, csa, gk, gv, wt, ck, pk: dict, tabs: dict,
                softmax_scale: float):
    """K3 on CUDA tensors, the plain version on CPU tensors. Returns the
    (B, s², H, W, 3) f32 phase images before the bilinear residual."""
    if feature.device.type == "cpu":
        return grid_decode_plain(feature, csa, gk, gv, wt, ck, pk, tabs,
                                 softmax_scale)
    b, h, w, _ = feature.shape
    n_phase, n_shift = tabs["dys"].shape
    if pk["kw"].shape[0] != N_HIDDEN - 1 or pk["qw"].shape[0] != N_HIDDEN - 1:
        raise ValueError(f"grid_decode kernel is built for {N_HIDDEN} "
                         "hidden layers")
    _build.check_tensor(feature, (b, h, w, C), "feature")
    _build.check_tensor(csa, (b, h, w, DC), "csa")
    _build.check_tensor(gk, (b, h, w, HID), "gk")
    _build.check_tensor(gv, (b, h, w, HID), "gv")
    _build.check_tensor(wt, (9, b, h, w, HID), "wt")
    _build.check_tensor(ck, (9, b, h, w), "ck", torch.float32)
    bf, f = torch.bfloat16, torch.float32
    shapes = {"kw": ((3, HID, HID), bf), "vw": ((3, HID, HID), bf),
              "vout": ((HID, 9 * C + DC), bf), "qw0": ((9 * C + DC, HID), bf),
              "qw": ((3, HID, HID), bf), "kb": ((3, HID), f),
              "vb": ((3, HID), f), "vbout": ((9 * C + DC,), f),
              "qb0": ((HID,), f), "qb": ((3, HID), f),
              "krel": ((2, HID), f), "kb0": ((HID,), f),
              "vrel": ((2, HID), f), "vb0": ((HID,), f),
              "qwout": ((3, HID), f), "qbout": ((3,), f)}
    for k in _DECODE_ORDER:
        _build.check_tensor(pk[k], shapes[k][0], k, shapes[k][1])
    _build.check_tensor(tabs["dys"], (n_phase, n_shift), "dys", torch.int32)
    _build.check_tensor(tabs["dxs"], (n_phase, n_shift), "dxs", torch.int32)
    _build.check_tensor(tabs["rely"], (n_phase, n_shift, h), "rely", f)
    _build.check_tensor(tabs["relx"], (n_phase, n_shift, w), "relx", f)
    if not 1 <= n_shift <= 9:
        raise ValueError(f"grid_decode takes 1..9 shifts, got {n_shift}")
    out = torch.empty(b, n_phase, h, w, 3, device=feature.device, dtype=f)
    args = [feature, csa, gk, gv, wt, ck, *(pk[k] for k in _DECODE_ORDER),
            tabs["dys"], tabs["dxs"], tabs["rely"], tabs["relx"], out]
    ptrs = (ctypes.c_void_p * len(args))(*(t.data_ptr() for t in args))
    fn = _build.load("grid_decode").grid_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    err = fn(ctypes.cast(ptrs, ctypes.c_void_p), b, h, w, n_phase, n_shift,
             float(softmax_scale), _build.stream_ptr(feature.device))
    kernels.LAUNCHES["grid_decode"] += 1
    _build.check(err, "grid_decode")
    return out
