"""K1-K3: the dense-grid decode chain — wrappers, plain versions and host
tables.

Counterparts in ciaosr_tpu/ops/pallas/decoder_kernel.py:
  f3p_build   ← _build_f3p (K1, csrc/f3p_build.cu)
  wt_hoist    ← _wt_hoist_planes (K2, csrc/wt_hoist_sm90.cu: wgmma and
                TMA)
  grid_decode ← _grid_decode_halo, integer mode (K3,
                csrc/grid_decode_sm90.cu: wgmma and TMA)
  grid_decode_rational ← grid_decode_fused_rational, the rational mode of
                _grid_decode_halo (row 10: the same kernel's rational index
                mode, reading per-axis index tables)
plus host copies of _phase_tables, _split_first_layer/_pack_weights and
models/ciaosr.py::shift_offsets / _grid_axis_tables.

Weights enter packed (``pack_decoder``): tap-major unfold blocks, (in, out)
matrices in the compute dtype, f32 biases, the cell terms folded into the
first-layer bias, imnet_v's output layer and imnet_q's first layer split
at DK = taps·C. The decoder reads u (the 3×3 unfold) nowhere from memory:
K2 and K3 rebuild it from the raw feature.

Taps. u is the 3×3 unfold of the feature (9 taps, DK = 9C) or, for a
generator with ``feat_unfold=False``, the feature itself (1 tap, DK = C):
the JAX package passes ``u_map = feature`` to the same TPU kernels. K1
then is one GEMM over the flat pixel rows (a persistent kernel of its
own in csrc/f3p_build.cu), K2 still forms
the nine shifted planes (of the feature), and K3's value is [feature |
csa]. The wrappers read the tap count from the packed weights' rows.

Widths. The kernels are compiled for the (C, DC, taps) triples of
``INSTANCES``: the RDN flagship (64 feature, 64 CSA channels), SwinIR-
CiaoSR without CSA (DC = 0, csa None) at C = 192 and SwinIR-CiaoSR with
CSA (config 001 swinir) at (192, 192), its 180 feature and CSA channels
zero-padded (``padded_widths``; ``pack_decoder(c_pad=..., dc_pad=...)``
puts zero rows and columns at the padded channels of every unfold block
and of the CSA block, so the padding changes no result), each with the
unfold and without it (``feat_unfold=False``: config 001 edsr's
generator at (64, 64), the SwinIR generators at (192, 0) and (192,
192)). The wrappers read C and DC from their tensors and raise for any
other triple; both modes of K3 take all six (the kernel blends the value
in 128-column chunks: at one tap DV = 128, 192 or 384 is one, one and a
half or three chunks).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from ciaosr_torch.ops import kernels
from ciaosr_torch.ops.kernels import _build
from ciaosr_torch.ops.neighborhood import (shift_edge, tap_major_perm,
                                           unfold_nhwc)

# the (C, DC, taps) triples the kernels are compiled for, and the MLP widths
INSTANCES = ((64, 64, 9), (192, 0, 9), (192, 192, 9), (64, 64, 1),
             (192, 0, 1), (192, 192, 1))
HID, N_HIDDEN = 256, 4
# the decode kernel blends its shifts in groups of 4 at every width, but
# takes 9 (local_size 3) only at C = 64, the one width where that case is
# held to its plain version on the card; at C = 192 both modes take at
# most 4 shifts (local_size ≤ 2, as every config at that width)
WIDE_MAX_SHIFT = 4


def padded_widths(c: int, dc: int, taps: int = 9) -> tuple[int, int]:
    """The kernel widths a c-channel feature and a dc-channel CSA map
    (0: none) decoded with ``taps`` taps are zero-padded to: the smallest
    compiled pair of those taps that holds both, with CSA as the map has
    it ((c, dc) itself past the widest)."""
    return min((p[:2] for p in INSTANCES
                if p[2] == taps and p[0] >= c and p[1] >= dc
                and (p[1] > 0) == (dc > 0)),
               default=(c, dc))


def widths(feature, csa) -> tuple[int, int]:
    """(C, DC) of a decode's inputs; DC = 0 without CSA."""
    return feature.shape[-1], 0 if csa is None else csa.shape[-1]


def taps_of(rows: int, c: int, name: str) -> int:
    """The taps of a decode whose packed unfold block has ``rows`` rows
    at C = c: 9 (the 3×3 unfold) or 1 (the feature itself)."""
    if rows not in (9 * c, c):
        raise ValueError(f"{name}: {rows} unfold rows at C={c}: want 9C "
                         "or C")
    return rows // c


def unfold_taps(feature, taps: int):
    """u of a decode: the 3×3 unfold of the feature, or at one tap the
    feature itself."""
    return unfold_nhwc(feature) if taps == 9 else feature


_PAIRS = frozenset(p[:2] for p in INSTANCES)


def _check_instance(c: int, dc: int, taps: int | None, name: str) -> None:
    """Raise unless (c, dc, taps) is compiled; ``taps`` None: unless (c, dc)
    is, at some tap count."""
    if (c, dc) not in _PAIRS or (
            taps is not None and (c, dc, taps) not in INSTANCES):
        raise ValueError(f"{name}: the kernels are compiled for (C, DC, "
                         f"taps) in {INSTANCES}, got ({c}, {dc}, {taps})")

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
                 c: int, cell: Sequence[float], dtype: torch.dtype,
                 c_pad: int | None = None,
                 dc_pad: int | None = None) -> dict:
    """Decoder weights in kernel layout from the reference-layout MLPs.

    The MLPs' unfold blocks are channel-major (c·9 + tap); the packed ones
    are tap-major (tap·C + c) over ``c_pad`` ≥ c channels per tap, zero
    at the padded ones (one tap, the feature itself, where the MLPs were
    built without the unfold: their blocks are C wide), then the CSA
    block over ``dc_pad`` ≥ DC channels, zero at its padded ones. Matrices are (in, out) in ``dtype``;
    biases, rel rows and the out layers feeding f32 dot products are f32
    (rounded through ``dtype`` where the kernel multiplies them as such).
    ``cell`` = (cell_y·H, cell_x·W), folded into the first-layer biases:
    (2/s, 2/s) at integer scale s."""
    cp = c if c_pad is None else c_pad
    lk, lv, lq = imnet_k.linears, imnet_v.linears, imnet_q.linears
    taps = taps_of(lk[0].in_features - 4, c, "pack_decoder")
    dk = taps * c
    perm = torch.as_tensor(tap_major_perm(c, taps))
    if not len(lk) == len(lv) == len(lq):
        raise ValueError("imnet_k/v/q need the same depth")
    dv = lv[0].in_features - 4
    dc = dv - dk
    dcp = dc if dc_pad is None else dc_pad
    vperm = torch.cat([perm, torch.arange(dk, dv)])
    dkp, dvp = taps * cp, taps * cp + dcp

    def spread(t, n, dim=0):   # the real entries to their packed ones
        if cp == c and dcp == dc:
            return t
        at = torch.as_tensor([i * cp + ch for i in range(taps)
                              for ch in range(c)]
                             + list(range(dkp, dkp + dc)), device=t.device)
        out = t.new_zeros(*t.shape[:dim], n, *t.shape[dim + 1:])
        return out.index_copy_(dim, at[:t.shape[dim]], t)

    cell_y, cell_x = cell

    def mat(w):  # torch (out, in) weight → (in, out) in dtype
        return w.t().contiguous().to(dtype)

    def f32(t):
        return t.detach().float().contiguous()

    def first(lin, cols, main):
        w = lin.weight.detach()
        if cell_y == cell_x:   # the JAX integer route's sum order
            cterm = cell_y * (w[:, main + 2] + w[:, main + 3])
        else:
            cterm = cell_y * w[:, main + 2] + cell_x * w[:, main + 3]
        return (mat(w[:, cols]),
                f32(torch.stack([w[:, main], w[:, main + 1]])),
                f32(lin.bias + cterm))

    wk0, krel, kb0 = first(lk[0], perm, dk)
    wv0, vrel, vb0 = first(lv[0], vperm, dv)
    wk0, wv0 = spread(wk0, dkp), spread(wv0, dvp)
    kout, vout = lk[-1], lv[-1]
    return {
        "wk0": wk0, "krel": krel, "kb0": kb0,
        "wvu": wv0[:dkp].contiguous(), "wvc": wv0[dkp:].contiguous(),
        "vrel": vrel, "vb0": vb0,
        "kw": torch.stack([mat(l.weight.detach()) for l in lk[1:-1]]),
        "kb": torch.stack([f32(l.bias) for l in lk[1:-1]]),
        "vw": torch.stack([mat(l.weight.detach()) for l in lv[1:-1]]),
        "vb": torch.stack([f32(l.bias) for l in lv[1:-1]]),
        # imnet_k out layer, hoisted: wt = qk @ W, ck = qk · b (tap-major)
        "wkout": spread(kout.weight.detach()[perm], dkp).contiguous().to(
            dtype),
        "bkout": f32(spread(kout.bias.detach()[perm], dkp).to(dtype)),
        "vout": spread(mat(vout.weight.detach()[vperm]), dvp, 1),
        "vbout": f32(spread(vout.bias.detach()[vperm], dvp)),
        "qw0": spread(mat(lq[0].weight.detach()[:, vperm]), dvp),
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


def rational_tables(h: int, w: int, py: int, qy: int, px: int, qx: int,
                    local_size: int, device) -> dict:
    """Per-axis index and rel tables of a rational dense decode at
    py/qy × px/qx, from ``grid_axis_tables``. Phase (a, b) is an
    (H/qy) × (W/qx) image whose pixel (k, j) reads the query pixel
    (yq[a, k], xq[b, j]) and, for shift i, the key pixel
    (yk[a, i, k], xk[b, i, j]) with rel (yrel[a, i, k], xrel[b, i, j]).
    The tables are separable, so per axis: yq (py, H/qy), yk / yrel
    (py, S, H/qy), and likewise for x. Raises unless every key is within
    one pixel of its query (d = key − query ∈ {−1, 0, 1}², the nine wt
    planes of K2)."""
    if h % qy or w % qx:
        raise ValueError(f"rational decode needs qy | H and qx | W; got "
                         f"H={h} qy={qy}, W={w} qx={qx}")
    shifts = shift_offsets(local_size)
    out = {}
    for ax, n, p, q, col in (("y", h, py, qy, 0), ("x", w, px, qx, 1)):
        tab = grid_axis_tables(n, n * p // q, p, local_size)
        signs = [int(np.sign(sh[col])) for sh in shifts]
        iq = np.stack(tab["q"]).astype(np.int32)                  # (p, n/q)
        ik = np.stack([np.stack(tab[sg][0]) for sg in signs], 1)  # (p, S, n/q)
        rel = np.stack([np.stack(tab[sg][1]) for sg in signs], 1)
        d = ik - iq[:, None]
        if np.abs(d).max(initial=0) > 1:
            raise ValueError(f"rational decode {py}/{qy} x {px}/{qx} at "
                             f"{h}x{w}: a key lies {np.abs(d).max()} pixels "
                             f"from its query on axis {ax}")
        out[ax + "q"] = torch.as_tensor(iq, device=device)
        out[ax + "k"] = torch.as_tensor(ik.astype(np.int32), device=device)
        out[ax + "rel"] = torch.as_tensor(rel.astype(np.float32),
                                          device=device)
    return out


def grid_axis_tables(n: int, tn: int, p: int, local_size: int) -> dict:
    """Host index / rel tables of one axis of a dense decode at rational
    scale tn/n = p/q (lowest terms): a copy of the JAX package's
    models/ciaosr.py::_grid_axis_tables, bit-exact.

    It repeats the per-query path's float32 arithmetic op by op
    (make_coord → shift → clip → nearest_index), then slices the length-tn
    vectors into p phase views of length n/q: HR centres can fall on (or
    within an ulp of) an LR nearest-neighbour tie, where any other order of
    operations rounds the other way. Returns {"q": idx} for the unshifted
    query and {sign: (idx, rel)} per shift sign: idx lists of p int64
    vectors (LR index per phase row, border-clamped), rel lists of p
    float64 vectors ((coord_q − coord_k)·n)."""
    f32 = np.float32
    i = np.arange(tn, dtype=np.float32)
    c0 = f32(-1.0) + (f32(2.0) * i + f32(1.0)) / f32(tn)
    cell0 = f32(2.0) / f32(tn)
    r = (f32(1.0) - cell0) / f32(n - 1) if n > 1 else f32(0.0)
    lo, hi = f32(-1 + 1e-6), f32(1 - 1e-6)

    def near(c):
        ix = ((c + f32(1.0)) * f32(n) - f32(1.0)) / f32(2.0)
        return np.clip(np.round(ix).astype(np.int64), 0, n - 1)

    signs = {1: (0,), 2: (-1, 1)}.get(local_size, (-1, 0, 1))
    c0_64 = c0.astype(np.float64)
    out = {"q": [near(c0)[a::p] for a in range(p)]}
    for s in signs:
        cc = c0 if s == 0 else (c0 + f32(s) * r) + f32(1e-6)
        m = near(np.clip(cc, lo, hi))
        rel = (c0_64 - (-1.0 + (2.0 * m + 1.0) / n)) * n
        out[s] = ([m[a::p] for a in range(p)], [rel[a::p] for a in range(p)])
    return out


# ------------------------------------------------------------------ K1 --

def f3p_build_plain(feature, csa, wk0, wvu, wvc):
    """g_k = u@W_k0, g_v = u@W_vu + csa@W_vc (u@W_vu without CSA) with
    u = unfold(feature), or u = feature where W_k0 has C rows (one tap)."""
    u = unfold_taps(feature, taps_of(wk0.shape[0], feature.shape[-1],
                                     "f3p_build"))
    gv = u @ wvu
    return u @ wk0, gv if csa is None else gv + csa @ wvc


# the C entry point's prototype: 7 pointers, B, H, W, C, DC, taps, stream
F3P_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def f3p_build(feature, csa, wk0, wvu, wvc):
    """K1 on CUDA tensors, the plain version on CPU tensors. feature
    (B, H, W, C), csa (B, H, W, DC) or None; W_k0, W_vu: (taps·C, 256);
    W_vc: (DC, 256). Returns g_k, g_v (B, H, W, 256)."""
    if feature.is_cpu:
        return f3p_build_plain(feature, csa, wk0, wvu, wvc)
    b, h, w, _ = feature.shape
    c, dc = widths(feature, csa)
    _check_instance(c, dc, None, "f3p_build")
    taps = taps_of(wk0.shape[0], c, "f3p_build")
    _check_instance(c, dc, taps, "f3p_build")
    _build.check_tensor(feature, (b, h, w, c), "feature")
    if csa is not None:
        _build.check_tensor(csa, (b, h, w, dc), "csa")
    _build.check_tensor(wk0, (taps * c, HID), "wk0")
    _build.check_tensor(wvu, (taps * c, HID), "wvu")
    _build.check_tensor(wvc, (dc, HID), "wvc")
    # one allocation for both outputs (each a contiguous view of it)
    gk, gv = feature.new_empty((2, b, h, w, HID)).unbind(0)
    fn = _build.function("f3p_build", "f3p_build", F3P_ARGTYPES)
    err = fn(feature.data_ptr(), _ptr(csa), wk0.data_ptr(), wvu.data_ptr(),
             wvc.data_ptr(), gk.data_ptr(), gv.data_ptr(), b, h, w, c, dc,
             taps, _build.stream_ptr(feature.device))
    kernels.LAUNCHES["f3p_build"] += 1
    _build.check(err, "f3p_build")
    return gk, gv


# ------------------------------------------------------------------ K2 --

def wt_hoist_plain(feature, wkout, bkout):
    """wt_d = (u ⊙ u_d)@W_kout, ck_d = (u ⊙ u_d)·b_kout for the nine
    edge-clamped shifts d; u_d = u read at clamp(p + d). u is the unfold,
    or the feature itself where W_kout has C rows (one tap)."""
    u = unfold_taps(feature, taps_of(wkout.shape[0], feature.shape[-1],
                                     "wt_hoist"))
    wts, cks = [], []
    for dy, dx in SHIFTS9:
        qk = u * shift_edge(u, dy, dx)
        wts.append(qk @ wkout)
        cks.append(qk @ bkout.to(qk.dtype))
    return torch.stack(wts), torch.stack(cks)


def wt_hoist(feature, wkout, bkout):
    """K2 on CUDA tensors, the plain version on CPU tensors. feature
    (B, H, W, C), W_kout (taps·C, 256), b_kout (taps·C,) f32. Returns wt
    (9, B, H, W, 256) and ck (9, B, H, W) f32."""
    if feature.device.type == "cpu":
        return wt_hoist_plain(feature, wkout, bkout)
    b, h, w, c = feature.shape
    built = sorted({(ci, t) for ci, _, t in INSTANCES})
    taps = taps_of(wkout.shape[0], c, "wt_hoist") \
        if c in (ci for ci, _ in built) else None
    if (c, taps) not in built:
        raise ValueError(f"wt_hoist: the kernel is compiled for (C, taps) "
                         f"in {built}, got ({c}, {taps})")
    _build.check_tensor(feature, (b, h, w, c), "feature")
    _build.check_tensor(wkout, (taps * c, HID), "wkout")
    _build.check_tensor(bkout, (taps * c,), "bkout", torch.float32)
    wt = torch.empty(9, b, h, w, HID, device=feature.device,
                     dtype=torch.bfloat16)
    ck = torch.empty(9, b, h, w, device=feature.device, dtype=torch.float32)
    fn = _build.load("wt_hoist_sm90").wt_hoist
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    err = fn(*(_build.ptr(t) for t in (feature, wkout, bkout, wt, ck)),
             b, h, w, c, taps, _build.stream_ptr(feature.device))
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
    four v-paths blended into outv, then imnet_q. Returns (B, P, H, W, 3).
    The value is [u | csa], u the unfold or (one tap) the feature."""
    dys, dxs = tabs["dys"].tolist(), tabs["dxs"].tolist()
    rely, relx = tabs["rely"], tabs["relx"]
    u = unfold_taps(feature, taps_of(pk["wk0"].shape[0], feature.shape[-1],
                                     "grid_decode"))
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
            x = shift_edge(u, dy, dx)
            if csa is not None:
                x = torch.cat([x, shift_edge(csa, dy, dx)], -1)
            preds.append(x * (hv @ pk["vout"].to(dt) + pk["vbout"].to(dt)))
        out.append(_blend_q(logits, preds, pk, softmax_scale))
    return torch.stack(out, 1)


def _blend_q(logits, preds, pk: dict, softmax_scale: float):
    """Softmax over the shifts, the value blend, then imnet_q → RGB."""
    dt = preds[0].dtype
    attn = torch.softmax(torch.stack(logits, -1) / softmax_scale, -1)
    outv = sum(attn[..., i:i + 1] * preds[i] for i in range(len(preds)))
    hq = torch.relu(outv @ pk["qw0"].to(dt) + pk["qb0"].to(dt))
    hq = _mlp_hidden(hq, pk["qw"].to(dt), pk["qb"].to(dt))
    return hq @ pk["qwout"].to(dt).t() + pk["qbout"].to(dt)


_DECODE_ORDER = ("kw", "vw", "vout", "qw0", "qw", "kb", "vb", "vbout",
                 "qb0", "qb", "krel", "kb0", "vrel", "vb0", "qwout",
                 "qbout")


def _check_decode_inputs(feature, csa, gk, gv, wt, ck, pk: dict,
                         n_shift: int, name: str) -> tuple[int, int, int]:
    """Raise unless the decode kernel's LR inputs and packed weights have
    the widths, dtypes and layout of an instantiation it is compiled for;
    returns its (C, DC, taps)."""
    b, h, w, _ = feature.shape
    C, DC = widths(feature, csa)
    _check_instance(C, DC, None, name)
    taps = taps_of(pk["wk0"].shape[0], C, name)
    _check_instance(C, DC, taps, name)
    if pk["kw"].shape[0] != N_HIDDEN - 1 or pk["qw"].shape[0] != N_HIDDEN - 1:
        raise ValueError(f"grid_decode kernel is built for {N_HIDDEN} "
                         "hidden layers")
    max_shift = 9 if C == 64 else WIDE_MAX_SHIFT
    if not 1 <= n_shift <= max_shift:
        raise ValueError(f"grid_decode at C={C} takes 1..{max_shift} "
                         f"shifts, got {n_shift}")
    _build.check_tensor(feature, (b, h, w, C), "feature")
    if csa is not None:
        _build.check_tensor(csa, (b, h, w, DC), "csa")
    _build.check_tensor(gk, (b, h, w, HID), "gk")
    _build.check_tensor(gv, (b, h, w, HID), "gv")
    _build.check_tensor(wt, (9, b, h, w, HID), "wt")
    _build.check_tensor(ck, (9, b, h, w), "ck", torch.float32)
    bf, f = torch.bfloat16, torch.float32
    dv = taps * C + DC
    shapes = {"kw": ((3, HID, HID), bf), "vw": ((3, HID, HID), bf),
              "vout": ((HID, dv), bf), "qw0": ((dv, HID), bf),
              "qw": ((3, HID, HID), bf), "kb": ((3, HID), f),
              "vb": ((3, HID), f), "vbout": ((dv,), f),
              "qb0": ((HID,), f), "qb": ((3, HID), f),
              "krel": ((2, HID), f), "kb0": ((HID,), f),
              "vrel": ((2, HID), f), "vb0": ((HID,), f),
              "qwout": ((3, HID), f), "qbout": ((3,), f)}
    for k in _DECODE_ORDER:
        _build.check_tensor(pk[k], shapes[k][0], k, shapes[k][1])
    return C, DC, taps


def _ptr(t) -> int:
    """A tensor's device address; 0 for an absent (None) input."""
    return 0 if t is None else t.data_ptr()


def grid_decode(feature, csa, gk, gv, wt, ck, pk: dict, tabs: dict,
                softmax_scale: float):
    """K3 on CUDA tensors, the plain version on CPU tensors. Returns the
    (B, s², H, W, 3) f32 phase images before the bilinear residual."""
    if feature.device.type == "cpu":
        return grid_decode_plain(feature, csa, gk, gv, wt, ck, pk, tabs,
                                 softmax_scale)
    b, h, w, _ = feature.shape
    n_phase, n_shift = tabs["dys"].shape
    c, dc, taps = _check_decode_inputs(feature, csa, gk, gv, wt, ck, pk,
                                       n_shift, "grid_decode")
    f = torch.float32
    _build.check_tensor(tabs["dys"], (n_phase, n_shift), "dys", torch.int32)
    _build.check_tensor(tabs["dxs"], (n_phase, n_shift), "dxs", torch.int32)
    _build.check_tensor(tabs["rely"], (n_phase, n_shift, h), "rely", f)
    _build.check_tensor(tabs["relx"], (n_phase, n_shift, w), "relx", f)
    out = torch.empty(b, n_phase, h, w, 3, device=feature.device, dtype=f)
    args = [feature, csa, gk, gv, wt, ck, *(pk[k] for k in _DECODE_ORDER),
            tabs["dys"], tabs["dxs"], tabs["rely"], tabs["relx"], out]
    ptrs = (ctypes.c_void_p * len(args))(*(_ptr(t) for t in args))
    fn = _build.load("grid_decode_sm90").grid_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    err = fn(ctypes.cast(ptrs, ctypes.c_void_p), b, h, w, c, dc, taps,
             n_phase, n_shift, float(softmax_scale),
             _build.stream_ptr(feature.device))
    kernels.LAUNCHES["grid_decode"] += 1
    _build.check(err, "grid_decode")
    return out


# ------------------------------------------------------ K3, rational --

def take2(t, iy, ix):
    """t (B, H, W, ·) read at rows iy and columns ix (outer product)."""
    return t[:, iy][:, :, ix]


def rational_phases(tabs: dict):
    """Walk the phases of a rational decode in output order (a·px + b):
    per phase, the query rows and columns and, per shift, the key rows,
    key columns, rel rows and rel columns, all from ``rational_tables``."""
    yq, yk, yrel = tabs["yq"].long(), tabs["yk"].long(), tabs["yrel"]
    xq, xk, xrel = tabs["xq"].long(), tabs["xk"].long(), tabs["xrel"]
    for a in range(yk.shape[0]):
        for b in range(xk.shape[0]):
            yield yq[a], xq[b], [(yk[a, i], xk[b, i], yrel[a, i], xrel[b, i])
                                 for i in range(yk.shape[1])]


def grid_decode_rational_plain(feature, csa, gk, gv, wt, ck, pk: dict,
                               tabs: dict, softmax_scale: float):
    """K3's math at a rational scale, from ``rational_tables``: for phase
    (a, b) and shift i the k/v first layers read g_k / g_v at the key
    pixels with the table's rel, the logit reads the wt plane
    d = key − query at the query pixel. Returns (B, py·px, H/qy, W/qx, 3).
    The value is [u | csa], u the unfold or (one tap) the feature."""
    u = unfold_taps(feature, taps_of(pk["wk0"].shape[0], feature.shape[-1],
                                     "grid_decode_rational"))
    dt = gk.dtype
    out = []
    for qy_, qx_, shifts in rational_phases(tabs):
        logits, preds = [], []
        for ky, kx, ry, rx in shifts:
            ry = ry[None, :, None, None].to(dt)
            rx = rx[None, None, :, None].to(dt)

            def first(g, rel, b0):
                return torch.relu(take2(g, ky, kx) + ry * rel[0]
                                  + rx * rel[1] + b0)

            hk = _mlp_hidden(first(gk, pk["krel"].to(dt), pk["kb0"].to(dt)),
                             pk["kw"].to(dt), pk["kb"].to(dt))
            plane = (ky - qy_ + 1)[:, None] * 3 + (kx - qx_ + 1)[None]
            wt_q = wt[plane, :, qy_[:, None], qx_[None]]  # (h, w, B, ·)
            ck_q = ck[plane, :, qy_[:, None], qx_[None]]
            logits.append((wt_q.permute(2, 0, 1, 3) * hk).sum(-1)
                          + ck_q.permute(2, 0, 1).to(dt))
            hv = _mlp_hidden(first(gv, pk["vrel"].to(dt), pk["vb0"].to(dt)),
                             pk["vw"].to(dt), pk["vb"].to(dt))
            x = take2(u, ky, kx)
            if csa is not None:
                x = torch.cat([x, take2(csa, ky, kx)], -1)
            preds.append(x * (hv @ pk["vout"].to(dt) + pk["vbout"].to(dt)))
        out.append(_blend_q(logits, preds, pk, softmax_scale))
    return torch.stack(out, 1)


def grid_decode_rational(feature, csa, gk, gv, wt, ck, pk: dict, tabs: dict,
                         softmax_scale: float):
    """The rational mode of the decode kernel on CUDA tensors, the plain
    version on CPU tensors. Returns the (B, py·px, H/qy, W/qx, 3) f32
    phase images (phase a·px + b) before the bilinear residual."""
    if feature.device.type == "cpu":
        return grid_decode_rational_plain(feature, csa, gk, gv, wt, ck, pk,
                                          tabs, softmax_scale)
    b, h, w, _ = feature.shape
    py, n_shift, oh = tabs["yk"].shape
    px, _, ow = tabs["xk"].shape
    c, dc, taps = _check_decode_inputs(feature, csa, gk, gv, wt, ck, pk,
                                       n_shift, "grid_decode_rational")
    i32, f = torch.int32, torch.float32
    _build.check_tensor(tabs["yq"], (py, oh), "yq", i32)
    _build.check_tensor(tabs["yk"], (py, n_shift, oh), "yk", i32)
    _build.check_tensor(tabs["xq"], (px, ow), "xq", i32)
    _build.check_tensor(tabs["xk"], (px, n_shift, ow), "xk", i32)
    _build.check_tensor(tabs["yrel"], (py, n_shift, oh), "yrel", f)
    _build.check_tensor(tabs["xrel"], (px, n_shift, ow), "xrel", f)
    out = torch.empty(b, py * px, oh, ow, 3, device=feature.device, dtype=f)
    args = [feature, csa, gk, gv, wt, ck, *(pk[k] for k in _DECODE_ORDER),
            tabs["yq"], tabs["yk"], tabs["xq"], tabs["xk"], tabs["yrel"],
            tabs["xrel"], out]
    ptrs = (ctypes.c_void_p * len(args))(*(_ptr(t) for t in args))
    fn = _build.load("grid_decode_sm90").grid_decode_rational
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 11 + [
        ctypes.c_float, ctypes.c_void_p]
    err = fn(ctypes.cast(ptrs, ctypes.c_void_p), b, h, w, c, dc, taps, oh,
             ow, py, px, n_shift, float(softmax_scale),
             _build.stream_ptr(feature.device))
    kernels.LAUNCHES["grid_decode_rational"] += 1
    _build.check(err, "grid_decode_rational")
    return out
