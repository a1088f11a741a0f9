"""Rows 11 and 12: one whole Swin transformer block and its backward —
wrappers, plain versions, weight packing and its transpose, the autograd
Function, and the window helpers both block routes share.

Counterpart of ciaosr_tpu/ops/pallas/swin_block.py::swin_block_fused
(forward, ``_swin_block_call`` / ``_block_kernel``;
csrc/swin_block_sm90.cu),
of its custom VJP (backward, ``_swin_block_bwd_call`` /
``_block_bwd_kernel``; csrc/swin_block_bwd_sm90.cu) and of
models/swinir.py::_attn_mask and WindowAttention._bias. On a token map
that is already rolled by the shift:

  xn = LN1(x); q = xn@Wq·scale + bq·scale; k, v likewise (no scale)
  per window and head: softmax(q_h k_hᵀ + bias_h [+ shift mask]) v_h
  x1 = x + attn@Wp + bp; y = x1 + GELU(LN2(x1)@W1 + b1)@W2 + b2

Casts follow the TPU kernel: every matmul operand in the packed weights'
dtype, every accumulation, softmax, LayerNorm and GELU in f32, x and y f32.

Packed layout (``pack_swin_block``), the kernel's: the residual width C is
zero-padded to CP = 192 and the MLP hidden width to HIDP = 384; head h of
q, k and v owns the 32 columns [32h, 32h + head_dim) of its 192-wide part
(the rest zero), and the proj rows follow the same slots. So a block of
C ≤ 192, heads ≤ 6, head_dim ≤ 32, hidden ≤ 384 and windows of ≤ 64
tokens fits; SwinIR-CiaoSR (180, 6 × 30, 360, 8 × 8) is such a block.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ciaosr_torch.ops import kernels
from ciaosr_torch.ops.kernels import _build

CP, HD, HIDP, NT = 192, 32, 384, 64   # packed widths, tokens per window
LN_EPS = 1e-5
_TENSORS = ("g1", "b1", "wqkv", "bqkv", "wp", "bp", "g2", "b2", "w1", "b1m",
            "w2", "b2m", "bias")


@functools.lru_cache(maxsize=8)
def attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray | None:
    """(nW, N, N) shifted-window mask (0 / −100) of an h × w rolled map,
    windows in row-major order, or None without a shift (a copy of the JAX
    package's models/swinir.py::_attn_mask). Cached for the last few map
    sizes (16 MB at 256 × 256); callers must not write to it."""
    if shift == 0:
        return None
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _bias_index(ws: int, full: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    return ((rel[0] + full - 1) * (2 * full - 1)
            + (rel[1] + full - 1)).reshape(-1)


def relative_bias(table: torch.Tensor, ws: int, full: int) -> torch.Tensor:
    """(heads, ws², ws²) relative-position bias of a runtime window ws ≤
    ``full`` (the configured window size), gathered from the full
    ((2·full − 1)², heads) table with the full window's displacement keys
    (the JAX package's WindowAttention._bias)."""
    n = ws * ws
    idx = torch.as_tensor(_bias_index(ws, full), device=table.device)
    return table[idx].reshape(n, n, -1).permute(2, 0, 1)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, ws², C), windows in row-major order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B·nW, ws², C) → (B, H, W, C)."""
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               c: int) -> torch.Tensor:
    """LayerNorm over the first ``c`` channels of f32 x (mean and variance
    of those only, two-pass as the TPU kernel's), written to every channel:
    padded channels have γ = β = 0 and come out 0."""
    xc = x[..., :c]
    mu = xc.mean(-1, keepdim=True)
    var = (xc - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * g + b


def gelu(z: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU (the reference's nn.GELU())."""
    return 0.5 * z * (1.0 + torch.erf(z * 2.0 ** -0.5))


def _slots(c: int, hd: int, device) -> torch.Tensor:
    """Packed column of each real q/k/v channel: head slot 32h + d."""
    return torch.as_tensor([HD * (i // hd) + i % hd for i in range(c)],
                           device=device)



def _head_major(wqkv: torch.Tensor) -> torch.Tensor:
    """wqkv (CP, 3 CP) → (3 CP, CP): column 192p + 32h + d becomes row
    96h + 32p + d, head h's q, k and v slots in 96 rows."""
    return wqkv.view(CP, 3, CP // HD, HD).permute(2, 1, 3, 0).reshape(
        3 * CP, CP)


@torch.no_grad()
def pack_swin_block(block, ws: int, dtype: torch.dtype) -> dict:
    """A Swin block's weights in the kernel's layout (see the module
    docstring): matrices (in, out) in ``dtype``, LayerNorm and biases f32,
    the q bias pre-scaled by head_dim^-0.5, the relative-position bias
    gathered for window ``ws`` as (heads, ws², ws²) f32. ``wqkv_hm`` holds
    wqkv's columns once more, transposed and head-major (row 96h + 32p + d
    is column 192p + 32h + d: head h's q, k and v slots in 96 rows of the
    192 inputs), the layout in which row 11 streams them. ``block`` has the
    reference's submodules norm1, attn.{qkv, proj,
    relative_position_bias_table}, norm2, mlp.{fc1, fc2}."""
    attn = block.attn
    c = block.norm1.weight.shape[0]
    heads, full = attn.num_heads, attn.window_size
    hd, hid = c // heads, block.mlp.fc1.out_features
    if c > CP or heads * HD > CP or hd > HD or hid > HIDP or ws * ws > NT:
        raise ValueError(
            f"swin block C={c}, heads={heads}, hidden={hid}, window {ws} "
            f"does not fit the packed layout (C ≤ {CP}, heads × {HD} ≤ "
            f"{CP}, head_dim ≤ {HD}, hidden ≤ {HIDP}, ws² ≤ {NT})")
    dev = block.norm1.weight.device
    slot = _slots(c, hd, dev)

    def vec(t, n):   # f32, zero-padded to n
        return F.pad(t.float(), (0, n - t.shape[0]))

    qkv_w, qkv_b = attn.qkv.weight.float(), attn.qkv.bias
    scale = float(hd) ** -0.5
    wqkv = torch.zeros(CP, 3 * CP, device=dev)
    bqkv = torch.zeros(3 * CP, device=dev)
    for part in range(3):
        rows = qkv_w[part * c:(part + 1) * c]           # (out, in)
        wqkv[:c, part * CP + slot] = rows.t()
        if qkv_b is not None:
            b = qkv_b[part * c:(part + 1) * c].float()
            bqkv[part * CP + slot] = b * scale if part == 0 else b
    wp = torch.zeros(CP, CP, device=dev)
    wp[slot, :c] = attn.proj.weight.float().t()
    w1 = torch.zeros(CP, HIDP, device=dev)
    w1[:c, :hid] = block.mlp.fc1.weight.float().t()
    w2 = torch.zeros(HIDP, CP, device=dev)
    w2[:hid, :c] = block.mlp.fc2.weight.float().t()
    wqkv = wqkv.to(dtype)
    return {
        "g1": vec(block.norm1.weight, CP), "b1": vec(block.norm1.bias, CP),
        "wqkv": wqkv, "wqkv_hm": _head_major(wqkv), "bqkv": bqkv,
        "wp": wp.to(dtype), "bp": vec(attn.proj.bias, CP),
        "g2": vec(block.norm2.weight, CP), "b2": vec(block.norm2.bias, CP),
        "w1": w1.to(dtype), "b1m": vec(block.mlp.fc1.bias, HIDP),
        "w2": w2.to(dtype), "b2m": vec(block.mlp.fc2.bias, CP),
        "bias": relative_bias(attn.relative_position_bias_table.float(), ws,
                              full).contiguous(),
    }


def _mm(a: torch.Tensor, w: torch.Tensor, taps: dict | None = None,
        key: str = "") -> torch.Tensor:
    """a @ w with both operands rounded to w's dtype, summed in f32. With
    ``taps``, taps[key] becomes [the rounded a, the product's gradient],
    the gradient filled in by a hook when autograd reaches the product."""
    a = a.to(w.dtype).float()
    out = a @ w.float()
    if taps is not None:
        taps[key] = [a.detach(), None]
        out.register_hook(lambda g: taps[key].__setitem__(1, g))
    return out


def swin_block_plain(x: torch.Tensor, pk: dict, ws: int, shift: int,
                     taps: dict | None = None) -> torch.Tensor:
    """The block on the rolled f32 token map x (B, H, W, C) with packed
    weights ``pk``; (B, H, W, C) f32. H and W are multiples of ws. With
    ``taps`` (a dict, under autograd), each weight product's operand and
    output gradient are recorded under the weight's key (``_mm``)."""
    b, h, w, c = x.shape
    heads = pk["bias"].shape[0]
    n = ws * ws
    scale = float(c // heads) ** -0.5
    dt = pk["wqkv"].dtype
    xp = F.pad(x.float(), (0, CP - c))
    qkv = _mm(layer_norm(xp, pk["g1"], pk["b1"], c), pk["wqkv"], taps,
              "wqkv")
    q = qkv[..., :CP] * scale + pk["bqkv"][:CP]
    k = qkv[..., CP:2 * CP] + pk["bqkv"][CP:2 * CP]
    v = qkv[..., 2 * CP:] + pk["bqkv"][2 * CP:]

    def heads_of(t):   # (B, H, W, CP) → (B·nW, heads, N, HD) in dt
        t = window_partition(t.to(dt).float(), ws)
        return t.reshape(-1, n, CP // HD, HD)[:, :, :heads].transpose(1, 2)

    logits = heads_of(q) @ heads_of(k).transpose(-1, -2) + pk["bias"]
    mask = attn_mask(h, w, ws, shift)
    if mask is not None:
        nw = mask.shape[0]
        logits = (logits.reshape(b, nw, heads, n, n)
                  + torch.as_tensor(mask, device=x.device)[None, :, None])
        logits = logits.reshape(-1, heads, n, n)
    p = torch.softmax(logits, -1).to(dt).float()
    o = (p @ heads_of(v)).transpose(1, 2)                 # (B·nW, N, heads, HD)
    o = F.pad(o, (0, 0, 0, CP // HD - heads)).reshape(-1, n, CP)
    proj = _mm(window_reverse(o, ws, h, w), pk["wp"], taps, "wp")
    x1 = xp + proj + pk["bp"]
    hdn = gelu(_mm(layer_norm(x1, pk["g2"], pk["b2"], c), pk["w1"], taps,
                   "w1") + pk["b1m"])
    y = x1 + _mm(hdn, pk["w2"], taps, "w2") + pk["b2m"]
    return y[..., :c].contiguous()


def _check_packed(pk: dict, heads_max: int) -> int:
    f, bf = torch.float32, torch.bfloat16
    heads, n = pk["bias"].shape[0], pk["bias"].shape[1]
    if not 1 <= heads <= heads_max:
        raise ValueError(f"swin_block kernel takes 1..{heads_max} heads, "
                         f"got {heads}")
    shapes = {"g1": ((CP,), f), "b1": ((CP,), f), "wqkv": ((CP, 3 * CP), bf),
              "bqkv": ((3 * CP,), f), "wp": ((CP, CP), bf), "bp": ((CP,), f),
              "g2": ((CP,), f), "b2": ((CP,), f), "w1": ((CP, HIDP), bf),
              "b1m": ((HIDP,), f), "w2": ((HIDP, CP), bf),
              "b2m": ((CP,), f), "bias": ((heads, n, n), f)}
    for k in _TENSORS:
        _build.check_tensor(pk[k], shapes[k][0], k, shapes[k][1])
    return heads


def _check_call(x: torch.Tensor, pk: dict, ws: int, shift: int,
                name: str) -> int:
    """Raise unless the kernels take this map, window and packing; returns
    the head count."""
    b, h, w, c = x.shape
    _build.check_tensor(x, (b, h, w, c), "x", torch.float32)
    heads = _check_packed(pk, CP // HD)
    if not (1 <= ws and ws * ws <= NT and h % ws == 0 and w % ws == 0
            and pk["bias"].shape[1] == ws * ws and c <= CP
            and c // heads <= HD and 0 <= shift < ws):
        raise ValueError(f"{name} kernel: {h}x{w}x{c} map, window {ws}, "
                         f"shift {shift}, {heads} heads is outside what it "
                         f"takes (ws² ≤ {NT}, C ≤ {CP}, head_dim ≤ {HD})")
    return heads


def swin_block(x: torch.Tensor, pk: dict, ws: int,
               shift: int) -> torch.Tensor:
    """Row 11 on CUDA tensors, the plain version on CPU tensors. x: the
    rolled (B, H, W, C) f32 token map, H and W multiples of ws ≤ 8;
    ``pk``: ``pack_swin_block``'s output in bf16. Returns (B, H, W, C)
    f32."""
    if x.device.type == "cpu":
        return swin_block_plain(x, pk, ws, shift)
    # one persistent CTA a multiprocessor, walking over window pairs
    return launch_swin_block(x, pk, ws, shift, _sms(x.device))


# row 11's kernel streams wqkv in its head-major copy
_FWD_TENSORS = tuple("wqkv_hm" if k == "wqkv" else k for k in _TENSORS)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_swin_block(x: torch.Tensor, pk: dict, ws: int, shift: int,
                      max_ctas: int) -> torch.Tensor:
    """One launch of row 11 (``csrc/swin_block_sm90.cu``) on CUDA tensors:
    ``max_ctas`` > 0 caps the grid (each CTA walks over window pairs), 0
    launches one CTA a pair of windows."""
    b, h, w, c = x.shape
    heads = _check_call(x, pk, ws, shift, "swin_block")
    _build.check_tensor(pk["wqkv_hm"], (CP // HD * 3 * HD, CP), "wqkv_hm")
    out = torch.empty_like(x)
    args = [x, *(pk[k] for k in _FWD_TENSORS), out]
    ptrs = (ctypes.c_void_p * len(args))(*(t.data_ptr() for t in args))
    fn = _build.load("swin_block_sm90").swin_block
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    err = fn(ctypes.cast(ptrs, ctypes.c_void_p), b, h, w, c, heads, ws,
             shift, float(c // heads) ** -0.5, int(max_ctas),
             _build.stream_ptr(x.device))
    kernels.LAUNCHES["swin_block"] += 1
    _build.check(err, "swin_block")
    return out


# ---------------------------------------------------------------- backward
# Row 12 (csrc/swin_block_bwd_sm90.cu). The kernel returns one flat f32 buffer:
# the per-window sums (these vectors, then the (heads, N, N) bias
# gradient), then the weight gradients (these matrices, row-major).
# token chunks of the weight-gradient products (a CTA per output tile and
# chunk: 8 x 8): at the 002 batch the fewest chunk partials for the sum,
# and the weight-gradient kernel no slower than at 12-32 chunks on an H100
# (tools/swin_wgrad_probe.py, which sets other counts here)
WGRAD_SPLITS = 8
_VECTORS = (("g1", CP), ("b1", CP), ("bqkv", 3 * CP), ("bp", CP),
            ("g2", CP), ("b2", CP), ("b1m", HIDP), ("b2m", CP))
_MATRICES = (("wqkv", (CP, 3 * CP)), ("wp", (CP, CP)), ("w1", (CP, HIDP)),
             ("w2", (HIDP, CP)))
# per-token operand pairs of the weight gradients: (name, width)
_PAIRS = (("xn", CP), ("dqkv", 3 * CP), ("o", CP), ("dx1", CP), ("yn", CP),
          ("dz1", HIDP), ("hdn", HIDP), ("dyb", CP))


def swin_block_bwd_plain(x: torch.Tensor, dy: torch.Tensor, pk: dict,
                         ws: int, shift: int) -> tuple[torch.Tensor, dict]:
    """Autograd through ``swin_block_plain`` on f32 copies of x and the
    packed tensors: (dx, gradients of the packed tensors, f32, keyed as
    ``pk``). The q-bias entry is the gradient of the pre-scaled b_q·scale."""
    with torch.enable_grad():   # clones: the packs may be inference tensors
        xl = x.detach().float().clone().requires_grad_()
        leaves = {k: pk[k].detach().float().clone().requires_grad_()
                  for k in _TENSORS}
        y = swin_block_plain(xl, leaves, ws, shift)
        grads = torch.autograd.grad(y, [xl, *leaves.values()], dy.float())
    return grads[0], dict(zip(_TENSORS, grads[1:]))


def swin_block_pairs_plain(x: torch.Tensor, dy: torch.Tensor, pk: dict,
                           ws: int, shift: int) -> list[torch.Tensor]:
    """The eight per-token operand pairs of the weight gradients that row
    12's window kernel writes, in ``_PAIRS`` order, by autograd hooks on
    ``swin_block_plain``'s weight products (x, dy as in
    ``swin_block_bwd_plain``; ``pk`` in its own dtype): xn, dqkv = [dq·scale
    | dk | dv] (the gradient of xn @ wqkv), o, dx1, yn, dz1 (before GELU),
    hdn and dy, each (B·nW·NT, width) f32 in window order, NT rows a window,
    rows past ws² zero. Operands are rounded as the products round them;
    the kernel writes every pair in bf16."""
    taps: dict = {}
    with torch.enable_grad():   # clones: the packs may be inference tensors
        xl = x.detach().float().clone().requires_grad_()
        leaves = {k: v.detach().clone() for k, v in pk.items()}
        y = swin_block_plain(xl, leaves, ws, shift, taps)
        torch.autograd.grad(y, xl, dy.float())
    n = ws * ws

    def rows(t):   # (B, H, W, width) map → (B·nW·NT, width)
        t = F.pad(window_partition(t, ws), (0, 0, 0, NT - n))
        return t.reshape(-1, t.shape[-1]).contiguous()

    return [rows(t) for k, _ in _MATRICES for t in taps[k]]


def swin_block_wgrad_plain(pairs: list[torch.Tensor]) -> torch.Tensor:
    """The weight-gradient products of row 12 over all tokens, (LD,) f32:
    Wqkv, Wp, W1, W2 = aᵀ b of each (a, b) pair in ``_PAIRS`` order, summed
    in f32, flattened row-major one after another (the layout of a row of
    the kernel's partials)."""
    return torch.cat([(a.float().t() @ b.float()).reshape(-1)
                      for a, b in zip(pairs[0::2], pairs[1::2])])


def swin_block_wgrad(pairs: list[torch.Tensor]) -> torch.Tensor:
    """Row 12's weight-gradient kernel (``swin_wgrad_sm90``) on CUDA
    tensors: the bf16 pairs (T, width), T a multiple of NT, in ``_PAIRS``
    order → f32 partials (WGRAD_SPLITS, LD), row i the products over the
    i-th chunk of tokens (rows past the last token: 0). On CPU tensors the
    plain version as one chunk, (1, LD)."""
    if pairs[0].device.type == "cpu":
        return swin_block_wgrad_plain(pairs)[None]
    t, splits = pairs[0].shape[0], WGRAD_SPLITS
    if (len(pairs) != len(_PAIRS) or t < NT or t % NT
            or not 1 <= splits < 65536):
        raise ValueError(f"swin_block_wgrad takes {len(_PAIRS)} pairs of T "
                         f"rows, T a positive multiple of {NT}, and 1 .. "
                         f"65535 splits; got {len(pairs)} pairs, T = {t}, "
                         f"{splits} splits")
    for (name, width), p in zip(_PAIRS, pairs):
        _build.check_tensor(p, (t, width), name)
        if p.device != pairs[0].device:
            raise ValueError(f"{name} is on {p.device}, xn on "
                             f"{pairs[0].device}")
    ld = sum(r * cl for _, (r, cl) in _MATRICES)
    part = torch.empty(splits, ld, device=pairs[0].device)
    args = [*pairs, part]
    ptrs = (ctypes.c_void_p * len(args))(*(a.data_ptr() for a in args))
    fn = _build.load("swin_block_bwd_sm90").swin_block_wgrad
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    err = fn(ctypes.cast(ptrs, ctypes.c_void_p), t, splits,
             _build.stream_ptr(part.device))
    kernels.LAUNCHES["swin_block_wgrad"] += 1
    _build.check(err, "swin_block_wgrad")
    return part


def _split_grads(flat: torch.Tensor, heads: int, n: int) -> dict:
    out, at = {}, 0
    for k, size in _VECTORS:
        out[k] = flat[at:at + size]
        at += size
    out["bias"] = flat[at:at + heads * n * n].view(heads, n, n)
    at += heads * n * n
    for k, shape in _MATRICES:
        out[k] = flat[at:at + shape[0] * shape[1]].view(shape)
        at += shape[0] * shape[1]
    return out


def launch_swin_bwd_window(x: torch.Tensor, dy: torch.Tensor, pk: dict,
                           ws: int, shift: int):
    """One launch of row 12's window kernel (``swin_bwd_sm90``) on CUDA
    tensors: dx (f32), the eight bf16 pairs (``_PAIRS``, NT rows a window)
    and the f32 per-window partial rows (nW, lw)."""
    b, h, w, c = x.shape
    heads = _check_call(x, pk, ws, shift, "swin_block_bwd")
    _build.check_tensor(dy, (b, h, w, c), "dy", torch.float32)
    _build.check_tensor(pk["wqkv_hm"], (CP // HD * 3 * HD, CP), "wqkv_hm")
    n = ws * ws
    nwin = b * (h // ws) * (w // ws)
    lw = sum(size for _, size in _VECTORS) + heads * n * n
    dev = x.device
    dx = torch.empty_like(x)
    pairs = [torch.empty(nwin * NT, width, device=dev, dtype=torch.bfloat16)
             for _, width in _PAIRS]
    part = torch.empty(nwin, lw, device=dev)
    # the window kernel streams wqkv in its head-major copy, as row 11
    args = [x, dy, *(pk[k] for k in _FWD_TENSORS), dx, *pairs, part]
    ptrs = (ctypes.c_void_p * len(args))(*(t.data_ptr() for t in args))
    fn = _build.load("swin_block_bwd_sm90").swin_block_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    err = fn(ctypes.cast(ptrs, ctypes.c_void_p), b, h, w, c, heads, ws,
             shift, float(c // heads) ** -0.5, _build.stream_ptr(dev))
    kernels.LAUNCHES["swin_block_bwd"] += 1
    _build.check(err, "swin_block_bwd")
    return dx, pairs, part


def swin_block_bwd(x: torch.Tensor, dy: torch.Tensor, pk: dict, ws: int,
                   shift: int) -> tuple[torch.Tensor, dict]:
    """Row 12 on CUDA tensors, the plain version on CPU tensors: the
    backward of ``swin_block`` at the rolled f32 map x (B, H, W, C) for the
    output cotangent dy (same shape, f32). Returns dx (f32) and the packed
    tensors' gradients (f32, keyed as ``pk``; padded entries 0), summed in
    a fixed order (reproducible run to run)."""
    if x.device.type == "cpu":
        return swin_block_bwd_plain(x, dy, pk, ws, shift)
    dx, pairs, part = launch_swin_bwd_window(x, dy, pk, ws, shift)
    flat = swin_block_gsum(part, swin_block_wgrad(pairs))
    return dx, _split_grads(flat, pk["bias"].shape[0], ws * ws)


def swin_block_gsum(part: torch.Tensor, wpart: torch.Tensor) -> torch.Tensor:
    """Row 12's sum kernel (``swin_gsum_kernel``) on CUDA tensors: the
    window kernel's partial rows part (nW, lw) and the weight-gradient
    kernel's chunk partials wpart (splits, ld), f32 → their column sums in
    a fixed order, (lw + ld,) f32. On CPU tensors the same sums by
    ``Tensor.sum``."""
    if part.device.type == "cpu":
        return torch.cat([part.sum(0), wpart.sum(0)])
    (nwin, lw), (ns, ld) = part.shape, wpart.shape
    _build.check_tensor(part, (nwin, lw), "part", torch.float32)
    _build.check_tensor(wpart, (ns, ld), "wpart", torch.float32)
    flat = torch.empty(lw + ld, device=part.device)
    fn = _build.load("swin_block_bwd_sm90").swin_block_gsum
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    err = fn(_build.ptr(part), nwin, lw, _build.ptr(wpart), ns, ld,
             _build.ptr(flat), _build.stream_ptr(part.device))
    kernels.LAUNCHES["swin_block_gsum"] += 1
    _build.check(err, "swin_block_gsum")
    return flat


@functools.lru_cache(maxsize=None)
def _bias_gather(ws: int, full: int) -> np.ndarray:
    """(table rows, k) indices into the ws⁴ (query, key) pairs that read
    each row of the bias table (``_bias_index``), padded with ws⁴ (a zero
    row appended by the caller)."""
    idx = _bias_index(ws, full)
    groups = [np.flatnonzero(idx == t) for t in range((2 * full - 1) ** 2)]
    out = np.full((len(groups), max(len(g) for g in groups)), idx.size)
    for t, g in enumerate(groups):
        out[t, :len(g)] = g
    return out


def unpack_swin_grads(block, grads: dict, ws: int) -> dict:
    """The transpose of ``pack_swin_block``: gradients of the packed tensors
    (``swin_block_bwd``'s) → gradients of the block's parameters, keyed by
    their ``named_parameters`` names, each in its parameter's shape, f32.
    Head slots are gathered back, padding is dropped, the q-bias gradient
    takes the pre-scale's factor, and the (heads, ws², ws²) bias gradient
    is summed into the relative-position table in a fixed order. A
    gradient of ``wqkv_hm``, where given, is folded into wqkv's."""
    attn = block.attn
    c = block.norm1.weight.shape[0]
    heads, full = attn.num_heads, attn.window_size
    hd, hid = c // heads, block.mlp.fc1.out_features
    g = dict(grads)
    if "wqkv_hm" in g:   # the forward's copy of wqkv (never from row 12)
        g["wqkv"] = g["wqkv"] + g.pop("wqkv_hm").view(
            CP // HD, 3, HD, CP).permute(3, 1, 0, 2).reshape(CP, 3 * CP)
    slot = _slots(c, hd, g["g1"].device)
    out = {
        "norm1.weight": g["g1"][:c], "norm1.bias": g["b1"][:c],
        "attn.qkv.weight": torch.cat([g["wqkv"][:c, p * CP + slot].t()
                                      for p in range(3)]),
        "attn.proj.weight": g["wp"][slot, :c].t(),
        "attn.proj.bias": g["bp"][:c],
        "norm2.weight": g["g2"][:c], "norm2.bias": g["b2"][:c],
        "mlp.fc1.weight": g["w1"][:c, :hid].t(), "mlp.fc1.bias": g["b1m"][:hid],
        "mlp.fc2.weight": g["w2"][:hid, :c].t(), "mlp.fc2.bias": g["b2m"][:c],
    }
    if attn.qkv.bias is not None:
        out["attn.qkv.bias"] = torch.cat([g["bqkv"][slot] * hd ** -0.5,
                                          g["bqkv"][CP + slot],
                                          g["bqkv"][2 * CP + slot]])
    n = ws * ws
    flat = g["bias"].permute(1, 2, 0).reshape(n * n, heads)
    flat = torch.cat([flat, flat.new_zeros(1, heads)])
    gather = torch.as_tensor(_bias_gather(ws, full), device=flat.device)
    out["attn.relative_position_bias_table"] = flat[gather].sum(1)
    return {k: v.contiguous() for k, v in out.items()}


class SwinBlockFunction(torch.autograd.Function):
    """One Swin block on the rolled map, differentiable: row 11 forward and
    row 12 backward (their plain versions on CPU tensors). Inputs are x and
    the block's f32 parameters in ``named_parameters`` order, so their
    gradients come back in f32; the packed bf16 copies are made inside
    (``block.packed``) and are not inputs. Only x is saved: the backward
    recomputes the block, as the TPU kernel's custom VJP does."""

    @staticmethod
    def forward(ctx, x, block, ws, shift, dtype, *params):
        pk = block.packed(ws, dtype)
        ctx.save_for_backward(x)
        ctx.block, ctx.pk, ctx.ws, ctx.shift = block, pk, ws, shift
        return swin_block(x, pk, ws, shift)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        dx, g = swin_block_bwd(x, dy.float().contiguous(), ctx.pk, ctx.ws,
                               ctx.shift)
        grads = unpack_swin_grads(ctx.block, g, ctx.ws)
        return (dx, None, None, None, None,
                *(grads[k] for k, _ in ctx.block.named_parameters()))
