"""The CSA middle (average=True) in the stencil form: K4 and row 5 —
wrappers and plain version.

K4 ``csa_stencil_fused`` is the counterpart of
ciaosr_tpu/ops/pallas/csa_attention.py::csa_stencil_fused, row 5
``csa_stencil`` that of ::csa_stencil. They compute the same function:
K4 (csrc/csa_stencil_sm90.cu, which row 6 ``csa_fused`` launches too)
recomputes the attention's stencil halo on ``wgmma``, row 5
(csrc/csa_stencil.cu) writes the normalized attention Ā (B, P, L) to
device memory and reads it back. Contract: match
(B, Hp, Wp, Cr), keys (B, L, 9Cr) L2-normalized 3×3 key patches of the
s-downsampled match map (L = Hp/s · Wp/s), embed (B, Hp, Wp, C). Returns
(B, s·Hp, s·Wp, C) f32, before the down conv and the /6.

Widths. The kernels are compiled for the (Cr, C) pairs of ``INSTANCES``
at s = 2: the flagship's (32, 64) and (96, 192), which config 001
swinir's (90, 180) reaches zero-padded (``padded_widths``; the model pads,
``models/csa.py``). At the flagship pair K4 and row 6 run
csa_stencil_sm90's one-pass kernels and row 5 its own csa_stencil.cu. At
the wide pair all three launch csa_stencil_sm90's two-kernel form, which
is row 5's TPU design: the attention (raw scores, with each row's max
and sum) through device memory, then the stencil product. Its scores
take 4PL bytes, so it runs over blocks of output rows whose scores fit a
budget (``wide_blocks``, 2 GiB by default: a 192² tile is one block).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ciaosr_torch.ops import kernels
from ciaosr_torch.ops.kernels import _build
from ciaosr_torch.ops.neighborhood import extract_patches_same

# the (Cr, C) pairs the kernels are compiled for, at s = S; the flagship's
# first
INSTANCES = ((32, 64), (96, 192))
CR, C = INSTANCES[0]
S = 2
# f32 elements of one (query rows, L) attention block of a plain version
PLAIN_BLOCK = 1 << 27
# bytes of raw scores one launch of the wide pair may write
SCORES_BUDGET = 2 << 30
# the wide pair's query tile side and queries per scores CTA
TILE, SCORES_CTA = 8, 64


def row_blocks(n: int, per_row: int, halo: int = 0) -> list[tuple[int, int]]:
    """[start, stop) blocks of n rows, each with its ±halo rows holding at
    most PLAIN_BLOCK elements of per_row each (at least one row)."""
    step = max(1, PLAIN_BLOCK // per_row - 2 * halo)
    return [(i, min(i + step, n)) for i in range(0, n, step)]


def phase_planes(embed: torch.Tensor, s: int) -> torch.Tensor:
    """(B, Hp, Wp, C) → (B, L, s²C):
    P_l[(a, b), c] = embed[s·ly + a, s·lx + b, c]."""
    b, hp, wp, c = embed.shape
    ph = embed.reshape(b, hp // s, s, wp // s, s, c)
    return ph.permute(0, 1, 3, 2, 4, 5).reshape(b, (hp // s) * (wp // s),
                                                s * s * c)


def csa_stencil_fused_plain(match: torch.Tensor, keys: torch.Tensor,
                            embed: torch.Tensor, scale: float,
                            s: int) -> torch.Tensor:
    """Scores, softmax over L, the 9-point diagonal stencil on the
    attention map, one (P, L)@(L, s²C) product, pixel shuffle — in f32
    (ciaosr_tpu/models/csa.py::_stencil_reconstruct), over blocks of query
    rows with their ±1-row stencil halo."""
    b, hp, wp, c = embed.shape
    hq, wq = hp // s, wp // s
    x_nb = extract_patches_same(match.float(), 3, 1).reshape(b, hp, wp, -1)
    kt = keys.float().transpose(1, 2)
    ph = phase_planes(embed.float(), s)
    outs = []
    for y0, y1 in row_blocks(hp, wp * hq * wq, halo=1):
        a0, a1 = max(y0 - 1, 0), min(y1 + 1, hp)
        attn = torch.softmax(
            x_nb[:, a0:a1].reshape(b, -1, x_nb.shape[-1]) @ kt * scale, -1)
        # query rows y0 − 1 .. y1 (zero off the grid), keys padded by one
        a5 = F.pad(attn.reshape(b, a1 - a0, wp, hq, wq),
                   (1, 1, 1, 1, 1, 1, 1 - (y0 - a0), 1 - (a1 - y1)))
        n = y1 - y0
        m = sum(a5[:, dy:dy + n, dx:dx + wp, dy:dy + hq, dx:dx + wq]
                for dy in range(3) for dx in range(3))
        out = m.reshape(b, n * wp, hq * wq) @ ph
        outs.append(out.reshape(b, n, wp, s, s, c).permute(0, 1, 3, 2, 4, 5)
                    .reshape(b, n * s, wp * s, c))
    return torch.cat(outs, 1)


# row 5 computes the same function as K4; only the kernels differ
csa_stencil_plain = csa_stencil_fused_plain


def padded_widths(cr: int, c: int) -> tuple[int, int]:
    """The smallest compiled (Cr, C) pair that holds cr and c; (cr, c)
    itself past the widest."""
    return min((p for p in INSTANCES if p[0] >= cr and p[1] >= c),
               default=(cr, c))


def pad_maps(match: torch.Tensor, keys: torch.Tensor,
             embed: torch.Tensor) -> tuple:
    """match (B, Hp, Wp, Cr), keys (B, L, 9Cr) and embed (B, Hp, Wp, C)
    zero-padded to the compiled pair ``padded_widths`` gives (the keys per
    tap), contiguous; the tensors themselves where no padding is needed.
    Zero match channels change no score and no key norm; zero embed
    channels give output channels that the caller crops."""
    b, cr, c = match.shape[0], match.shape[-1], embed.shape[-1]
    crp, cp = padded_widths(cr, c)
    if crp != cr:
        match = F.pad(match, (0, crp - cr)).contiguous()
        keys = F.pad(keys.reshape(b, -1, 9, cr), (0, crp - cr)).reshape(
            b, -1, 9 * crp)
    if cp != c:
        embed = F.pad(embed, (0, cp - c)).contiguous()
    return match, keys, embed


def check_inputs(name: str, match, keys, embed,
                 s: int) -> tuple[int, int, int]:
    """Raise unless the CSA middle's kernels take these inputs; returns
    (B, Hp, Wp)."""
    b, hp, wp, c = embed.shape
    cr = match.shape[-1]
    if s != S or (cr, c) not in INSTANCES:
        built = " or ".join(f"Cr={p}, C={q}" for p, q in INSTANCES)
        raise ValueError(f"{name} kernel is built for s={S} and {built}; "
                         f"got s={s}, C={c}, Cr={cr}")
    if hp % s or wp % s:
        raise ValueError(f"{name} needs Hp, Wp divisible by {s}")
    _build.check_tensor(match, (b, hp, wp, cr), "match")
    _build.check_tensor(keys, (b, (hp // s) * (wp // s), 9 * cr), "keys")
    _build.check_tensor(embed, (b, hp, wp, c), "embed")
    return b, hp, wp


def scores_stride(hp: int, wp: int, s: int = S) -> int:
    """ldS, the f32 row stride of the wide pair's scores: L rounded up to
    a multiple of 4."""
    return -(-(hp // s) * (wp // s) // 4) * 4


def wide_band(hp: int, wp: int, y0: int, y1: int) -> tuple[int, int]:
    """The query pixels [q0, q1) whose scores the output rows [y0, y1)
    need: the attention rows y0 − 1 .. y1 of the 3×3 stencil, cut at the
    grid, with q0 rounded down to a scores CTA (so that every scores CTA
    of a block is one of the unblocked launch)."""
    q0 = max(y0 - 1, 0) * wp // SCORES_CTA * SCORES_CTA
    return q0, min(y1 + 1, hp) * wp


def wide_blocks(b: int, hp: int, wp: int,
                budget: int = SCORES_BUDGET) -> list[tuple[int, int]]:
    """[y0, y1) blocks of the Hp output rows for the wide pair, in order:
    each as tall as its scores (B · (q1 − q0) · ldS f32, ``wide_band``)
    allow within ``budget`` bytes, in multiples of the 8-row query tile
    while at least one tile fits, else of single rows; one block (0, Hp)
    wherever the whole map fits. A block holds one row even where its
    scores alone pass the budget."""
    row_bytes = 4 * b * scores_stride(hp, wp)

    def fits(y0, y1):
        q0, q1 = wide_band(hp, wp, y0, y1)
        return (q1 - q0) * row_bytes <= budget

    blocks, y0 = [], 0
    while y0 < hp:
        y1 = hp
        while y1 - y0 > 1 and not fits(y0, y1):
            y1 = y1 - 1 if y1 - y0 <= TILE else max(
                y0 + TILE, (y1 - 1) // TILE * TILE)
        blocks.append((y0, y1))
        y0 = y1
    return blocks


def launch_stencil_sm90(name: str, match: torch.Tensor, keys: torch.Tensor,
                       embed: torch.Tensor, scale: float, s: int,
                       budget: int = SCORES_BUDGET) -> torch.Tensor:
    """The stencil-form kernels of csrc/csa_stencil_sm90.cu on CUDA
    tensors, each launch counted under ``name``: K4, row 5 (wide pair
    only) and row 6 compute the same function from the same inputs and
    launch them. At the flagship pair, one launch; at the wide pair one
    launch a block of ``wide_blocks(..., budget)``, whose raw scores go
    through device memory (one buffer of the largest block's, reused)."""
    b, hp, wp = check_inputs(name, match, keys, embed, s)
    c = embed.shape[-1]
    dev = match.device
    m_buf = torch.empty(b, hp * wp, device=dev, dtype=torch.float32)
    l_buf = torch.empty_like(m_buf)
    out = torch.empty(b, s * hp, s * wp, c, device=dev, dtype=torch.float32)
    if c == C:
        entry, scratch, bands = "csa_stencil_sm90", (m_buf, l_buf), [()]
    else:
        bands = [(y0, y1, *wide_band(hp, wp, y0, y1))
                 for y0, y1 in wide_blocks(b, hp, wp, budget)]
        s_buf = torch.empty(b * max(q1 - q0 for _, _, q0, q1 in bands),
                            scores_stride(hp, wp), device=dev,
                            dtype=torch.float32)
        entry, scratch = "csa_stencil_sm90_wide", (s_buf, m_buf, l_buf)
    fn = getattr(_build.load("csa_stencil_sm90"), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (4 + len(scratch)) + [
        ctypes.c_int] * (3 + len(bands[0])) + [ctypes.c_float,
                                               ctypes.c_void_p]
    for band in bands:
        err = fn(*(_build.ptr(t) for t in (match, keys, embed, *scratch,
                                           out)),
                 b, hp, wp, *band, float(scale), _build.stream_ptr(dev))
        kernels.LAUNCHES[name] += 1
        _build.check(err, name)
    return out


def csa_stencil_fused(match: torch.Tensor, keys: torch.Tensor,
                      embed: torch.Tensor, scale: float,
                      s: int) -> torch.Tensor:
    """K4 on CUDA tensors, the plain version on CPU tensors."""
    if match.device.type == "cpu":
        return csa_stencil_fused_plain(match, keys, embed, scale, s)
    return launch_stencil_sm90("csa_stencil_fused", match, keys, embed,
                               scale, s)


def csa_stencil(match: torch.Tensor, keys: torch.Tensor,
                embed: torch.Tensor, scale: float, s: int) -> torch.Tensor:
    """Row 5 on CUDA tensors, the plain version on CPU tensors. At the
    flagship pair csrc/csa_stencil.cu (Ā through device memory:
    B·P·⌈L/64⌉·64 bf16 scratch); at the wide pair the two-kernel form of
    csrc/csa_stencil_sm90.cu over row blocks (``launch_stencil_sm90``)."""
    if match.device.type == "cpu":
        return csa_stencil_plain(match, keys, embed, scale, s)
    if embed.shape[-1] != C:
        return launch_stencil_sm90("csa_stencil", match, keys, embed, scale,
                                   s)
    b, hp, wp = check_inputs("csa_stencil", match, keys, embed, s)
    dev = match.device
    lda = -(-keys.shape[1] // 64) * 64
    m_buf = torch.empty(b, hp * wp, device=dev, dtype=torch.float32)
    l_buf = torch.empty_like(m_buf)
    abar = torch.empty(b, hp * wp, lda, device=dev, dtype=torch.bfloat16)
    out = torch.empty(b, s * hp, s * wp, C, device=dev, dtype=torch.float32)
    fn = _build.load("csa_stencil").csa_stencil
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    err = fn(*(_build.ptr(t) for t in (match, keys, embed, m_buf, l_buf,
                                       abar, out)),
             b, hp, wp, lda, float(scale), _build.stream_ptr(dev))
    kernels.LAUNCHES["csa_stencil"] += 1
    _build.check(err, "csa_stencil")
    return out
