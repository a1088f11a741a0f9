"""Operations and bytes of the CiaoSR generator's functions at real widths,
and the least time an H100 needs for them.

Every count is the work the function needs, read off the configuration's
widths and the call's shapes: a product of an (m × k) and a (k × n)
matrix is 2mkn operations; each input byte is read once and each output
byte written once. Paddings the program adds (C = 180 run at 192) are
not counted. ``least_s`` is max(operations / peak, bytes / bandwidth).

Peaks: NVIDIA H100 SXM data sheet, dense, without sparsity.
"""

from __future__ import annotations

from dataclasses import dataclass

PEAK_BF16 = 989e12      # FLOP/s, tensor cores, bf16 in, f32 accumulate
PEAK_F32 = 67e12        # FLOP/s, float32 outside the tensor cores
PEAK_BYTES = 3.35e12    # bytes/s, HBM3
TRUNKS = ("RDN", "SwinIR")   # the trunks whose work is counted here
NEIGHBOURS = 9          # LR neighbours a local-ensemble shift can reach


@dataclass
class Work:
    flops: float = 0.0
    nbytes: float = 0.0

    def least_s(self, peak: float = PEAK_BF16) -> float:
        return max(self.flops / peak, self.nbytes / PEAK_BYTES)


@dataclass
class Widths:
    """The decoder's and trunk's widths from a generator dict."""
    kind: str
    c: int
    taps: int
    dc: int
    hidden: tuple
    n_shift: int
    enc: dict

    @classmethod
    def of(cls, gen: dict) -> "Widths":
        enc = dict(gen["encoder"])
        kind = enc["type"]
        if kind not in TRUNKS:
            raise ValueError(f"trunk {kind!r}: counted are {TRUNKS}")
        c = enc["mid_channels"] if kind == "RDN" else enc["embed_dim"]
        if kind == "SwinIR" and gen.get("window_size") is not None:
            enc.setdefault("window_size", gen["window_size"])
        taps = 9 if gen.get("feat_unfold", True) else 1
        nla = gen.get("non_local_attn", True)
        dc = c * len(gen.get("multi_scale", (2,))) if nla else 0
        hidden = tuple((gen.get("imnet_k") or {}).get("hidden_list",
                                                      (256,) * 4))
        ls = gen.get("local_size", 2)
        n_shift = 1 if ls == 1 else len(range(-1, 2, 4 - ls)) ** 2
        return cls(kind, c, taps, dc, hidden, n_shift, enc)

    @property
    def dk(self) -> int:
        return self.taps * self.c

    @property
    def dv(self) -> int:
        return self.taps * self.c + self.dc


def conv_flops(pixels: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * pixels * cin * cout * k * k


def mlp_flops(rows: int, din: int, hidden, dout: int) -> float:
    dims = [din, *hidden, dout]
    return 2.0 * rows * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


# ------------------------------------------------------------------ trunks
def rdn_flops(pixels: int, enc: dict) -> float:
    c = enc.get("mid_channels", 64)
    g = enc.get("channel_growth", 64)
    nb, nl = enc.get("num_blocks", 16), enc.get("num_layers", 8)
    cin = enc.get("in_channels", 3)
    per = conv_flops(1, cin, c, 3) + conv_flops(1, c, c, 3)
    block = sum(conv_flops(1, c + i * g, g, 3) for i in range(nl)) \
        + conv_flops(1, c + nl * g, c, 1)
    per += nb * block + conv_flops(1, c * nb, c, 1) + conv_flops(1, c, c, 3)
    return pixels * per


def swin_geometry(enc: dict):
    c = enc.get("embed_dim", 180)
    hid = int(c * enc.get("mlp_ratio", 2.0))
    ws = enc.get("window_size", 8)
    heads = list(enc.get("num_heads", (6,) * 6))[0]
    blocks = sum(enc.get("depths", (6,) * 6))
    groups = len(enc.get("depths", (6,) * 6))
    return c, hid, ws, heads, blocks, groups


def swin_block_work(tokens: int, enc: dict) -> Work:
    """One Swin block's forward over ``tokens`` f32 tokens (row 11's
    function): qkv, proj, fc1, fc2 and the two window products; the map in
    and out in f32, the weights in bf16, the bias table in f32."""
    c, hid, ws, heads, _, _ = swin_geometry(enc)
    n = ws * ws
    flops = 2.0 * tokens * c * (4 * c + 2 * hid) + 4.0 * tokens * n * c
    nbytes = 2 * tokens * c * 4 + (4 * c * c + 2 * c * hid) * 2 \
        + heads * n * n * 4 + (9 * c + hid) * 4
    return Work(flops, nbytes)


def swin_block_bwd_work(tokens: int, enc: dict) -> Work:
    """Its backward (row 12's function): the input and weight gradients,
    twice the forward's products; x and dy in, dx out (f32), the weights
    in (bf16) and their gradients out (f32)."""
    c, hid, ws, heads, _, _ = swin_geometry(enc)
    n = ws * ws
    fwd = swin_block_work(tokens, enc).flops
    n_par = 4 * c * c + 2 * c * hid + 9 * c + hid
    nbytes = 3 * tokens * c * 4 + (4 * c * c + 2 * c * hid) * 2 \
        + heads * n * n * 4 + n_par * 4
    return Work(2.0 * fwd, nbytes)


def swinir_conv_flops(pixels: int, enc: dict) -> float:
    """conv_first, each group's 3×3 conv and conv_after_body."""
    c, _, _, _, _, groups = swin_geometry(enc)
    return conv_flops(pixels, enc.get("in_chans", 3), c, 3) \
        + (groups + 1) * conv_flops(pixels, c, c, 3)


def trunk_flops(w: Widths, pixels: int) -> float:
    """The trunk's forward over ``pixels`` LR pixels (window padding
    excluded)."""
    if w.kind == "RDN":
        return rdn_flops(pixels, w.enc)
    if w.kind != "SwinIR":
        raise ValueError(f"trunk {w.kind!r}: counted are {TRUNKS}")
    _, _, _, _, blocks, _ = swin_geometry(w.enc)
    return swinir_conv_flops(pixels, w.enc) \
        + blocks * swin_block_work(pixels, w.enc).flops


# --------------------------------------------------------------------- CSA
def csa_work(b: int, h: int, w: int, c: int, s: int = 2,
             reduction: int = 2) -> Work:
    """The CSA function on b maps of h × w (h, w multiples of s): the three
    1×1 convs, the attention of every pixel over the L = hw/s² keys in
    its stencil form (scores 9·Cr wide, the paste 4C a pair at s = 2), the
    strided down conv; the feature in and out in bf16, the pasted map in
    f32 written and read once."""
    cr = c // reduction
    p, l_ = h * w, (h // s) * (w // s)
    flops = b * (conv_flops(p, c, cr, 1) + conv_flops(p, c, c, 1)
                 + conv_flops(l_, c, cr, 1)
                 + 2.0 * p * l_ * (9 * cr + s * s * c)
                 + conv_flops(p, c, c, 3))
    nbytes = b * (p * c * 2 + p * c * 2 + 2 * s * s * p * c * 4
                  + (p * (cr + c) + l_ * 9 * cr) * 2 * 2)
    return Work(flops, nbytes)


def csa_reference_flops(b: int, h: int, w: int, c: int, s: int = 2,
                        reduction: int = 2) -> float:
    """The published CSA's products as written (the correlation as a conv
    over the keys, the paste as a conv_transpose of the whole attention):
    what a FLOP counter reads off the plain reference."""
    cr = c // reduction
    p, l_ = h * w, (h // s) * (w // s)
    return b * (conv_flops(p, c, cr, 1) + conv_flops(p, c, c, 1)
                + conv_flops(l_, c, cr, 1) + 2.0 * p * l_ * 9 * cr
                + 2.0 * p * l_ * c * 9 * s * s + conv_flops(p, c, c, 3))


# ------------------------------------------------------------------ decode
def decode_work(w: Widths, b: int, h: int, lw: int, s: int) -> Work:
    """The dense decode of b LR maps of h × lw at integer scale s, as the
    least work it needs: the imnets' first layers once per LR pixel (the
    per-query inputs differ only by per-phase constants), the key head's
    last layer folded into the query product once per LR pixel and
    neighbour, and per HR pixel and shift the remaining hidden layers, the
    value head's last layer, the softmax products and imnet_q. Maps in and
    products out once, in bf16; the HR pixels out in f32."""
    hid = w.hidden[0]
    depth = len(w.hidden)
    m = b * h * lw
    n_phase = s * s
    k1 = 2.0 * m * (w.dk + w.dv) * hid
    k2 = 2.0 * NEIGHBOURS * m * w.dk * (hid + 1)
    mlp = w.n_shift * (2 * (depth - 1) * hid * hid + hid * w.dv + hid) \
        + w.dv * hid + (depth - 1) * hid * hid + hid * 3
    k3 = 2.0 * n_phase * m * mlp
    nbytes = m * (w.c + w.dc) * 2 + m * 2 * hid * 2 \
        + NEIGHBOURS * m * (hid * 2 + 4) + n_phase * m * 3 * 4 \
        + 2 * (w.dk + w.dv) * hid * 2
    return Work(k1 + k2 + k3, nbytes)


def per_query_flops(w: Widths, queries: int) -> float:
    """The per-query decoder as published, for ``queries`` queries: per
    shift both heads whole (their inputs carry the relative coordinate and
    cell), the query-key products, the softmax blend and imnet_q."""
    per = w.n_shift * (mlp_flops(1, w.dk + 4, w.hidden, w.dk)
                       + mlp_flops(1, w.dv + 4, w.hidden, w.dv)) \
        + 2.0 * w.n_shift * (w.dk + w.dv) \
        + mlp_flops(1, w.dv, w.hidden, 3)
    return queries * per


# --------------------------------------------------------------- per call
def tile_work(w: Widths, b: int, t: int, s: int) -> dict:
    """The work of one eval call on b square LR tiles of t² at scale s, by
    part: trunk, csa, decode (Work), and swin_blocks (the blocks' summed
    forward work; zero for RDN)."""
    pixels = b * t * t
    out = {"trunk": Work(trunk_flops(w, pixels), 0.0),
           "decode": decode_work(w, b, t, t, s),
           "csa": Work(), "swin_blocks": Work()}
    if w.dc:
        out["csa"] = csa_work(b, t, t, w.c)
    if w.kind == "SwinIR":
        _, _, ws, _, blocks, _ = swin_geometry(w.enc)
        pad = -(-t // ws) * ws
        blk = swin_block_work(b * pad * pad, w.enc)
        out["swin_blocks"] = Work(blocks * blk.flops, blocks * blk.nbytes)
    return out


def train_step_flops(w: Widths, b: int, lr: int,
                     queries: int) -> tuple[float, float]:
    """(float32, bf16) operations of one training step (forward and
    backward) on b LR patches of lr² and ``queries`` queries a patch, by
    the precision each part runs in: the Swin blocks in bf16 (their
    kernels take bf16), the convs, the CSA and the per-query decoder in
    float32. The backward is twice the forward's products, but for the
    first conv, whose input needs no gradient."""
    pixels = b * lr * lr
    if w.kind == "SwinIR":
        _, _, _, _, blocks, _ = swin_geometry(w.enc)
        cin = w.enc.get("in_chans", 3)
        f32 = 3.0 * swinir_conv_flops(pixels, w.enc)
        bf16 = 3.0 * blocks * swin_block_work(pixels, w.enc).flops
    elif w.kind == "RDN":
        cin = w.enc.get("in_channels", 3)
        f32, bf16 = 3.0 * rdn_flops(pixels, w.enc), 0.0
    else:
        raise ValueError(f"trunk {w.kind!r}: counted are {TRUNKS}")
    f32 -= conv_flops(pixels, cin, w.c, 3)
    if w.dc:
        f32 += 3.0 * csa_reference_flops(b, lr, lr, w.c)
    f32 += 3.0 * per_query_flops(w, b * queries)
    return f32, bf16


def train_step_least_s(w: Widths, b: int, lr: int, queries: int) -> float:
    """The least time of one training step: each part's operations at the
    peak of the precision it runs in."""
    f32, bf16 = train_step_flops(w, b, lr, queries)
    return f32 / PEAK_F32 + bf16 / PEAK_BF16
