"""The pixels of a baseline JPEG round trip, libjpeg-exact, in numpy.

``jpeg_roundtrip(rgb_u8, quality)`` gives what
``cv2.imdecode(cv2.imencode('.jpg', bgr, [IMWRITE_JPEG_QUALITY, q]))``
gives (channels in RGB order), without a codec: entropy coding is
lossless, so it is skipped, and what is left is libjpeg's default
baseline path in integer arithmetic, vectorised over all 8×8 blocks:

1. RGB → YCbCr with ``jccolor.c``'s 16-bit fixed-point weights;
2. edge replication to whole blocks (and, for chroma, to whole 16×16
   MCUs, as ``jcsample.c`` / ``jcprepct.c`` pad);
3. 4:2:0 downsampling, ``jcsample.c``'s h2v2 mean with its alternating
   1 / 2 bias;
4. the islow forward DCT (``jfdctint.c``) and quantisation by the
   quality-scaled standard tables (``jcparam.c``, clamped to 1-255 as
   ``force_baseline`` does) with ``jcdctmgr.c``'s reciprocal rounding;
5. dequantisation and the islow inverse DCT (``jidctint.c``) with its
   range limit;
6. chroma upsampling: ``jdsample.c``'s h2v2 "fancy" triangle filter
   (the last real sample row and column replicated), or plain 2×2
   replication when the chroma plane is at most 2 samples wide;
7. YCbCr → RGB with ``jdcolor.c``'s tables.
"""

from __future__ import annotations

import numpy as np

_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int64).reshape(8, 8)
_CHROMA = np.full((8, 8), 99, np.int64)
_CHROMA[:4, :4] = np.array([[17, 18, 24, 47], [18, 21, 26, 66],
                            [24, 26, 56, 99], [47, 66, 99, 99]])

# jfdctint.c / jidctint.c constants (CONST_BITS = 13)
CONST_BITS, PASS1_BITS = 13, 2
F0298, F0390, F0541, F0765 = 2446, 3196, 4433, 6270
F0899, F1175, F1501, F1847 = 7373, 9633, 12299, 15137
F1961, F2053, F2562, F3072 = 16069, 16819, 20995, 25172

SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


def quant_tables(quality: int):
    """(luma, chroma) 8×8 tables of ``jpeg_set_quality(q, TRUE)``."""
    q = min(max(int(quality), 0), 100)     # cv2 clamps the parameter
    q = max(q, 1)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    out = []
    for base in (_LUMA, _CHROMA):
        t = (base * scale + 50) // 100
        out.append(np.clip(t, 1, 255))
    return out


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d, out_shift):
    """One pass of jfdctint.c along the last axis; ``out_shift`` True for
    the first (row) pass, which keeps PASS1_BITS of extra precision."""
    d0, d1, d2, d3, d4, d5, d6, d7 = (d[..., i] for i in range(8))
    tmp0, tmp7 = d0 + d7, d0 - d7
    tmp1, tmp6 = d1 + d6, d1 - d6
    tmp2, tmp5 = d2 + d5, d2 - d5
    tmp3, tmp4 = d3 + d4, d3 - d4
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = np.empty_like(d)
    if out_shift:
        out[..., 0] = (tmp10 + tmp11) << PASS1_BITS
        out[..., 4] = (tmp10 - tmp11) << PASS1_BITS
        sh = CONST_BITS - PASS1_BITS
    else:
        out[..., 0] = _descale(tmp10 + tmp11, PASS1_BITS)
        out[..., 4] = _descale(tmp10 - tmp11, PASS1_BITS)
        sh = CONST_BITS + PASS1_BITS
    z1 = (tmp12 + tmp13) * F0541
    out[..., 2] = _descale(z1 + tmp13 * F0765, sh)
    out[..., 6] = _descale(z1 - tmp12 * F1847, sh)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * F1175
    tmp4, tmp5 = tmp4 * F0298, tmp5 * F2053
    tmp6, tmp7 = tmp6 * F3072, tmp7 * F1501
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    out[..., 7] = _descale(tmp4 + z1 + z3, sh)
    out[..., 5] = _descale(tmp5 + z2 + z4, sh)
    out[..., 3] = _descale(tmp6 + z2 + z3, sh)
    out[..., 1] = _descale(tmp7 + z1 + z4, sh)
    return out


def _idct_1d(d, sh):
    """One pass of jidctint.c along the last axis, descaled by ``sh``."""
    z2, z3 = d[..., 2], d[..., 6]
    z1 = (z2 + z3) * F0541
    tmp2 = z1 - z3 * F1847
    tmp3 = z1 + z2 * F0765
    tmp0 = (d[..., 0] + d[..., 4]) << CONST_BITS
    tmp1 = (d[..., 0] - d[..., 4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
    z1, z2 = tmp0 + tmp3, tmp1 + tmp2
    z3, z4 = tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * F1175
    tmp0, tmp1 = tmp0 * F0298, tmp1 * F2053
    tmp2, tmp3 = tmp2 * F3072, tmp3 * F1501
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    tmp0 = tmp0 + z1 + z3
    tmp1 = tmp1 + z2 + z4
    tmp2 = tmp2 + z2 + z3
    tmp3 = tmp3 + z1 + z4
    out = np.empty_like(d)
    out[..., 0] = _descale(tmp10 + tmp3, sh)
    out[..., 7] = _descale(tmp10 - tmp3, sh)
    out[..., 1] = _descale(tmp11 + tmp2, sh)
    out[..., 6] = _descale(tmp11 - tmp2, sh)
    out[..., 2] = _descale(tmp12 + tmp1, sh)
    out[..., 5] = _descale(tmp12 - tmp1, sh)
    out[..., 3] = _descale(tmp13 + tmp0, sh)
    out[..., 4] = _descale(tmp13 - tmp0, sh)
    return out


def _reciprocals(q: np.ndarray):
    """jcdctmgr.c compute_reciprocal for the islow divisors q << 3:
    (reciprocal, correction, total shift)."""
    recip = np.empty(64, np.int64)
    corr = np.empty(64, np.int64)
    shift = np.empty(64, np.int64)
    for i, d in enumerate((q.reshape(-1) << 3).tolist()):
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip[i], corr[i], shift[i] = fq, c, r
    return (recip.reshape(8, 8), corr.reshape(8, 8), shift.reshape(8, 8))


def _blocks(plane: np.ndarray) -> np.ndarray:
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _unblocks(blocks: np.ndarray) -> np.ndarray:
    hb, wb = blocks.shape[:2]
    return blocks.transpose(0, 2, 1, 3).reshape(hb * 8, wb * 8)


def _code_plane(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Samples (a multiple of 8 on each side) → quantised → decoded
    samples, block by block."""
    x = _blocks(plane.astype(np.int64) - 128)
    x = _fdct_1d(x, True)                                   # rows
    x = _fdct_1d(x.swapaxes(-1, -2), False).swapaxes(-1, -2)  # columns
    recip, corr, shift = _reciprocals(q)
    mag = ((np.abs(x) + corr) * recip) >> shift
    coef = np.where(x < 0, -mag, mag)
    x = coef * q                                            # dequantise
    x = _idct_1d(x.swapaxes(-1, -2), CONST_BITS - PASS1_BITS
                 ).swapaxes(-1, -2)                         # columns
    x = _idct_1d(x, CONST_BITS + PASS1_BITS + 3)            # rows
    x = x & 1023                                            # RANGE_MASK
    x = np.where(x >= 512, x - 1024, x)
    return _unblocks(np.clip(x + 128, 0, 255))


def _pad_edge(a: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.pad(a, ((0, h - a.shape[0]), (0, w - a.shape[1])),
                  mode="edge")


def _upsample_fancy(c: np.ndarray) -> np.ndarray:
    """jdsample.c h2v2_fancy_upsample of the real (h, w) samples."""
    c = c.astype(np.int64)
    up = np.concatenate([c[:1], c[:-1]])        # row above (top: itself)
    down = np.concatenate([c[1:], c[-1:]])      # row below (bottom: itself)
    rows = np.empty((2 * c.shape[0], c.shape[1]), np.int64)
    rows[0::2] = 3 * c + up
    rows[1::2] = 3 * c + down
    left = np.concatenate([rows[:, :1], rows[:, :-1]], axis=1)
    right = np.concatenate([rows[:, 1:], rows[:, -1:]], axis=1)
    out = np.empty((rows.shape[0], 2 * rows.shape[1]), np.int64)
    out[:, 0::2] = (3 * rows + left + 8) >> 4
    out[:, 1::2] = (3 * rows + right + 7) >> 4
    return out


def jpeg_roundtrip(rgb: np.ndarray, quality: int) -> np.ndarray:
    """(H, W, 3) uint8 RGB → the same image through a baseline 4:2:0 JPEG
    at ``quality``, uint8 RGB, as libjpeg(-turbo) encodes and decodes."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"jpeg_roundtrip takes (H, W, 3) uint8, got "
                         f"{rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    off = (128 << SCALEBITS) + ONE_HALF - 1
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b
         + ONE_HALF) >> SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b
          + off) >> SCALEBITS
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + off) >> SCALEBITS
    q_luma, q_chroma = quant_tables(quality)

    hb, wb = -(-h // 8), -(-w // 8)
    y_dec = _code_plane(_pad_edge(y, hb * 8, wb * 8), q_luma)[:h, :w]

    # chroma: rows to even, columns to whole MCUs, then the 2×2 mean
    ch, cw = -(-h // 2), -(-w // 2)             # real chroma samples
    mh, mw = -(-h // 16), -(-w // 16)           # MCUs
    bias = np.tile(np.array([1, 2], np.int64), mw * 4)
    planes = []
    for c in (cb, cr):
        c = _pad_edge(c, 2 * ch, mw * 16)
        s = c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]
        s = (s + bias) >> 2
        dec = _code_plane(_pad_edge(s, mh * 8, mw * 8), q_chroma)
        if cw > 2:
            up = _upsample_fancy(dec[:ch, :cw])
        else:
            up = np.repeat(np.repeat(dec[:ch, :cw], 2, 0), 2, 1)
        planes.append(up[:h, :w])
    cb_d, cr_d = (p - 128 for p in planes)

    cr_r = (_fix(1.40200) * cr_d + ONE_HALF) >> SCALEBITS
    cb_b = (_fix(1.77200) * cb_d + ONE_HALF) >> SCALEBITS
    g_off = (-_fix(0.71414) * cr_d - _fix(0.34414) * cb_d
             + ONE_HALF) >> SCALEBITS
    out = np.stack([y_dec + cr_r, y_dec + g_off, y_dec + cb_b], axis=-1)
    return np.clip(out, 0, 255).astype(np.uint8)
