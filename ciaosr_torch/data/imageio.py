"""PNG reader and writer on the standard library's zlib.

The machine that holds the card has neither OpenCV nor Pillow, so the
port reads and writes its images itself: 8-bit, non-interlaced PNG in
gray, RGB and RGBA, with all five row filters (None, Sub, Up, Average,
Paeth). ``imread`` gives the pixels ``cv2.imread(path, IMREAD_COLOR)``
gives (gray replicated to three channels, alpha dropped), in RGB order
unless asked for BGR. A path with another extension goes through OpenCV,
and raises where OpenCV is not installed.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (0 gray, 2 RGB, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _is_png(path: str) -> bool:
    return os.path.splitext(path)[1].lower() == ".png"


def _cv2(path: str):
    try:
        import cv2
    except ImportError:
        raise ValueError(f"{path}: without OpenCV the port reads and writes "
                         "PNG files only") from None
    return cv2


def _chunks(data: bytes):
    """(type, payload) of each chunk after the signature, CRCs checked."""
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(payload) != n or zlib.crc32(kind + payload) != crc:
            raise ValueError(f"corrupt PNG chunk {kind!r}")
        yield kind, payload
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG ends without IEND")


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + stride) filtered scanlines -> (H, stride) raw bytes."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:    # Sub: a running sum over the pixels, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.int64).astype(np.uint8).reshape(-1)
        elif kind == 2:    # Up (uint8 addition wraps mod 256)
            cur = line + prev
        elif kind in (3, 4):   # Average, Paeth: sequential in x
            cur_b = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur_b[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur_b[i] = (cur_b[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur_b), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """(H, W, C) uint8 in the file's channel order: C = 1 (gray), 3 (RGB)
    or 4 (RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit, non-interlaced gray, RGB and "
                         f"RGBA PNG is read (bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace})")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError(f"{path}: {raw.size} image bytes, want "
                         f"{h * (1 + w * c)}")
    return _unfilter(raw.reshape(h, 1 + w * c), c).reshape(h, w, c)


def _filter(img: np.ndarray, bpp: int, kind: int) -> np.ndarray:
    """(H, stride) raw bytes -> the same bytes under filter ``kind``."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    if kind == 0:
        pred = 0
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) >> 1
    elif kind == 4:
        c = np.zeros_like(x)
        c[1:, bpp:] = x[:-1, :-bpp]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"unknown PNG filter type {kind}")
    return ((x - pred) & 0xFF).astype(np.uint8)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def write_png(path: str, img: np.ndarray, filter_type: int = 2) -> None:
    """Write uint8 (H, W) or (H, W, C) with C = 1, 3 (RGB) or 4 (RGBA),
    every scanline under ``filter_type`` (0-4; default Up)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype != np.uint8 or img.ndim != 3 \
            or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"write_png takes uint8 (H, W[, 1|3|4]), got "
                         f"{img.dtype} {img.shape}")
    h, w, c = img.shape
    rows = _filter(np.ascontiguousarray(img).reshape(h, w * c), c,
                   filter_type)
    lines = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows],
                           axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(lines.tobytes()))
                + _chunk(b"IEND", b""))


def imread(path: str, channel_order: str = "rgb") -> np.ndarray:
    """(H, W, 3) uint8 in ``channel_order`` ('rgb' or 'bgr'): the pixels
    of ``cv2.imread(path, cv2.IMREAD_COLOR)``."""
    if channel_order not in ("rgb", "bgr"):
        raise ValueError(f"channel_order must be 'rgb' or 'bgr', got "
                         f"{channel_order!r}")
    if _is_png(path):
        img = read_png(path)
        img = np.repeat(img, 3, axis=2) if img.shape[2] == 1 else img[..., :3]
        return np.ascontiguousarray(img[..., ::-1]) \
            if channel_order == "bgr" else img
    cv2 = _cv2(path)
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"failed to read {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB) if channel_order == "rgb" \
        else img


def imwrite(path: str, img_rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image; the format from the extension."""
    if _is_png(path):
        write_png(path, img_rgb)
        return
    cv2 = _cv2(path)
    if not cv2.imwrite(path, np.ascontiguousarray(img_rgb[..., ::-1])):
        raise IOError(f"failed to write {path}")
