"""TensorBoard event files of scalars, written and read without a protobuf
package: what the JAX package's ``MetricLogger`` writes through
``tensorboardX.SummaryWriter.add_scalar``.

A file ``<logdir>/events.out.tfevents.<10-digit time>.<host>`` is a
TFRecord stream: each record is a little-endian u64 length, the masked
CRC32C of those 8 bytes (u32), the data, and the masked CRC32C of the
data; mask(c) = ((c >> 15 | c << 17) + 0xa282ead8) mod 2^32. The first
record is an ``Event{wall_time (1, double), file_version (3, string) =
"brain.Event:2"}``; each scalar is one ``Event{wall_time, step (2, int64),
summary (5){value (1){tag (1, string), simple_value (2, float)}}}``,
fields in number order and a zero step left out, as proto3 serializes
them.
"""

from __future__ import annotations

import glob
import os
import socket
import struct
import time

FILE_VERSION = "brain.Event:2"


def _crc32c_table() -> list[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    c = 0xFFFFFFFF
    for byte in data:
        c = _TABLE[(c ^ byte) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    """A non-negative integer as a protobuf varint."""
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _bytes_field(number: int, data: bytes) -> bytes:
    return _varint(number << 3 | 2) + _varint(len(data)) + data


def encode_event(wall_time: float, step: int = 0, *,
                 file_version: str | None = None, tag: str | None = None,
                 value: float = 0.0) -> bytes:
    """One serialized ``Event``: the file-version event, or the scalar
    ``tag`` = ``value`` (as float32) at ``step``."""
    out = b"\x09" + struct.pack("<d", wall_time)
    if step:
        out += b"\x10" + _varint(step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if tag is not None:
        scalar = _bytes_field(1, tag.encode()) + b"\x15" + struct.pack(
            "<f", value)
        out += _bytes_field(5, _bytes_field(1, scalar))
    return out


def encode_record(data: bytes) -> bytes:
    """``data`` framed as one TFRecord."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc(length)) + data
            + struct.pack("<I", masked_crc(data)))


class EventWriter:
    """Appends scalar events to a new event file in ``logdir``; the file is
    opened for each write and closed after it, so that a run killed at any
    point leaves a readable file."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(
            logdir, "events.out.tfevents.{:010d}.{}".format(
                int(time.time()), socket.gethostname()))
        self._write(encode_event(time.time(), file_version=FILE_VERSION))

    def _write(self, data: bytes) -> None:
        with open(self.path, "ab") as f:
            f.write(encode_record(data))

    def add_scalars(self, scalars: dict, step: int) -> None:
        """{tag: value} at ``step``: one event a scalar, as
        ``add_scalar`` writes them."""
        for tag, value in scalars.items():
            self._write(encode_event(time.time(), step, tag=tag,
                                     value=float(value)))


# ---------------------------------------------------------------- reading

def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, i


def _fields(buf: bytes):
    """(field number, wire type, value) of each field of a message: an int
    (varint), bytes (length-delimited) or the raw 8 or 4 bytes."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire == 1:
            value, i = buf[i:i + 8], i + 8
        elif wire == 2:
            n, i = _read_varint(buf, i)
            value, i = buf[i:i + n], i + n
        elif wire == 5:
            value, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"event: wire type {wire} of field {number}")
        yield number, wire, value


def decode_event(data: bytes) -> dict:
    """{"wall_time", "step", "file_version" (or None), "scalars": {tag:
    float32 value}} of one serialized ``Event``."""
    ev = {"wall_time": 0.0, "step": 0, "file_version": None, "scalars": {}}
    for number, _, value in _fields(data):
        if number == 1:
            ev["wall_time"] = struct.unpack("<d", value)[0]
        elif number == 2:
            ev["step"] = value
        elif number == 3:
            ev["file_version"] = value.decode()
        elif number == 5:
            for vnum, _, val in _fields(value):
                if vnum != 1:
                    continue
                tag, simple = None, None
                for fnum, _, f in _fields(val):
                    if fnum == 1:
                        tag = f.decode()
                    elif fnum == 2:
                        simple = struct.unpack("<f", f)[0]
                if tag is not None and simple is not None:
                    ev["scalars"][tag] = simple
    return ev


def read_records(path: str) -> list[bytes]:
    """The records of a TFRecord file, each CRC checked; raises on a
    damaged record, ignores a cut last one."""
    with open(path, "rb") as f:
        buf = f.read()
    out, i = [], 0
    while i + 12 <= len(buf):
        length = buf[i:i + 8]
        (n,) = struct.unpack("<Q", length)
        if struct.unpack("<I", buf[i + 8:i + 12])[0] != masked_crc(length):
            raise ValueError(f"{path}: bad length CRC at byte {i}")
        if i + 16 + n > len(buf):
            break
        data = buf[i + 12:i + 12 + n]
        if struct.unpack("<I", buf[i + 12 + n:i + 16 + n])[0] \
                != masked_crc(data):
            raise ValueError(f"{path}: bad data CRC at byte {i}")
        out.append(data)
        i += 16 + n
    return out


def read_events(path: str) -> list[dict]:
    """The decoded events of one event file, in order."""
    return [decode_event(r) for r in read_records(path)]


def read_scalars(logdir: str) -> dict:
    """{tag: [(step, value), ...]} over the event files of ``logdir``, in
    file-name and then write order."""
    out: dict = {}
    for path in sorted(glob.glob(os.path.join(logdir,
                                              "events.out.tfevents.*"))):
        for ev in read_events(path):
            for tag, value in ev["scalars"].items():
                out.setdefault(tag, []).append((ev["step"], value))
    return out
