"""Minimal TensorBoard event writer, pure numpy (counterpart of
utils/tb.py).

The JAX package's utils/tb.py carried over unchanged so that the port
stands without it (tests/test_torch_tb_viz.py pins that both write the
same bytes), plus `read_events`, a reader that checks every CRC. The
trainer mirrors its scalar metrics and the eval overlay grid into these
files (train/trainer.py MetricsLogger).

Format (TFRecord framing around serialized Event protos):

    uint64 length | uint32 masked_crc32c(length) | bytes data
                  | uint32 masked_crc32c(data)

Event proto fields used: wall_time=1 (double), step=2 (int64),
file_version=3 (string, first record only), summary=5. Summary holds
repeated Value=1; Value holds tag=1 (string), simple_value=2 (float),
image=4 (Image: height=1, width=2, colorspace=3,
encoded_image_string=4, PNG bytes).
"""

from __future__ import annotations

import os
import socket
import struct
import time
import zlib

import numpy as np

# ---------------------------------------------------------------- crc32c

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- proto encoding

def _varint(n: int) -> bytes:
    if n < 0:
        # proto varints are unsigned; negative int64 takes the 10-byte
        # two's-complement form (and would otherwise loop forever on
        # Python's arithmetic shift)
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(int(v))


def _bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _event(wall_time: float, step: int, body: bytes) -> bytes:
    return _double(1, wall_time) + _int(2, step) + body


# ------------------------------------------------------------ PNG encode

def _encode_png(img: np.ndarray) -> bytes:
    """uint8 HWC (1 or 3 channels) -> PNG, via zlib only (no cv2/PIL)."""
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    assert img.dtype == np.uint8 and c in (1, 3), (img.dtype, img.shape)
    color_type = 0 if c == 1 else 2
    # raw scanlines, filter byte 0 per row
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data +
                struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) +
            chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) +
            chunk(b"IEND", b""))


# --------------------------------------------------------------- writer

class EventWriter:
    """TensorBoard-compatible scalar/image event writer.

    Drop-in for the reference's SummaryWriter usage surface:
    ``add_scalar(tag, value, step)`` / ``add_image(tag, hwc_uint8, step)``.
    Files land as ``events.out.tfevents.<ts>.<host>`` under ``logdir`` and
    load in stock TensorBoard.
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._record(_event(time.time(), 0, _bytes(3, b"brain.Event:2")))

    def _record(self, data: bytes):
        hdr = struct.pack("<Q", len(data))
        self._f.write(hdr + struct.pack("<I", _masked_crc(hdr)) + data +
                      struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int):
        val = _bytes(1, tag.encode()) + _float(2, float(value))
        self._record(_event(time.time(), step,
                            _bytes(5, _bytes(1, val))))
        return self

    def add_image(self, tag: str, img: np.ndarray, step: int):
        """img: uint8 HWC RGB (or HW / HWC-1 grayscale)."""
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[..., None]
        h, w, c = img.shape
        image = (_int(1, h) + _int(2, w) + _int(3, c) +
                 _bytes(4, _encode_png(img)))
        val = _bytes(1, tag.encode()) + _bytes(4, image)
        self._record(_event(time.time(), step,
                            _bytes(5, _bytes(1, val))))
        return self

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


# --------------------------------------------------------------- reader

def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, pos


def _fields(buf: bytes):
    """(field, value) of a serialized proto: ints for varints, bytes for
    length-delimited fields, the raw 8 or 4 bytes of fixed ones."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, value


def _value(buf: bytes) -> tuple[str, object]:
    tag, val = "", None
    for field, v in _fields(buf):
        if field == 1:
            tag = v.decode()
        elif field == 2:
            val = struct.unpack("<f", v)[0]
        elif field == 4:
            img = dict(_fields(v))
            val = {"height": img[1], "width": img[2], "colorspace": img[3],
                   "png": img[4]}
    return tag, val


def read_events(path: str) -> list[dict]:
    """The records of an event file, each {"wall_time", "step",
    "file_version" or "values": [(tag, float or image dict)]}; raises
    ValueError on a bad CRC or a torn record."""
    with open(path, "rb") as f:
        buf = f.read()
    events, pos = [], 0
    while pos < len(buf):
        if pos + 12 > len(buf):
            raise ValueError(f"{path}: torn record header at byte {pos}")
        hdr = buf[pos:pos + 8]
        (n,) = struct.unpack("<Q", hdr)
        (crc,) = struct.unpack("<I", buf[pos + 8:pos + 12])
        data = buf[pos + 12:pos + 12 + n]
        end = pos + 12 + n + 4
        if crc != _masked_crc(hdr) or len(data) != n or end > len(buf):
            raise ValueError(f"{path}: bad length record at byte {pos}")
        (dcrc,) = struct.unpack("<I", buf[end - 4:end])
        if dcrc != _masked_crc(data):
            raise ValueError(f"{path}: bad data CRC at byte {pos}")
        ev = {"step": 0, "values": []}
        for field, v in _fields(data):
            if field == 1:
                ev["wall_time"] = struct.unpack("<d", v)[0]
            elif field == 2:
                ev["step"] = v - (1 << 64) if v >> 63 else v   # int64
            elif field == 3:
                ev["file_version"] = v.decode()
            elif field == 5:
                ev["values"] += [_value(val) for f2, val in _fields(v)
                                 if f2 == 1]
        events.append(ev)
        pos = end
    return events
