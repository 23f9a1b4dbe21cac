"""Minimal native OpenEXR codec (scanline images).

The JAX package's data/exr.py carried over unchanged so that the port
stands without it; tests/test_torch_transparent_data.py pins that both
read and write the same arrays and bytes.

The reference reads Cleargrasp's ground-truth EXRs (depth / camera
normals / variant masks) through OpenCV's OpenEXR bindings
(version/transparent/datasets/cleargrasp/dataset.py:328-341) — an
external C++ dependency that is simply absent from many cv2 builds
(including this image's). This module implements the subset of the EXR
2.0 format those files actually use, in pure numpy:

  read:  single-part scanline images, compression NONE / RLE / ZIPS /
         ZIP, channel types HALF / FLOAT / UINT, arbitrary channel
         names (R,G,B / Y / Z / ...).
  write: float32 or float16 channels, ZIP (16-scanline chunks) or NONE.

Returned layout matches what the reference's cv2 path produces after its
BGR->RGB flip: [H, W] for one channel, [H, W, 3] in R,G,B order for the
RGB case, else [H, W, C] with channels in alphabetical order.

Format reference: the public OpenEXR file layout documentation
(openexr.com, "Reading and Writing Image Files" / ImfZip.cpp for the
ZIP predictor+interleave preprocessing).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_DTYPES = {_PT_UINT: np.dtype("<u4"), _PT_HALF: np.dtype("<f2"),
           _PT_FLOAT: np.dtype("<f4")}
# compression ids -> scanlines per chunk
_NONE, _RLE, _ZIPS, _ZIP = 0, 1, 2, 3
_LINES_PER_CHUNK = {_NONE: 1, _RLE: 1, _ZIPS: 1, _ZIP: 16}


def _read_cstring(buf: bytes, pos: int) -> tuple[str, int]:
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("ascii"), end + 1


def _unpredict(data: bytes) -> np.ndarray:
    """Invert the EXR zip preprocessing: delta-decode then de-interleave
    (ImfZip.cpp uncompress postprocessing)."""
    d = np.frombuffer(data, np.uint8).astype(np.int16)
    # delta decode: t[i] = t[i-1] + d[i] - 128 (mod 256)
    d[1:] -= 128
    d = np.cumsum(d, dtype=np.int64) % 256
    d = d.astype(np.uint8)
    # de-interleave: first half -> even positions, second half -> odd
    n = len(d)
    out = np.empty(n, np.uint8)
    h = (n + 1) // 2
    out[0::2] = d[:h]
    out[1::2] = d[h:]
    return out


def _predict(raw: np.ndarray) -> bytes:
    """EXR zip preprocessing: interleave-split then delta-encode."""
    n = len(raw)
    h = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[:h] = raw[0::2]
    inter[h:] = raw[1::2]
    d = inter.astype(np.int16)
    d[1:] = d[1:] - inter[:-1].astype(np.int16) + 128
    return (d % 256).astype(np.uint8).tobytes()


def _rle_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        count = struct.unpack_from("<b", data, i)[0]
        i += 1
        if count < 0:
            out += data[i:i - count]
            i += -count
        else:
            out += data[i:i + 1] * (count + 1)
            i += 1
    return bytes(out)


def read_exr(path: str) -> np.ndarray:
    """Decode a scanline EXR file -> float32 (or uint32) numpy image."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file (magic {magic:#x})")
    if version & 0x200:  # tiled single-part
        raise NotImplementedError(f"{path}: tiled EXR not supported")
    if version & 0x1000 or version & 0x800:
        raise NotImplementedError(f"{path}: multi-part/deep EXR "
                                  "not supported")
    pos = 8

    channels: list[tuple[str, int]] = []
    compression = _NONE
    data_window = None
    while True:
        name, pos = _read_cstring(buf, pos)
        if not name:
            break
        atype, pos = _read_cstring(buf, pos)
        size = struct.unpack_from("<i", buf, pos)[0]
        pos += 4
        payload = buf[pos:pos + size]
        pos += size
        if name == "channels" and atype == "chlist":
            cpos = 0
            while payload[cpos] != 0:
                cname, cpos = _read_cstring(payload, cpos)
                ptype = struct.unpack_from("<i", payload, cpos)[0]
                cpos += 16  # type + pLinear/reserved + x/ySampling
                channels.append((cname, ptype))
        elif name == "compression" and atype == "compression":
            compression = payload[0]
        elif name == "dataWindow" and atype == "box2i":
            data_window = struct.unpack("<4i", payload)

    if data_window is None or not channels:
        raise ValueError(f"{path}: missing dataWindow/channels")
    if compression not in _LINES_PER_CHUNK:
        raise NotImplementedError(
            f"{path}: compression id {compression} not supported "
            "(NONE/RLE/ZIPS/ZIP only)")
    xmin, ymin, xmax, ymax = data_window
    width = xmax - xmin + 1
    height = ymax - ymin + 1
    lpc = _LINES_PER_CHUNK[compression]
    n_chunks = (height + lpc - 1) // lpc

    # channels are stored per scanline in alphabetical order
    order = sorted(range(len(channels)), key=lambda i: channels[i][0])
    row_bytes = [width * _DTYPES[channels[i][1]].itemsize
                 for i in range(len(channels))]

    offsets = struct.unpack_from(f"<{n_chunks}Q", buf, pos)
    planes = [np.empty((height, width), _DTYPES[pt])
              for _, pt in channels]
    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8:off + 8 + size]
        lines = min(lpc, ymax - y + 1)
        raw_size = sum(row_bytes) * lines
        if compression in (_ZIPS, _ZIP):
            if size < raw_size:
                data = _unpredict(zlib.decompress(data)).tobytes()
        elif compression == _RLE:
            if size < raw_size:
                data = _unpredict(_rle_decode(data)).tobytes()
        dpos = 0
        for line in range(lines):
            for ci in order:
                rb = row_bytes[ci]
                planes[ci][y - ymin + line] = np.frombuffer(
                    data, planes[ci].dtype, count=width, offset=dpos)
                dpos += rb

    names = [c[0] for c in channels]
    out_dtype = (np.uint32 if all(pt == _PT_UINT for _, pt in channels)
                 else np.float32)
    if len(channels) == 1:
        return planes[0].astype(out_dtype)
    if sorted(names) == ["B", "G", "R"]:
        by = dict(zip(names, planes))
        stack = [by["R"], by["G"], by["B"]]          # cv2-after-flip order
    else:
        stack = [planes[i] for i in order]
    return np.stack(stack, -1).astype(out_dtype)


def write_exr(path: str, img: np.ndarray, compression: str = "zip",
              half: bool = False) -> None:
    """Encode [H,W] or [H,W,3] (written as B,G,R-named channels, the
    RGB convention cleargrasp's files use) or [H,W,C]."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
        names = ["Y"]
    elif img.shape[-1] == 3:
        names = ["R", "G", "B"]
    else:
        names = [f"C{i}" for i in range(img.shape[-1])]
    h, w, c = img.shape
    dtype = np.dtype("<f2") if half else np.dtype("<f4")
    ptype = _PT_HALF if half else _PT_FLOAT
    comp_id = {"none": _NONE, "zip": _ZIP, "zips": _ZIPS}[compression]
    lpc = _LINES_PER_CHUNK[comp_id]

    def attr(name: str, atype: str, payload: bytes) -> bytes:
        return (name.encode() + b"\x00" + atype.encode() + b"\x00"
                + struct.pack("<i", len(payload)) + payload)

    chlist = b""
    for n in sorted(names):
        chlist += (n.encode() + b"\x00"
                   + struct.pack("<i", ptype)
                   + b"\x00\x00\x00\x00"        # pLinear + reserved
                   + struct.pack("<ii", 1, 1))  # x/y sampling
    chlist += b"\x00"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (struct.pack("<ii", _MAGIC, 2)
              + attr("channels", "chlist", chlist)
              + attr("compression", "compression",
                     struct.pack("<B", comp_id))
              + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\x00")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f",
                     struct.pack("<ff", 0.0, 0.0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\x00")

    order = sorted(range(c), key=lambda i: names[i])
    chunks = []
    for y0 in range(0, h, lpc):
        lines = min(lpc, h - y0)
        rows = []
        for line in range(lines):
            for ci in order:
                rows.append(np.ascontiguousarray(
                    img[y0 + line, :, ci].astype(dtype)).view(np.uint8))
        raw = np.concatenate(rows)
        if comp_id in (_ZIP, _ZIPS):
            packed = zlib.compress(_predict(raw))
            if len(packed) >= len(raw):
                packed = raw.tobytes()
        else:
            packed = raw.tobytes()
        chunks.append(struct.pack("<ii", y0, len(packed)) + packed)

    n_chunks = len(chunks)
    table_start = len(header) + 8 * n_chunks
    offsets, off = [], table_start
    for ch in chunks:
        offsets.append(off)
        off += len(ch)
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{n_chunks}Q", *offsets))
        for ch in chunks:
            f.write(ch)
