"""Minimal OpenEXR 2.0 scanline reader and writer, pure Python and zlib
(counterpart of cppf_tpu/data/exr.py).

The laptop segmenter's Blender training renders keep their depth in EXR
files; the card has neither OpenEXR nor an EXR-capable ``cv2``.  The subset
Blender emits: single-part scanline images, NONE/ZIPS/ZIP compression,
HALF/FLOAT/UINT channels.

Format notes (OpenEXR spec): header = magic 0x01312f76, version, a list of
``name\\0 type\\0 <int32 size> <data>`` attributes terminated by an empty
name; then a line-offset table; then per-block ``int32 y, int32 size, data``.
ZIP blocks are zlib streams post-processed with the EXR byte predictor
(delta + two-half interleave).
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict

import numpy as np

_MAGIC = 20000630
_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
_COMPRESSION_LINES = {0: 1, 1: 1, 2: 1, 3: 16}  # NONE, RLE(unsupported), ZIPS, ZIP


def _read_attrs(buf: bytes, off: int):
    attrs = {}
    while True:
        end = buf.index(b"\0", off)
        name = buf[off:end].decode()
        off = end + 1
        if name == "":
            break
        end = buf.index(b"\0", off)
        typ = buf[off:end].decode()
        off = end + 1
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        attrs[name] = (typ, buf[off : off + size])
        off += size
    return attrs, off


def _parse_channels(data: bytes):
    channels = []
    off = 0
    while data[off] != 0:
        end = data.index(b"\0", off)
        name = data[off:end].decode()
        off = end + 1
        # layout: int32 pixel_type, uchar pLinear + 3 reserved, int32 xSampling, int32 ySampling
        ptype, _, xs, ys = struct.unpack_from("<iiii", data, off)
        off += 16
        channels.append((name, ptype, xs, ys))
    return channels


def _unzip_block(data: bytes, expected: int) -> bytes:
    raw = zlib.decompress(data)
    if len(raw) != expected:
        raise ValueError("unexpected EXR block size")
    # inverse byte predictor, vectorised: o_i = (Σ_{j<=i} a_j − 128·i) mod 256
    a = np.frombuffer(raw, np.uint8).astype(np.int64)
    out = ((np.cumsum(a) - 128 * np.arange(len(a))) % 256).astype(np.uint8)
    # de-interleave: first half -> even positions, second half -> odd
    n = len(out)
    half = (n + 1) // 2
    final = np.empty(n, np.uint8)
    final[0::2] = out[:half]
    final[1::2] = out[half:]
    return final.tobytes()


def read_exr(path: str) -> Dict[str, np.ndarray]:
    """Read an EXR file → {channel_name: [H, W] array}."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    if version & 0x200:
        raise ValueError("tiled EXR not supported")
    attrs, off = _read_attrs(buf, 8)

    channels = _parse_channels(attrs["channels"][1])
    xmin, ymin, xmax, ymax = struct.unpack("<iiii", attrs["dataWindow"][1])
    width = xmax - xmin + 1
    height = ymax - ymin + 1
    compression = attrs["compression"][1][0]
    if compression not in (0, 2, 3):
        raise ValueError(f"unsupported EXR compression {compression}")
    lines_per_block = _COMPRESSION_LINES[compression]

    n_blocks = (height + lines_per_block - 1) // lines_per_block
    off += 8 * n_blocks  # skip the line-offset table

    bytes_per_px = {name: np.dtype(_PIXEL_DTYPES[pt]).itemsize for name, pt, _, _ in channels}
    line_bytes = sum(bytes_per_px[c[0]] * width for c in channels)

    out = {name: np.zeros((height, width), _PIXEL_DTYPES[pt]) for name, pt, _, _ in channels}
    for _ in range(n_blocks):
        y, size = struct.unpack_from("<ii", buf, off)
        off += 8
        data = buf[off : off + size]
        off += size
        n_lines = min(lines_per_block, ymax - y + 1)
        expected = line_bytes * n_lines
        if compression == 0:
            raw = data
        else:
            raw = _unzip_block(data, expected)
        pos = 0
        for line in range(n_lines):
            yy = y - ymin + line
            for name, pt, _, _ in channels:  # channels are stored sorted
                nb = bytes_per_px[name] * width
                out[name][yy] = np.frombuffer(raw[pos : pos + nb], _PIXEL_DTYPES[pt])
                pos += nb
    return out


def write_exr(path: str, channels: Dict[str, np.ndarray], compression: int = 3) -> None:
    """Write a minimal scanline EXR (for tests and dataset generation)."""
    names = sorted(channels)
    h, w = channels[names[0]].shape
    dtype_code = {np.dtype(np.uint32): 0, np.dtype(np.float16): 1, np.dtype(np.float32): 2}

    def attr(name, typ, data):
        return name.encode() + b"\0" + typ.encode() + b"\0" + struct.pack("<i", len(data)) + data

    chlist = b""
    for n in names:
        code = dtype_code[np.dtype(channels[n].dtype)]
        chlist += n.encode() + b"\0" + struct.pack("<iiii", code, 0, 1, 1)
    chlist += b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (
        attr("channels", "chlist", chlist)
        + attr("compression", "compression", bytes([compression]))
        + attr("dataWindow", "box2i", box)
        + attr("displayWindow", "box2i", box)
        + attr("lineOrder", "lineOrder", b"\0")
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\0"
    )
    lines_per_block = _COMPRESSION_LINES[compression]
    n_blocks = (h + lines_per_block - 1) // lines_per_block

    blocks = []
    for b in range(n_blocks):
        y0 = b * lines_per_block
        n_lines = min(lines_per_block, h - y0)
        raw = b"".join(
            channels[n][y0 + line].tobytes()
            for line in range(n_lines)
            for n in names
        )
        if compression == 0:
            data = raw
        else:
            # forward predictor: interleave-split then delta-encode
            arr = np.frombuffer(raw, np.uint8)
            half = (len(arr) + 1) // 2
            split = np.empty_like(arr)
            split[:half] = arr[0::2]
            split[half:] = arr[1::2]
            s = split.astype(np.int64)
            enc = np.empty_like(split)
            enc[0] = split[0]
            enc[1:] = ((s[1:] - s[:-1] + 128) % 256).astype(np.uint8)
            data = zlib.compress(enc.tobytes())
        blocks.append((y0, data))

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(header)
        table_pos = f.tell()
        offset = table_pos + 8 * n_blocks
        for y0, data in blocks:
            f.write(struct.pack("<q", offset))
            offset += 8 + len(data)
        for y0, data in blocks:
            f.write(struct.pack("<ii", y0, len(data)))
            f.write(data)
