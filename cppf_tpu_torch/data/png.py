"""PNG decoding and encoding on ``zlib`` and numpy, for the frames the
drivers read and the pictures the zero-shot CLI writes.

Handles what the NOCS and demo frames use: 8- and 16-bit greyscale (depth in
millimetres), 8-bit RGB and RGBA (colour), grey with alpha, and every
scanline filter (None, Sub, Up, Average, Paeth).  No palette, no bit depth
below 8 and no Adam7 interlace: those raise.  16-bit samples come back as
native ``uint16``; colour comes back in RGB(A) order (``cv2.imread`` gives
BGR).  :func:`write_png` writes 8-bit grey, grey with alpha, RGB and RGBA
and 16-bit grey, every scanline with filter 0 (None).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type → samples a pixel
_COLOUR_TYPE = {c: t for t, c in _CHANNELS.items()}


def read_png(path: str) -> np.ndarray:
    """The image of the PNG file ``path``: [H, W] for greyscale, else
    [H, W, C]."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def decode_png(data: bytes) -> np.ndarray:
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length  # length, type, body, CRC
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if depth not in (8, 16) or color not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {color}, "
                         f"interlace {interlace}")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, not {height * (stride + 1)}")
    lines = raw.reshape(height, stride + 1)
    kinds = lines[:, 0]
    if kinds.max() > 4:
        raise ValueError(f"unknown PNG filter type {kinds.max()}")
    if kinds.max() <= 2:
        out = np.empty((height, stride), np.uint8)
        prev = np.zeros(stride, np.uint8)
        for y in range(height):
            out[y] = prev = _unfilter_line(int(kinds[y]), lines[y, 1:], prev, bpp)
    else:
        out = _unfilter_diagonals(lines, bpp)
    img = out.view(">u2").astype(np.uint16) if depth == 16 else out
    img = img.reshape(height, width, channels)
    return img[:, :, 0] if channels == 1 else img


def _unfilter_line(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """One reconstructed scanline filtered None, Sub or Up, from its
    filtered bytes and the line above (PNG specification, section 9)."""
    if kind == 0:
        return line
    if kind == 1:  # Sub: a running sum over the pixels, mod 256 in uint8
        return np.cumsum(line.reshape(-1, bpp), 0, dtype=np.uint8).reshape(-1)
    return line + prev  # Up


def _unfilter_diagonals(lines: np.ndarray, bpp: int) -> np.ndarray:
    """All scanlines, any mix of the five filters.  Average and Paeth read
    the reconstructed pixel to the left, so a line cannot be undone in one
    vector operation; but a pixel needs only its left, upper and upper-left
    neighbours, so all pixels on an anti-diagonal (row + column = t) are
    undone together, in H + W - 1 steps over at most H pixels each.  ``S[t]``
    holds diagonal t, row y at ``S[t, y + 1]``: its left neighbour is
    ``S[t - 1, y + 1]``, the upper ``S[t - 1, y]``, the upper-left
    ``S[t - 2, y]``; row -1 and the slots left of column 0 stay zero, as
    the specification has them, and slots right of the last column are
    computed but never read."""
    height = lines.shape[0]
    filtered = lines[:, 1:].reshape(height, -1, bpp)
    width = filtered.shape[1]
    y, x = np.arange(height)[:, None], np.arange(width)[None, :]
    n = height * bpp
    fs = np.zeros((height + width - 1, height, bpp), np.int32)
    fs[y + x, y] = filtered
    fs = fs.reshape(-1, n)
    s = np.zeros((height + width + 1, n + bpp), np.int32)
    rows_of = [np.repeat(lines[:, 0] == k, bpp) for k in range(4)]
    for t in range(height + width - 1):
        a, b, c = s[t + 1, bpp:], s[t + 1, :n], s[t, :n]
        pa, pb = b - c, a - c  # Paeth's distances |p - a|, |p - b|, |p - c|
        pc = np.abs(pa + pb)
        pa, pb = np.abs(pa), np.abs(pb)
        pred = np.where(pb <= pc, b, c)  # Paeth, then the other filters' rows
        np.copyto(pred, a, where=(pa <= pb) & (pa <= pc))
        np.copyto(pred, (a + b) >> 1, where=rows_of[3])
        np.copyto(pred, b, where=rows_of[2])
        np.copyto(pred, a, where=rows_of[1])
        np.copyto(pred, 0, where=rows_of[0])
        np.bitwise_and(fs[t] + pred, 0xFF, out=s[t + 2, bpp:])
    s = s[:, bpp:].reshape(-1, height, bpp)
    return s[y + x + 2, y].astype(np.uint8).reshape(height, -1)


def write_png(path: str, img: np.ndarray) -> None:
    """Write ``img`` to ``path`` as a PNG: uint8 [H, W] (grey), [H, W, 2]
    (grey and alpha), [H, W, 3] (RGB) or [H, W, 4] (RGBA), or uint16
    [H, W] (grey).  ``read_png`` gives the array back."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def encode_png(img: np.ndarray) -> bytes:
    img = np.asarray(img)
    channels = 1 if img.ndim == 2 else (img.shape[2] if img.ndim == 3 else 0)
    if (img.dtype not in (np.uint8, np.uint16) or channels not in _COLOUR_TYPE
            or (img.dtype == np.uint16 and channels != 1) or min(img.shape[:2], default=0) < 1):
        raise ValueError(f"write_png writes uint8 grey, grey-alpha, RGB or RGBA and uint16 grey, "
                         f"not {img.dtype} {img.shape}")
    height, width = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).view(np.uint8)
    lines = np.concatenate([np.zeros((height, 1), np.uint8), rows.reshape(height, -1)], 1)
    header = struct.pack(">IIBBBBB", width, height, depth, _COLOUR_TYPE[channels], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(lines.tobytes()))
            + _chunk(b"IEND", b""))


def _chunk(kind: bytes, body: bytes) -> bytes:
    """One chunk: length, type, body, and the CRC-32 of type and body."""
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
