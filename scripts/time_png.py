"""Times the port's PNG reader (cppf_tpu_torch/data/png.py) on frames as
their encoder filtered them, and on the same images written again with
every scanline filtered Paeth, the slowest filter to undo.  Prints, for
each file, its size, the count of each filter type among its rows and the
median decode time.  numpy and zlib only (no cv2), so it runs where the
port runs.

Usage: python3 scripts/time_png.py [PNG ...]   (default: the demo frame's
and the committed NOCS frame's depth and colour PNGs)
"""
import argparse
import os
import struct
import sys
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from cppf_tpu_torch.data.png import decode_png  # noqa: E402

FRAMES = ["data/demo/0000_depth.png", "data/demo/0000_color.png",
          "cppf_tpu_torch/assets/nocs_frame/real/scene_1/0000_depth.png",
          "cppf_tpu_torch/assets/nocs_frame/real/scene_1/0000_color.png"]


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray, kinds) -> bytes:
    """PNG bytes of ``img`` (uint8 or uint16; [H, W] grey, [H, W, 3] RGB or
    [H, W, 4] RGBA), row y filtered with filter type ``kinds[y]`` (0-4)."""
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    bits = 16 if img.dtype == np.uint16 else 8
    bpp = channels * bits // 8
    raw = np.ascontiguousarray(img.astype(">u2") if bits == 16 else img)
    raw = raw.view(np.uint8).reshape(h, w * bpp).astype(np.int16)
    a = np.zeros_like(raw)
    a[:, bpp:] = raw[:, :-bpp]
    b = np.zeros_like(raw)
    b[1:] = raw[:-1]
    c = np.zeros_like(raw)
    c[1:, bpp:] = raw[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(raw), a, b, (a + b) >> 1, paeth])
    kinds = np.asarray(kinds, np.uint8)
    lines = (raw - preds[kinds, np.arange(h)]) & 0xFF
    body = np.concatenate([kinds[:, None], lines.astype(np.uint8)], 1).tobytes()
    color = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, color,
                                                              0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(body)) + _chunk(b"IEND", b""))


def filter_counts(data: bytes, img: np.ndarray) -> list:
    """How many rows of the PNG ``data`` (decoded: ``img``) use each filter
    type 0-4."""
    pos, idat = 8, []
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + length])
        pos += 12 + length
    stride = img[0].size * img.itemsize
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return np.bincount(raw.reshape(img.shape[0], stride + 1)[:, 0], minlength=5).tolist()


def median_ms(data: bytes, repeats: int = 5) -> float:
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        decode_png(data)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pngs", nargs="*", default=[os.path.join(ROOT, p) for p in FRAMES])
    for path in ap.parse_args().pngs:
        with open(path, "rb") as f:
            data = f.read()
        img = decode_png(data)
        paeth = encode_png(img, [4] * img.shape[0])
        if not np.array_equal(decode_png(paeth), img):
            raise SystemExit(f"{path}: the Paeth re-encoding does not decode to the image")
        print(f"{os.path.relpath(path, ROOT)} {img.shape} {img.dtype}: {len(data)} bytes, "
              f"rows by filter type 0-4 {filter_counts(data, img)}, read {median_ms(data):.2f} "
              f"ms; every row Paeth ({len(paeth)} bytes) {median_ms(paeth):.2f} ms "
              "(median of 5)", flush=True)


if __name__ == "__main__":
    main()
