"""The port's PNG reader (data/png.py, zlib + numpy) against cv2.imread:
bit for bit on the real REAL275 demo frame, the committed NOCS frame and
seeded images that cv2 writes at every compression level (which makes its
encoder try every scanline filter)."""
import importlib.util
import os

import cv2
import numpy as np
import pytest

from cppf_tpu_torch.data.png import decode_png, read_png
from cppf_tpu_torch.models.convert import ASSETS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "time_png", os.path.join(ROOT, "scripts", "time_png.py"))
time_png = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(time_png)
FILES = [os.path.join(ROOT, "data", "demo", "0000_depth.png"),
         os.path.join(ROOT, "data", "demo", "0000_color.png"),
         os.path.join(ASSETS, "nocs_frame", "real", "scene_1", "0000_depth.png"),
         os.path.join(ASSETS, "nocs_frame", "real", "scene_1", "0000_color.png")]


def _rgb(img):
    """cv2's BGR(A) in RGB(A) order."""
    if img.ndim == 2:
        return img
    return img[:, :, [2, 1, 0, 3][: img.shape[2]]]


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_frames_equal_cv2(path):
    got = read_png(path)
    want = _rgb(cv2.imread(path, -1))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _images(rng):
    """16-bit depth-like grey with holes, 8-bit grey, smooth RGB, noisy RGBA."""
    yy, xx = np.mgrid[0:37, 0:53]
    depth = (700 + 3 * xx + 5 * yy + rng.integers(0, 40, xx.shape)) * (rng.random(xx.shape) > 0.2)
    smooth = cv2.GaussianBlur(rng.integers(0, 256, (37, 53, 3)).astype(np.uint8), (7, 7), 2)
    return {"grey16": depth.astype(np.uint16),
            "grey8": rng.integers(0, 256, (37, 53)).astype(np.uint8),
            "rgb8": smooth,
            "rgba8": rng.integers(0, 256, (37, 53, 4)).astype(np.uint8)}


@pytest.mark.parametrize("level", range(10))
def test_cv2_encodings_decode_exactly(level):
    for name, img in _images(np.random.default_rng(level)).items():
        ok, enc = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        assert ok
        got = decode_png(enc.tobytes())
        np.testing.assert_array_equal(got, _rgb(cv2.imdecode(enc, -1)), err_msg=name)
        assert got.dtype == img.dtype


def _filter_types(data, stride):
    import struct
    import zlib

    pos, idat = 8, []
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + length])
        pos += 12 + length
    raw = zlib.decompress(b"".join(idat))
    return {raw[i] for i in range(0, len(raw), stride + 1)}


def test_every_filter_type_is_met():
    """Over the levels the noisy RGBA images use all five filters, so the
    cases above decode each of them."""
    seen = set()
    for level in range(10):
        img = _images(np.random.default_rng(level))["rgba8"]
        seen |= _filter_types(cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION,
                                                         level])[1].tobytes(), 53 * 4)
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("kinds", ["average", "paeth", "every filter"])
@pytest.mark.parametrize("path", FILES[:2], ids=["depth", "colour"])
def test_real_frame_with_any_filters(path, kinds):
    """Every row of the demo frame's PNGs is filtered Sub.  Written again
    with every row Average, every row Paeth, or row y with filter y mod 5
    (the reader's diagonal route), each still decodes to cv2's image bit
    for bit."""
    want = cv2.imread(path, -1)
    h = want.shape[0]
    rows = {"average": [3] * h, "paeth": [4] * h, "every filter": [y % 5 for y in range(h)]}
    data = time_png.encode_png(_rgb(want), rows[kinds])
    assert time_png.filter_counts(data, want) == np.bincount(rows[kinds], minlength=5).tolist()
    np.testing.assert_array_equal(_rgb(cv2.imdecode(np.frombuffer(data, np.uint8), -1)),
                                  _rgb(want))
    np.testing.assert_array_equal(decode_png(data), _rgb(want))


def test_rejects_what_it_cannot_read():
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + bytes(20))
    ok, enc = cv2.imencode(".png", np.zeros((4, 4), np.uint8))
    data = bytearray(enc.tobytes())
    data[24] = 4  # IHDR bit depth 4
    with pytest.raises(ValueError, match="bit depth 4"):
        decode_png(bytes(data))
