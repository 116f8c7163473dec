"""Export the glyphs of OpenCV's FONT_HERSHEY_TRIPLEX for the PyTorch port.

``cppf_tpu_torch/eval/viz.py::draw_text`` draws text as the JAX package's
``draw_text`` does, with ``cv2.putText(..., FONT_HERSHEY_TRIPLEX, 1, color,
1)``, but the card has no ``cv2``.  OpenCV 5 draws a glyph antialiased:
each pixel of it takes ``bg + (color - bg)·a/255``, rounded, for the
glyph's coverage ``a`` there, and the glyphs of a string are blended one
after another, each at the origin advanced by the widths less one of the
glyphs before it.  At scale 1 and thickness 1 a glyph's coverage does not
change as its origin moves by whole pixels, so one table of coverages
draws any string (held against ``cv2.putText`` by
``tests/test_torch_viz_text.py``).  This script renders each of the 95
printable ASCII characters alone with ``cv2.putText`` at an origin 60
pixels from every edge of its canvas (a glyph reaches 2 pixels left of its
origin, 26 above and 6 below it, so no stroke is cut) and writes into
``cppf_tpu_torch/assets/hershey_triplex.npz``:

- ``codes`` uint8 [95]: the characters, 32 (space) to 126 (``~``);
- ``start`` int32 [96]: glyph k's pixels are ``offsets[start[k]:start[k + 1]]``;
- ``offsets`` int8 [n, 2]: each pixel's (x, y) offset from the origin
  (x right, y down; the origin is the baseline's left end);
- ``alpha`` uint8 [n]: each pixel's coverage, 1 to 255 (255: the colour
  itself), the glyph drawn in 255 on 0;
- ``advance`` int16 [95]: ``cv2.getTextSize(ch)`` width less one;
- ``height``, ``baseline`` int16 [95]: ``cv2.getTextSize(ch)``'s height
  and baseline (a string's are the maxima over its characters);
- ``source``: where the data comes from.

The pixels are rendered with OpenCV (Apache-2.0) from the Hershey fonts,
which Dr. A. V. Hershey created at the U.S. National Bureau of Standards.

Usage (needs cv2; a second): python scripts/export_torch_hershey.py
"""
from __future__ import annotations

import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "cppf_tpu_torch", "assets", "hershey_triplex.npz")
CANVAS = 120
ORIGIN = 60


def export() -> dict:
    import cv2

    font = cv2.FONT_HERSHEY_TRIPLEX
    codes = np.arange(32, 127, dtype=np.uint8)
    offsets, alpha, start, advance, height, baseline = [], [], [0], [], [], []
    for code in codes:
        ch = chr(code)
        img = np.zeros((CANVAS, CANVAS), np.uint8)
        cv2.putText(img, ch, (ORIGIN, ORIGIN), font, 1, 255, 1)
        ys, xs = np.nonzero(img)
        if len(xs) and (min(xs.min(), ys.min()) == 0 or max(xs.max(), ys.max()) == CANVAS - 1):
            raise RuntimeError(f"glyph {ch!r} reaches the edge of its canvas")
        offsets.append(np.stack([xs - ORIGIN, ys - ORIGIN], 1))
        alpha.append(img[ys, xs])
        start.append(start[-1] + len(xs))
        (w, h), b = cv2.getTextSize(ch, font, 1, 1)
        advance.append(w - 1)
        height.append(h)
        baseline.append(b)
    table = dict(codes=codes, start=np.asarray(start, np.int32),
                 offsets=np.concatenate(offsets).astype(np.int8),
                 alpha=np.concatenate(alpha).astype(np.uint8),
                 advance=np.asarray(advance, np.int16), height=np.asarray(height, np.int16),
                 baseline=np.asarray(baseline, np.int16),
                 source=np.array(f"cv2.putText FONT_HERSHEY_TRIPLEX, scale 1, thickness 1, "
                                 f"rendered with OpenCV {cv2.__version__} (Apache-2.0) from the "
                                 f"Hershey fonts (Dr. A. V. Hershey, U.S. National Bureau of "
                                 f"Standards)"))
    np.savez_compressed(OUT, **table)
    return table


if __name__ == "__main__":
    t = export()
    print(f"wrote {OUT}: {len(t['codes'])} glyphs, {len(t['offsets'])} pixels, "
          f"{os.path.getsize(OUT)} bytes")
