"""Drawing of projected boxes (counterpart of cppf_tpu/eval/viz.py; reference
utils/util.py:529-595).

Lines are drawn without ``cv2``, by the rules of OpenCV's
``imgproc/src/drawing.cpp``: :func:`draw_line` paints the pixels of
``cv2.line(img, p, q, color, thickness)`` with its default 8-connected line
type and integer end points.

- Thickness 1: the end points are clipped to the image (Cohen-Sutherland,
  each crossing truncated toward zero), then one Bresenham pass from the
  left end point, one pixel a step along the major axis and a step along
  the minor one where the error term is below 0 (``LineIterator``).
- Thicker: the end points are clipped in the same way to the image grown
  by the thickness on every side; the band between them, its corners
  offset by the rounded ``thickness / 2`` normal in 16.16 fixed point, is
  filled as a convex polygon (``FillConvexPoly``: its outline by the
  fixed-point line ``Line2``, its rows between the two edges, each edge's
  x advanced a row by its rounded fixed-point slope); a filled midpoint
  circle of radius ``(thickness + 1) // 2`` caps each original end point
  (``Circle``).  Pixels outside the image are dropped.

Rectangles (``cv2.rectangle``) are the four lines of their outline at the
thickness, or filled, the box clipped to the image.  Text
(:func:`put_text`, ``cv2.putText`` in ``FONT_HERSHEY_TRIPLEX`` at scale 1
and thickness 1) is drawn from a table of the font's glyphs,
``assets/hershey_triplex.npz`` (``scripts/export_torch_hershey.py``,
rendered with OpenCV from the Hershey fonts): each glyph's pixels and
their coverage ``a``.  OpenCV 5 draws a glyph antialiased, a pixel taking
``bg + (color - bg)·a/255`` rounded, and blends the glyphs of a string
one after another, each at the origin advanced by the widths less one of
the glyphs before it; at scale 1 the coverage moves with the origin.
"""
from __future__ import annotations

import math
import os

import numpy as np

from cppf_tpu_torch.core.geometry import (calculate_2d_projections, get_3d_bbox,
                                          transform_coordinates_3d)

FONT_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                         "hershey_triplex.npz")
XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
HALF = XY_ONE >> 1

# edges of the get_3d_bbox corner ordering (see core.geometry.get_3d_bbox)
BBOX_EDGES = [
    (4, 5), (5, 7), (4, 6), (6, 7),    # ground (-y) layer
    (0, 4), (1, 5), (2, 6), (3, 7),    # pillars
    (0, 1), (1, 3), (0, 2), (2, 3),    # top (+y) layer
]


def _div(a: int, b: int) -> int:
    """C's integer division, which truncates toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """The segment clipped to [0, width) × [0, height) (OpenCV's
    ``clipLine``): the clipped end points, or None where nothing of it is
    inside."""
    if width <= 0 or height <= 0:
        return None
    right, bottom = width - 1, height - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _line_pixels(shape, x1: int, y1: int, x2: int, y2: int):
    """Pixels (xs, ys) of the 8-connected line between integer points, as
    ``LineIterator`` walks it from the left end point."""
    clipped = clip_line(shape[1], shape[0], x1, y1, x2, y2)
    if clipped is None:
        return [], []
    x1, y1, x2, y2 = clipped
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    xs, ys = [], []
    x, y = x1, y1
    for _ in range(dx + 1):
        xs.append(x)
        ys.append(y)
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += sy
            x += 1 if minor else 0
        else:
            x += 1
            y += sy if minor else 0
    return xs, ys


def _hline(mask: np.ndarray, y: int, xl: int, xr: int) -> None:
    if 0 <= y < mask.shape[0]:
        xl, xr = max(xl, 0), min(xr, mask.shape[1] - 1)
        if xl <= xr:
            mask[y, xl:xr + 1] = True


def _put(mask: np.ndarray, x: int, y: int) -> None:
    if 0 <= x < mask.shape[1] and 0 <= y < mask.shape[0]:
        mask[y, x] = True


def _line_fixed(mask: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> None:
    """The line between 16.16 fixed-point end points (OpenCV's ``Line2``),
    clipped to the image: from the end point with the smaller major
    coordinate, one pixel a step along the major axis, the minor
    coordinate advanced by the fixed-point slope truncated toward zero;
    and the far end point rounded."""
    h, w = mask.shape
    clipped = clip_line(w << XY_SHIFT, h << XY_SHIFT, x1, y1, x2, y2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    x_major = abs(dx) > abs(dy)
    if x_major:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        step = _div(dy << XY_SHIFT, abs(dx) | 1)
        count = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        step = _div(dx << XY_SHIFT, abs(dy) | 1)
        count = (y2 - y1) >> XY_SHIFT
    _put(mask, (x2 + HALF) >> XY_SHIFT, (y2 + HALF) >> XY_SHIFT)
    major, minor = (x1, y1) if x_major else (y1, x1)
    major = (major + HALF) >> XY_SHIFT
    minor += HALF
    for _ in range(count + 1):
        if x_major:
            _put(mask, major, minor >> XY_SHIFT)
        else:
            _put(mask, minor >> XY_SHIFT, major)
        major += 1
        minor += step


def _fill_convex(mask: np.ndarray, pts) -> None:
    """A convex polygon of 16.16 fixed-point vertices (OpenCV's
    ``FillConvexPoly`` at ``shift`` 16): its outline by
    :func:`_line_fixed`, then each row from the left edge to the right,
    each edge's x advanced by its rounded fixed-point slope a row."""
    n = len(pts)
    h, w = mask.shape
    p0 = pts[-1]
    for p in pts:
        _line_fixed(mask, p0[0], p0[1], p[0], p[1])
        p0 = p
    xs, ys = [p[0] for p in pts], [p[1] for p in pts]
    imin = int(np.argmin(ys))
    xmin, xmax = (min(xs) + HALF) >> XY_SHIFT, (max(xs) + HALF) >> XY_SHIFT
    ymin, ymax = (ys[imin] + HALF) >> XY_SHIFT, (max(ys) + HALF) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = n
    # [idx, di, x, dx, ye] of the left-going and the right-going edge
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, n - 1, -XY_ONE, 0, ymin]]
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0 = e[0]
                idx = (idx0 + e[1]) % n
                while edges > 0:
                    edges -= 1
                    ty = (pts[idx][1] + HALF) >> XY_SHIFT
                    if ty > y:
                        xs0, xe0 = pts[idx0][0], pts[idx][0]
                        e[4] = ty
                        e[3] = _div((xe0 - xs0) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs0
                        e[0] = idx
                        break
                    idx0 = idx
                    idx = (idx + e[1]) % n
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = sorted(edge, key=lambda e: e[2])
            _hline(mask, y, (left[2] + HALF) >> XY_SHIFT, (right[2] + HALF) >> XY_SHIFT)
        for e in edge:
            e[2] += e[3]
        y += 1
        if y > ymax:
            break


def _fill_circle(mask: np.ndarray, cx: int, cy: int, radius: int) -> None:
    """OpenCV's filled midpoint circle (``Circle`` with ``fill``)."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        _hline(mask, cy - dy, cx - dx, cx + dx)
        _hline(mask, cy + dy, cx - dx, cx + dx)
        _hline(mask, cy - dx, cx - dy, cx + dy)
        _hline(mask, cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def line_mask(shape, p, q, thickness: int = 1) -> np.ndarray:
    """The pixels [H, W] bool that ``cv2.line`` paints for integer points
    ``p``, ``q`` (x, y) at ``thickness`` on an image of ``shape``."""
    if thickness < 1:
        raise ValueError(f"thickness {thickness} < 1")
    mask = np.zeros(shape[:2], bool)
    x0, y0, x1, y1 = int(p[0]), int(p[1]), int(q[0]), int(q[1])
    if thickness == 1:
        xs, ys = _line_pixels(mask.shape, x0, y0, x1, y1)
        mask[ys, xs] = True
        return mask
    # the band runs between the end points clipped to the image grown by
    # the thickness on every side; the caps stay on the end points
    grown = clip_line(shape[1] + 2 * thickness, shape[0] + 2 * thickness, x0 + thickness,
                      y0 + thickness, x1 + thickness, y1 + thickness)
    if grown is not None:
        _band(mask, *((v - thickness) << XY_SHIFT for v in grown), thickness)
    radius = ((thickness << (XY_SHIFT - 1)) + HALF) >> XY_SHIFT
    for x, y in ((x0, y0), (x1, y1)):
        _fill_circle(mask, x, y, radius)
    return mask


def _band(mask: np.ndarray, fx0: int, fy0: int, fx1: int, fy1: int, thickness: int) -> None:
    """The band of ``thickness`` between 16.16 fixed-point end points: its
    four corners offset from them by the rounded normal, filled."""
    dx, dy = (fx0 - fx1) / XY_ONE, (fy1 - fy0) / XY_ONE
    r = dx * dx + dy * dy
    half = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + (thickness & 1) * XY_ONE * 0.5) / math.sqrt(r)
        ox, oy = round(dy * r), round(dx * r)  # cvRound: halves to even
        _fill_convex(mask, [(fx0 + ox, fy0 + oy), (fx0 - ox, fy0 - oy),
                            (fx1 - ox, fy1 - oy), (fx1 + ox, fy1 + oy)])


def _paint(img: np.ndarray, mask: np.ndarray, color, what: str) -> np.ndarray:
    """``color`` (a channel a value, as cv2 takes it) into the ``mask``
    pixels of the uint8 [H, W] or [H, W, C] ``img``, in place."""
    if img.dtype != np.uint8:
        raise ValueError(f"{what} draws on uint8 images, not {img.dtype}")
    channels = 1 if img.ndim == 2 else img.shape[2]
    value = np.clip(np.rint(np.atleast_1d(np.asarray(color, np.float64))[:channels]), 0,
                    255).astype(np.uint8)
    img[mask] = value if img.ndim == 3 else value[0]
    return img


def draw_line(img: np.ndarray, p, q, color, thickness: int = 1) -> np.ndarray:
    """``cv2.line(img, p, q, color, thickness)`` on a uint8 [H, W] or
    [H, W, C] image: paints it in place and returns it."""
    return _paint(img, line_mask(img.shape, p, q, thickness), color, "draw_line")


def rectangle_mask(shape, p, q, thickness: int = 1) -> np.ndarray:
    """The pixels [H, W] bool that ``cv2.rectangle`` paints for the integer
    corners ``p``, ``q`` (x, y): the four lines of the outline at
    ``thickness`` (:func:`line_mask`), or for a negative ``thickness`` the
    filled box, clipped to the image."""
    x0, y0, x1, y1 = int(p[0]), int(p[1]), int(q[0]), int(q[1])
    mask = np.zeros(shape[:2], bool)
    if thickness < 0:
        xl, xr = max(min(x0, x1), 0), min(max(x0, x1), shape[1] - 1)
        yt, yb = max(min(y0, y1), 0), min(max(y0, y1), shape[0] - 1)
        if xl <= xr and yt <= yb:
            mask[yt:yb + 1, xl:xr + 1] = True
        return mask
    corners = ((x0, y0), (x1, y0), (x1, y1), (x0, y1))
    for k in range(4):
        mask |= line_mask(shape, corners[k - 1], corners[k], thickness)
    return mask


def draw_rectangle(img: np.ndarray, p, q, color, thickness: int = 1) -> np.ndarray:
    """``cv2.rectangle(img, p, q, color, thickness)`` (negative: filled) on
    a uint8 image, in place."""
    return _paint(img, rectangle_mask(img.shape, p, q, thickness), color, "draw_rectangle")


_FONT: dict = {}


def _font() -> dict:
    """The glyph table, read at first use: {code: (pixel offsets [n, 2],
    coverage [n], advance, height, baseline)}."""
    if not _FONT:
        with np.load(FONT_PATH) as z:
            start, offsets = z["start"], z["offsets"].astype(np.int64)
            alpha = z["alpha"].astype(np.int64)
            for k, code in enumerate(z["codes"]):
                sl = slice(start[k], start[k + 1])
                _FONT[int(code)] = (offsets[sl], alpha[sl], int(z["advance"][k]),
                                    int(z["height"][k]), int(z["baseline"][k]))
    return _FONT


def _glyphs(text: str) -> list:
    font = _font()
    missing = sorted({ch for ch in text if ord(ch) not in font})
    if missing:
        raise ValueError(f"no Hershey glyph for {missing}: the table holds printable ASCII")
    return [font[ord(ch)] for ch in text]


def text_size(text: str):
    """``cv2.getTextSize(text, FONT_HERSHEY_TRIPLEX, 1, 1)``: ((width,
    height), baseline)."""
    glyphs = _glyphs(text)
    if not glyphs:
        return (0, 0), 0
    return ((sum(g[2] for g in glyphs) + 1, max(g[3] for g in glyphs)),
            max(g[4] for g in glyphs))


def put_text(img: np.ndarray, text: str, org, color) -> np.ndarray:
    """``cv2.putText(img, text, org, FONT_HERSHEY_TRIPLEX, 1, color, 1)``
    (``org``: the baseline's left end, x and y) on a uint8 [H, W] or
    [H, W, C] image, in place."""
    if img.dtype != np.uint8:
        raise ValueError(f"put_text draws on uint8 images, not {img.dtype}")
    channels = 1 if img.ndim == 2 else img.shape[2]
    fg = np.clip(np.rint(np.atleast_1d(np.asarray(color, np.float64))[:channels]), 0,
                 255).astype(np.int64)
    x, y = int(org[0]), int(org[1])
    for offsets, alpha, advance, _, _ in _glyphs(text):
        px, py = offsets[:, 0] + x, offsets[:, 1] + y
        inside = (px >= 0) & (px < img.shape[1]) & (py >= 0) & (py < img.shape[0])
        px, py, a = px[inside], py[inside], alpha[inside]
        bg = img[py, px].astype(np.int64).reshape(len(a), channels)
        # bg + (fg - bg)·a/255 rounded: 255 is odd, so no value sits on a half
        out = bg + ((fg - bg) * a[:, None] + 127) // 255
        img[py, px] = out.astype(np.uint8).reshape(img[py, px].shape)
        x += advance
    return img


def draw_text(img: np.ndarray, bbox, text: str, draw_bbox: bool = False) -> np.ndarray:
    """Labelled text box anchored near a 2D ``bbox`` (row min, col min, row
    max, col max; reference utils/util.py:559): a blue box with a black
    outline, white text, and with ``draw_bbox`` the bbox in blue at
    thickness 2; on a uint8 image, in place."""
    (tw, th), _ = text_size(text)
    margin = 10
    tl = (min(int(bbox[1]) + margin, img.shape[1] - 5 - tw - 2 * margin),
          min(int(bbox[2]) + margin, img.shape[0] - 5 - th - 2 * margin))
    br = (tl[0] + tw + 2 * margin, tl[1] + th + 2 * margin)
    if draw_bbox:
        draw_rectangle(img, (bbox[1], bbox[0]), (bbox[3], bbox[2]), (255, 0, 0), 2)
    draw_rectangle(img, tl, br, (255, 0, 0), -1)
    draw_rectangle(img, tl, br, (0, 0, 0), 1)
    return put_text(img, text, (tl[0] + margin, br[1] - margin - 3), (255, 255, 255))


def draw_box(img: np.ndarray, imgpts: np.ndarray, axes, color) -> np.ndarray:
    """Draw a projected 3D box (+optional axes) with the reference's layered
    shading (darker ground, mid pillars, full-color top)."""
    imgpts = np.int32(imgpts).reshape(-1, 2)
    shades = [0.3] * 4 + [0.6] * 4 + [1.0] * 4
    for (i, j), s in zip(BBOX_EDGES, shades):
        img = draw_line(img, imgpts[i], imgpts[j], tuple(int(ch * s) for ch in color), 3)
    if axes is not None:
        axes = np.int32(axes)
        img = draw_line(img, axes[0], axes[1], (0, 0, 255), 3)  # z
        img = draw_line(img, axes[0], axes[3], (255, 0, 0), 3)  # x
        img = draw_line(img, axes[0], axes[2], (0, 255, 0), 3)  # y
    return img


def render_pose_overlay(img: np.ndarray, RT: np.ndarray, scale_unit: np.ndarray,
                        intrinsics: np.ndarray, color=(255, 0, 0), axis_len: float = 0.3):
    """Project a 9D pose into the image and draw its box + axes."""
    xyz_axis = axis_len * np.array([[0, 0, 0], [0, 0, 1], [0, 1, 0], [1, 0, 0]]).T
    proj_axes = calculate_2d_projections(transform_coordinates_3d(xyz_axis, RT), intrinsics)
    bbox3d = get_3d_bbox(scale_unit, 0)
    proj_box = calculate_2d_projections(transform_coordinates_3d(bbox3d, RT), intrinsics)
    return draw_box(img, proj_box, proj_axes, color)
