"""Observed-extent box anchoring of a voted center (counterpart of
cppf_tpu/eval/anchor.py, kept as the port's own numpy copy).

The regression decode of the zero-shot path places a center with a bias
toward the visible surface mass.  The voted (R, scale) define an oriented
box and the instance's observed points pin where it must sit: an axis
whose points span nearly the full predicted extent takes their midpoint;
a partly seen axis that points along the view ray anchors its
camera-facing face to the near extreme; a truncated lateral axis keeps the
voted coordinate.
"""
from __future__ import annotations

import numpy as np


def anchor_box_t(
    T: np.ndarray,
    R: np.ndarray,
    scale: np.ndarray,
    points: np.ndarray,
    span_frac: float = 0.8,
    clip: float = 0.05,
    q: float = 0.02,
    min_points: int = 20,
    view_min: float = 0.5,
    gate_frac: float = 0.75,
) -> np.ndarray:
    """Anchored copy of center ``T`` for an oriented box ``(R, scale)``
    against observed instance ``points``.

    Args:
        T: [3] voted center (camera frame, camera at the origin).
        R: [3, 3] voted rotation, box axes in columns.
        scale: [3] absolute full extents along the box axes.
        points: [N, 3] observed instance surface points.
        span_frac: observed-span fraction of the predicted extent above
            which an axis counts as fully observed (midpoint anchor).
        clip: max correction per axis (meters) — a guard against bad
            instance masks; the measured vote bias is ≲0.04 m on
            tabletop scales, meter-scale drivers pass a larger value.
        q: quantile pair (q, 1-q) standing in for min/max — resists stray
            mask points.
        min_points: below this the mask is too thin to trust; T is
            returned unchanged.
        view_min: minimum |axis · view-ray| for the partial-span face
            anchor — below it the axis is a lateral one whose truncation
            may be external occlusion, and it is left unanchored.
        gate_frac: points farther than ``gate_frac · |scale|`` from ``T``
            are dropped before anchoring — instance masks bleed a few
            points onto neighbouring objects (the membership back-vote is
            pair-level), and a neighbour cluster inflates the observed
            extremes (measured: a two-can frame dragged the occluded
            can's midpoint 43 mm toward its neighbour).  The true surface
            lies within ``|scale|/2 + |T bias|``, safely inside the gate.

    Returns:
        [3] corrected center (a new array; ``T`` is not modified).
    """
    T = np.asarray(T, np.float64)
    points = np.asarray(points)
    if len(points) >= min_points:
        gate = gate_frac * float(np.linalg.norm(scale))
        points = points[np.linalg.norm(points - T, axis=-1) <= gate]
    if len(points) < min_points:
        return T.copy()
    view = T / max(float(np.linalg.norm(T)), 1e-9)
    out = T.copy()
    for i in range(3):
        a = np.asarray(R[:, i], np.float64)
        proj = points @ a
        lo = float(np.quantile(proj, q))
        hi = float(np.quantile(proj, 1.0 - q))
        s = float(scale[i])
        av = float(a @ view)
        if hi - lo >= span_frac * s:
            c = (lo + hi) / 2.0            # silhouette: both extremes real
        elif av < -view_min:
            c = hi - s / 2.0               # +a faces the camera: hi is real
        elif av > view_min:
            c = lo + s / 2.0               # -a faces the camera: lo is real
        else:
            continue                       # lateral truncation: don't trust it
        out += float(np.clip(c - T @ a, -clip, clip)) * a
    return out
