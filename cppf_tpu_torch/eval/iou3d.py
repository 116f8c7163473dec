"""Exact IoU between oriented 3D boxes via polygon clipping + convex hull; the
port's own copy of cppf_tpu/eval/iou3d.py.

Functional parity target: reference ``utils/iou.py`` (Sutherland–Hodgman
face clipping, robust variant from Ericson's *Real-Time Collision
Detection* p.370, plus ConvexHull volume).  The algorithm:

1. bring box A to its axis-aligned frame; clip every face polygon of B
   against A's six axis planes; collect surviving polygon vertices;
2. add B's keypoints that lie inside A;
3. repeat with roles swapped;
4. intersection volume = ConvexHull(points).volume; IoU = inter / union.
"""
from __future__ import annotations

import numpy as np
import scipy.spatial as sp

from cppf_tpu_torch.eval.box3d import FACES, NUM_KEYPOINTS, Box3D

_EPS = 1e-6
_FRONT, _ON, _BEHIND = 1, 0, -1


def _classify(point, plane_pt, normal_sign, axis):
    d = normal_sign * (point[axis] - plane_pt[axis])
    if d > _EPS:
        return _FRONT
    if d < -_EPS:
        return _BEHIND
    return _ON


def _plane_intersect(plane_pt, p_prev, p_cur, axis):
    alpha = (p_cur[axis] - plane_pt[axis]) / (p_cur[axis] - p_prev[axis])
    return alpha * p_prev + (1.0 - alpha) * p_cur


def _clip_polygon(poly, plane_pt, normal_sign, axis):
    """One Sutherland–Hodgman pass against an axis-aligned plane."""
    if len(poly) <= 1:
        return []
    out = []
    all_on_plane = True
    for i, cur in enumerate(poly):
        prev = poly[i - 1]
        d_prev = _classify(prev, plane_pt, normal_sign, axis)
        d_cur = _classify(cur, plane_pt, normal_sign, axis)
        if d_cur == _BEHIND:
            all_on_plane = False
            if d_prev == _FRONT:
                out.append(_plane_intersect(plane_pt, prev, cur, axis))
            elif d_prev == _ON:
                if not out or not np.array_equal(out[-1], prev):
                    out.append(prev)
        elif d_cur == _FRONT:
            all_on_plane = False
            if d_prev == _BEHIND:
                out.append(_plane_intersect(plane_pt, prev, cur, axis))
            elif d_prev == _ON:
                if not out or not np.array_equal(out[-1], prev):
                    out.append(prev)
            out.append(cur)
        else:
            if d_prev != _ON:
                out.append(cur)
    return list(poly) if all_on_plane else out


def _clip_against_box(aligned_box: Box3D, poly):
    """Clip a polygon against the 6 axis planes of an axis-aligned box."""
    for axis in range(3):
        poly = _clip_polygon(poly, aligned_box.vertices[1], 1.0, axis)
        poly = _clip_polygon(poly, aligned_box.vertices[8], -1.0, axis)
    return poly


def intersection_points(box_src: Box3D, box_template: Box3D):
    """Intersection point cloud contributed with box_src as the clip box."""
    inv = np.linalg.inv(box_src.transformation)
    src_aligned = box_src.apply_transformation(inv)
    templ_local = box_template.apply_transformation(inv)
    pts = []
    for face in FACES:
        poly = [templ_local.vertices[i] for i in face]
        for p in _clip_against_box(src_aligned, poly):
            pts.append(box_src.rotation @ p + box_src.translation)
    for i in range(NUM_KEYPOINTS):
        v = templ_local.vertices[i]
        if src_aligned.inside(v):
            pts.append(box_src.rotation @ v + box_src.translation)
    return pts


def iou_boxes(box1: Box3D, box2: Box3D) -> float:
    pts = intersection_points(box1, box2) + intersection_points(box2, box1)
    if not pts:
        return 0.0
    inter = sp.ConvexHull(pts).volume
    union = box1.volume + box2.volume - inter
    return float(inter / union)


def iou_sampling(box1: Box3D, box2: Box3D, num_samples: int = 10000, rng=None) -> float:
    """Monte-Carlo IoU estimate (reference utils/iou.py:38-69), volume-ratio
    corrected."""
    rng = rng or np.random.default_rng()
    in12 = sum(box2.inside(box1.sample(rng)) for _ in range(num_samples))
    in21 = sum(box1.inside(box2.sample(rng)) for _ in range(num_samples))
    v1, v2 = box1.volume, box2.volume
    inter = (v1 * in12 + v2 * in21) / 2.0
    union = (v1 + v2) * num_samples - inter
    return float(inter / union)
