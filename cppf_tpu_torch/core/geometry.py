"""Geometry helpers (counterpart of cppf_tpu/core/geometry.py)."""
from __future__ import annotations

import math

import numpy as np
import torch


def rotx(a: float) -> np.ndarray:
    """4x4 rotation about +x."""
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def roty(a: float) -> np.ndarray:
    """4x4 rotation about +y (its sine terms as cppf_tpu/core/geometry.py
    places them)."""
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, -s, s, c
    return m


def fibonacci_sphere(samples: int) -> np.ndarray:
    """Near-uniform unit directions on S², float64 [samples, 3]: y runs from
    1 to -1 with golden-angle azimuth steps, the exact ordering of
    cppf_tpu/core/geometry.py:35-46, so sphere-bin indices are comparable."""
    i = np.arange(samples, dtype=np.float64)
    y = 1.0 - (i / (samples - 1)) * 2.0
    radius = np.sqrt(np.maximum(0.0, 1.0 - y * y))
    theta = math.pi * (3.0 - math.sqrt(5.0)) * i
    return np.stack([np.cos(theta) * radius, y, np.sin(theta) * radius], -1)


def backproject(depth: np.ndarray, intrinsics: np.ndarray, instance_mask: np.ndarray):
    """NOCS pinhole unprojection on the host, in float64 (cppf_tpu
    core/geometry.py:53-69): masked pixels with depth > 0 go through K⁻¹,
    then x and y are negated.  Returns (points [M, 3], (rows, cols))."""
    K_inv = np.linalg.inv(intrinsics)
    valid = np.logical_and(instance_mask, depth > 0)
    rows, cols = np.where(valid)
    uv1 = np.stack([cols, rows, np.ones_like(cols)], 0).astype(np.float64)
    rays = (K_inv @ uv1).T
    z = depth[rows, cols]
    pts = rays * (z[:, None] / rays[:, 2:3])
    pts[:, 0] = -pts[:, 0]
    pts[:, 1] = -pts[:, 1]
    return pts, (rows, cols)


def backproject_grid(depth: torch.Tensor, intrinsics: torch.Tensor, mask: torch.Tensor):
    """Every pixel through K⁻¹ at once: points [H·W, 3] (x and y negated,
    zero where invalid) and their validity [H·W] (mask and depth > 0)."""
    h, w = depth.shape
    K_inv = torch.linalg.inv(intrinsics.to(depth.dtype))
    vv, uu = torch.meshgrid(torch.arange(h, device=depth.device),
                            torch.arange(w, device=depth.device), indexing="ij")
    uv1 = torch.stack([uu.reshape(-1), vv.reshape(-1),
                       torch.ones(h * w, dtype=torch.int64, device=depth.device)], 0)
    rays = (K_inv @ uv1.to(depth.dtype)).T
    z = depth.reshape(-1)
    valid = mask.reshape(-1) & (z > 0)
    pts = rays * (z[:, None] / rays[:, 2:3])
    pts = pts * torch.tensor([-1.0, -1.0, 1.0], dtype=pts.dtype, device=pts.device)
    return torch.where(valid[:, None], pts, 0.0), valid


def backproject_sunrgbd(depth: np.ndarray, K: np.ndarray, Rtilt: np.ndarray, mask=None):
    """SUN RGB-D unprojection on the host (cppf_tpu core/geometry.py:91-103):
    the masked pixels' depth in mm lifted through ``K`` to (x, z, -y) in
    meters, tilt-corrected by ``Rtilt``, pixels of zero depth dropped, and
    the last two columns swapped.  Returns points [M, 3]."""
    if mask is None:
        mask = np.ones_like(depth, dtype=bool)
    rows, cols = np.where(mask)
    z = depth[mask] / 1000.0
    x = (cols - K[0, 2]) * z / K[0, 0]
    y = (rows - K[1, 2]) * z / K[1, 1]
    pts = np.stack([x, z, -y], -1)
    pts = (Rtilt @ pts.T).T
    pts = pts[z != 0]
    return pts[:, [0, 2, 1]]


def get_3d_bbox(scale, shift=0) -> np.ndarray:
    """The 8 corners [3, 8] of an axis-aligned box of extents ``scale`` (a
    scalar or 3) about ``shift``."""
    s = np.asarray(scale, dtype=np.float64)
    if s.ndim == 0:
        s = np.full(3, float(s))
    sx, sy, sz = s / 2.0
    corners = np.array([
        [+sx, +sy, +sz], [+sx, +sy, -sz], [-sx, +sy, +sz], [-sx, +sy, -sz],
        [+sx, -sy, +sz], [+sx, -sy, -sz], [-sx, -sy, +sz], [-sx, -sy, -sz],
    ]) + shift
    return corners.T


def transform_coordinates_3d(coords: np.ndarray, RT: np.ndarray) -> np.ndarray:
    """A homogeneous 4x4 applied to [3, N] coordinates."""
    if coords.shape[0] != 3:
        raise ValueError(f"coordinates must be [3, N], got {coords.shape}")
    hom = np.vstack([coords, np.ones((1, coords.shape[1]))])
    out = RT @ hom
    return out[:3] / out[3]


def calculate_2d_projections(coords3d: np.ndarray, intrinsics: np.ndarray) -> np.ndarray:
    """Integer pixels [N, 2] of [3, N] camera-frame points."""
    proj = intrinsics @ coords3d
    proj = (proj[:2] / proj[2]).T
    return proj.astype(np.int32)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.cross`` over the last axis, written out in its term order."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def orthonormal_right(up: torch.Tensor, right: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Project ``right`` onto the plane ⟂ ``up`` and renormalise."""
    right = right - torch.dot(up, right) * up
    return right / (torch.linalg.norm(right) + eps)


def assemble_rotation(up: torch.Tensor, right: torch.Tensor, z_right: bool) -> torch.Tensor:
    """Columns (up×right, up, right) when ``z_right``, else (right, up, right×up)."""
    if z_right:
        return torch.stack([cross(up, right), up, right], -1)
    return torch.stack([right, up, cross(right, up)], -1)
