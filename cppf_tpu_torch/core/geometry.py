"""Geometry helpers (counterpart of cppf_tpu/core/geometry.py)."""
from __future__ import annotations

import math

import numpy as np
import torch


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
