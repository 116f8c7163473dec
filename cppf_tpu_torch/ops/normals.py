"""KNN-PCA surface normals (counterpart of cppf_tpu/ops/normals.py).

The 3×3 symmetric eigenproblem is solved in closed form (trigonometric
eigenvalues, cross-product eigenvector), vectorised over all points.  Sign
rule: positive component sum, ties broken toward +z.
"""
from __future__ import annotations

import math

import torch

from cppf_tpu_torch.core.geometry import cross
from cppf_tpu_torch.ops.knn import knn_indices
from cppf_tpu_torch.utils import prof


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3], written out (cofactors of row 0)."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def _smallest_eigvec_3x3(C: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of symmetric C [..., 3, 3]."""
    eye = torch.eye(3, dtype=C.dtype, device=C.device)
    q = torch.diagonal(C, dim1=-2, dim2=-1).sum(-1) / 3.0
    B = C - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    r = torch.clamp(_det3(B) / (2.0 * p ** 3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    eig_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    A = C - eig_min[..., None, None] * eye
    r0, r1, r2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    cands = torch.stack([cross(r0, r1), cross(r1, r2), cross(r2, r0)], -2)
    best = torch.argmax(torch.sum(cands * cands, -1), -1)
    vec = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    norm = torch.linalg.norm(vec, dim=-1, keepdim=True)
    # degenerate neighbourhood (isotropic / planar-ambiguous): fall back to +z
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=C.dtype, device=C.device).expand_as(vec)
    prof.host_sync(C.device)
    return torch.where(norm > 1e-12, vec / (norm + 1e-30), fallback)


def estimate_normals(pc: torch.Tensor, knn: int = 60, valid_mask: torch.Tensor | None = None,
                     nbr_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Per-point unit normals [N, 3] from the k-NN covariance."""
    if nbr_idx is None:
        nbr_idx = knn_indices(pc, knn, valid_mask)
    nbrs = pc[nbr_idx.long()]                       # [N, k, 3]
    centred = nbrs - nbrs.mean(-2, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", centred, centred) / nbrs.shape[-2]
    n = _smallest_eigvec_3x3(cov)
    s = torch.sum(n, -1) + 1e-9 * n[..., 2]
    return n * torch.where(s < 0, -1.0, 1.0)[..., None]
