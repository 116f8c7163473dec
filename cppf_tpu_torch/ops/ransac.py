"""Fixed-iteration vectorised RANSAC plane fit (counterpart of
cppf_tpu/ops/ransac.py): every candidate plane through three sampled points
is scored at once, the best one's inliers are refit by PCA."""
from __future__ import annotations

import torch

from cppf_tpu_torch.core.geometry import cross
from cppf_tpu_torch.ops.normals import _smallest_eigvec_3x3


def segment_plane(u: torch.Tensor, pc: torch.Tensor, distance_threshold: float,
                  valid_mask: torch.Tensor | None = None):
    """Best plane of ``u.shape[0]`` RANSAC iterations.

    ``u`` [num_iterations, 3] are the uniforms in [0, 1) that pick each
    iteration's three points from the valid prefix of ``pc`` [N, 3] (valid
    points compacted to the front).  They are injected so that a test can
    hand both packages the same draws.  Returns (plane [4]: unit normal and
    offset d with n·x + d = 0; inlier mask [N] bool of the refit plane).
    """
    n = pc.shape[0]
    if valid_mask is None:
        valid_mask = torch.ones(n, dtype=torch.bool, device=pc.device)
    n_valid = torch.clamp(valid_mask.sum(), min=1)
    idx = torch.minimum((u.to(pc.dtype) * n_valid).to(torch.int32), n_valid - 1).long()
    p0, p1, p2 = pc[idx[:, 0]], pc[idx[:, 1]], pc[idx[:, 2]]
    nrm = cross(p1 - p0, p2 - p0)
    nrm = nrm / (torch.linalg.norm(nrm, dim=-1, keepdim=True) + 1e-12)
    d = -torch.sum(nrm * p0, -1)

    dist = torch.abs(pc @ nrm.T + d[None, :])                  # [N, I]
    inlier = (dist < distance_threshold) & valid_mask[:, None]
    best = torch.argmax(inlier.sum(0))
    best_mask = inlier[:, best]

    # PCA refit on the winning inliers
    w = best_mask.to(pc.dtype)[:, None]
    cnt = torch.clamp(w.sum(), min=3.0)
    mean = torch.sum(pc * w, 0) / cnt
    centred = (pc - mean) * w
    normal = _smallest_eigvec_3x3(centred.T @ centred / cnt)
    # keep the orientation of the RANSAC winner
    normal = normal * torch.where(torch.dot(normal, nrm[best]) < 0, -1.0, 1.0)
    plane = torch.cat([normal, -torch.sum(normal * mean)[None]])
    refined = (torch.abs(pc @ normal + plane[3]) < distance_threshold) & valid_mask
    return plane, refined
