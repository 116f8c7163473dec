"""Radial asymmetry about an estimated axis (counterpart of the inference-side
part of cppf_tpu/core/targets.py:64-105).

Scores each observed point by how far it protrudes beyond the revolution
radius of its height slab about a (center, axis) line: the handle of a mug,
the lens of a camera, the pedestal of a desk.  Same operation order as the
JAX functions, float32 throughout.
"""
from __future__ import annotations

import torch


def radial_asymmetry_about(pc: torch.Tensor, center: torch.Tensor, axis: torch.Tensor, n_valid,
                           n_bins: int = 12) -> torch.Tensor:
    """Per-point protrusion score [N] in [0, 1] about the line through
    ``center`` along ``axis`` (its sign is irrelevant); 0 past ``n_valid``."""
    mask = torch.arange(pc.shape[0], device=pc.device) < n_valid
    d = pc - center[None, :]
    h = torch.sum(d * axis[None, :], -1)
    radial = d - h[:, None] * axis[None, :]
    r = torch.linalg.norm(radial, dim=-1)
    return _profile_excess(h, r, mask, n_bins, pc.dtype)


def _profile_excess(height, r, mask, n_bins: int, dtype) -> torch.Tensor:
    """Per-height-slab (mean, σ) of the axial radius; score
    clip(((r − mean)/σ − 1)/2, 0, 1), masked."""
    mf = mask.to(dtype)
    y_lo = torch.where(mask, height, 1e9).min()
    y_hi = torch.where(mask, height, -1e9).max()
    t = (height - y_lo) / torch.clamp(y_hi - y_lo, min=1e-6)
    b = torch.clamp((t * n_bins).to(torch.int32), 0, n_bins - 1)
    bins = torch.arange(n_bins, dtype=torch.int32, device=height.device)
    onehot = (b[:, None] == bins[None, :]).to(dtype) * mf[:, None]
    cnt = torch.sum(onehot, 0)
    mean = torch.sum(onehot * r[:, None], 0) / torch.clamp(cnt, min=1.0)
    var = torch.sum(onehot * (r[:, None] - mean[None, :]) ** 2, 0) / torch.clamp(cnt, min=1.0)
    # a floor on the deviation scale, so that voxel-level jitter in a clean
    # slab does not read as asymmetry
    r_mean = torch.sum(mf * r) / torch.clamp(torch.sum(mf), min=1.0)
    sigma = torch.sqrt(var) + 0.03 * torch.clamp(r_mean, min=1e-6)
    bl = b.long()
    excess = (r - mean[bl]) / sigma[bl]
    return torch.clamp((excess - 1.0) * 0.5, 0.0, 1.0) * mf
