"""Voting targets of a canonical-frame cloud and radial asymmetry
(counterpart of cppf_tpu/core/targets.py).

For each sampled point pair (a, b) of an origin-centred canonical cloud
the labels are the projection of a on the pair axis, the distance of the
origin from that axis, the angles of the axis to up and right (folded by
the symmetry flags), and the aux bits: the sign of the pair-canonicalised
normal against up and right, with |n·axis| as their weights.  The radial
asymmetry scores each point by how far it protrudes beyond the revolution
radius of its height slab (about y in the canonical frame, about an
estimated (center, axis) line at inference): a mug's handle, a camera's
lens, a desk's pedestal.  Same operation order as the JAX functions,
float32 throughout.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from cppf_tpu_torch.core.binning import real2prob


class VotingTargets(NamedTuple):
    tr: torch.Tensor          # [P, 2] (proj_len, dist2o)
    rot: torch.Tensor         # [P, 2] (up angle, right angle)
    rot_aux: torch.Tensor     # [P, 2] aux bits
    point_idxs: torch.Tensor  # [P, 2] int32
    aux_weight: torch.Tensor  # [P, 2] |n_canon·axis|, scaled by asymmetry for right
    up_rot_weight: Optional[torch.Tensor] = None  # [P] up-angle KL weight


def sample_pair_idxs(pair_u: torch.Tensor, n_points) -> torch.Tensor:
    """Pair indices [P, 2] in [0, n_points) from uniforms ``pair_u`` [P, 2]:
    min(floor(u·n), n − 1)."""
    return torch.minimum((pair_u * n_points).to(torch.int32),
                         torch.as_tensor(n_points, device=pair_u.device) - 1)


def radial_asymmetry(pc: torch.Tensor, n_valid, n_bins: int = 12) -> torch.Tensor:
    """Per-point protrusion score [N] in [0, 1] of a canonical cloud about
    its y axis; 0 past ``n_valid``."""
    mask = torch.arange(pc.shape[0], device=pc.device) < n_valid
    r = torch.sqrt(pc[:, 0] ** 2 + pc[:, 2] ** 2)
    return _profile_excess(pc[:, 1], r, mask, n_bins, pc.dtype)


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


def base_membership(pc: torch.Tensor, n_valid, frac: float = 0.15) -> torch.Tensor:
    """1 for a valid point in the bottom ``frac`` of the cloud's height, else
    0, [N] (an articulated body's base, whose pairs carry its up axis)."""
    mask = torch.arange(pc.shape[0], device=pc.device) < n_valid
    y = pc[:, 1]
    y_lo = torch.where(mask, y, 1e9).min()
    y_hi = torch.where(mask, y, -1e9).max()
    return ((y < y_lo + frac * torch.clamp(y_hi - y_lo, min=1e-6)) & mask).to(pc.dtype)


def generate_targets(pc: torch.Tensor, pc_normal: torch.Tensor, point_idxs: torch.Tensor,
                     up_sym: bool = False, right_sym: bool = False, z_right: bool = False,
                     asym: Optional[torch.Tensor] = None,
                     base: Optional[torch.Tensor] = None) -> VotingTargets:
    """Pair labels of a canonical cloud pc/pc_normal [N, 3] for
    ``point_idxs`` [P, 2].  ``asym`` [N] (:func:`radial_asymmetry`) scales
    the right bit's weight by the pair's larger score (floor 0.05);
    ``base`` [N] (:func:`base_membership`) adds an up-angle weight
    0.1 + 0.9·max(base_a, base_b)."""
    idx = point_idxs.long()
    a = pc[idx[:, 0]]
    b = pc[idx[:, 1]]
    d = a - b
    d_unit = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-7)
    proj_len = torch.sum(a * d_unit, -1)
    oc = a - proj_len[..., None] * d_unit
    dist2o = torch.linalg.norm(oc, dim=-1)
    target_tr = torch.stack([proj_len, dist2o], -1)

    up = torch.tensor([0.0, 1.0, 0.0], dtype=pc.dtype, device=pc.device)
    right = torch.tensor([0.0, 0.0, 1.0] if z_right else [1.0, 0.0, 0.0], dtype=pc.dtype,
                         device=pc.device)
    up_dot = torch.clamp(torch.sum(d_unit * up, -1), -1.0, 1.0)
    up_ang = torch.arccos(up_dot)
    if up_sym:
        up_ang = torch.minimum(up_ang, torch.arccos(-up_dot))
    right_dot = torch.clamp(torch.sum(d_unit * right, -1), -1.0, 1.0)
    right_ang = torch.arccos(right_dot)
    if right_sym:
        right_ang = torch.minimum(right_ang, torch.arccos(-right_dot))
    target_rot = torch.stack([up_ang, right_ang], -1)

    n_a = pc_normal[idx[:, 0]]
    flip = torch.where(torch.sum(n_a * d_unit, -1, keepdim=True) < 0, -1.0, 1.0)
    n_canon = n_a * flip
    up_dot_n = torch.sum(n_canon * up, -1)
    right_dot_n = torch.sum(n_canon * right, -1)
    target_aux = torch.stack([(up_dot_n > 0).to(pc.dtype), (right_dot_n > 0).to(pc.dtype)], -1)
    w_up = torch.abs(up_dot_n)
    w_right = torch.abs(right_dot_n)
    if asym is not None:
        pair_asym = torch.maximum(asym[idx[:, 0]], asym[idx[:, 1]])
        w_right = w_right * (0.05 + 0.95 * pair_asym)
    up_rot_w = None
    if base is not None:
        up_rot_w = 0.1 + 0.9 * torch.maximum(base[idx[:, 0]], base[idx[:, 1]])
    return VotingTargets(target_tr, target_rot, target_aux, point_idxs.to(torch.int32),
                         torch.stack([w_up, w_right], -1), up_rot_w)


def soft_bin_targets(targets: VotingTargets, vote_range, tr_num_bins: int, rot_num_bins: int):
    """(tr_prob [P, 2, tr_num_bins], rot_prob [P, 2, rot_num_bins]): proj_len
    shifted by vote_range[0] and clipped to [0, 2·vote_range[0]], dist2o
    clipped to [0, vote_range[1]], the angles over [0, π]."""
    v0, v1 = float(vote_range[0]), float(vote_range[1])
    tr_prob = torch.stack([
        real2prob(torch.clamp(targets.tr[:, 0] + v0, 0.0, 2 * v0), 2 * v0, tr_num_bins),
        real2prob(torch.clamp(targets.tr[:, 1], 0.0, v1), v1, tr_num_bins),
    ], 1)
    rot_prob = torch.stack([
        real2prob(targets.rot[:, 0], math.pi, rot_num_bins),
        real2prob(targets.rot[:, 1], math.pi, rot_num_bins),
    ], 1)
    return tr_prob, rot_prob


def scale_target(bound_nocs: torch.Tensor, scale, scale_mean) -> torch.Tensor:
    """Log-scale residual label [3]: log(bound/2 · scale) − log(scale_mean)."""
    mean = torch.as_tensor(scale_mean, dtype=bound_nocs.dtype, device=bound_nocs.device)
    return torch.log(bound_nocs / 2 * scale) - torch.log(mean)
