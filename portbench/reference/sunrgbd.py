"""The plain reference of a CPPF pose through the SUN RGB-D driver (You et
al., CVPR 2022; ``sunrgbd/inference.py``): :mod:`portbench.reference.pose`
and its pieces, imported, with three mechanisms more, each as the JAX
``vote_pose`` (``cppf_tpu/pipeline/pose.py``, ``_vote_pose_body``) states it:

- the coplanar center gate (``filter_coplanar``): a pair whose normals are
  parallel (|n₁·n₂| > 0.9) and both perpendicular to its axis (|âb·nᵢ| <
  0.1) casts no center vote, unless fewer than 5 % of the pairs would be
  kept, when every pair votes.  The gate thins the center votes only: the
  back-vote, the axis votes and the scale take every pair;
- the gravity prior on the up axis (``up_prior_deg`` > 0): only the sphere
  directions within ``up_prior_deg`` of ±``up_prior_dir`` (default +y) may
  win the up vote;
- ``geo_right_dir: direct``: the geometric right sign is taken against the
  protrusion direction itself, not against its cross product with up.

Where it departs from the JAX code:

- the gated grid is summed over the kept pairs alone (a dropped pair casts
  nothing, as the program's kernels skip a pair of weight 0), where JAX
  multiplies each vote's mass by the mask: the same grid, summed here in
  float64;
- the gate's three tests read the reference's own normals; a pair within
  rounding of a threshold may fall the other way in a sound program, and
  the judge does not follow it both ways: such a pair moves the grid by its
  own votes, a small share of a peak's mass;
- the prior's cosine is ``cos(deg2rad(up_prior_deg))`` in float32, as JAX
  computes it, and a direction's is |d·dir| summed plainly.

Near-tie decodes are followed as ``pose.py`` follows them: in the center
grid, only those of the pairs the gate keeps; in the back-vote's survivors,
all.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from portbench.reference import pose
from portbench.reference.pose import (Near, Prep, aux_losses, axis_counts, backvote, cross,
                                      logits, near_gap, orthonormal_right, peak, protrusion,
                                      scale_of, top_voxels, toggles, voxel_center, worlds)

# the mechanisms this reference follows beyond ``pose.FOLLOWS``, each with a
# test of the values it implements
OWN = {"filter_coplanar": lambda v: v in (True, False),
       "up_prior_deg": lambda v: isinstance(v, (int, float)) and not isinstance(v, bool)
       and v >= 0,
       "geo_right_dir": lambda v: v in ("cross", "direct")}
# a share of the pairs under which the gate lets every pair vote
GATE_FLOOR = 0.05


def follows(cfg: dict) -> None:
    """Raise ``ValueError`` naming each key of ``pose.FOLLOWS`` that ``cfg``
    leaves out or states at another value than ``pose.py`` implements, but
    ``filter_coplanar`` (true or false), ``up_prior_deg`` (≥ 0) and
    ``geo_right_dir`` (``cross`` or ``direct``), which this one follows."""
    wrong = [f"{k}: stated {cfg[k]!r}, followed {v!r}" if k in cfg
             else f"{k}: not stated, followed {v!r}"
             for k, v in pose.FOLLOWS.items() if k not in OWN and (k not in cfg or cfg[k] != v)]
    wrong += [f"{k}: stated {cfg[k]!r}, not followed" if k in cfg else f"{k}: not stated"
              for k, ok in OWN.items() if k not in cfg or not ok(cfg[k])]
    if wrong:
        raise ValueError(f"reference/sunrgbd.py does not follow configuration "
                         f"{cfg.get('name')!r}: " + "; ".join(wrong))


@dataclass
class ScanPrep(Prep):
    """``pose.Prep`` of every pair, whose ``grid1`` is the gated grid, with
    ``center``: the ``Prep`` of the pairs the gate keeps (the same cloud),
    on which the center grid, its peak and its near ties are read."""
    center: Optional[Prep] = None


def coplanar(p: Prep) -> torch.Tensor:
    """[P] bool: the pairs whose normals are parallel and both perpendicular
    to their axis."""
    a, b = p.idx[:, 0], p.idx[:, 1]
    n1, n2 = p.normals[a], p.normals[b]
    ab = p.pc[a] - p.pc[b]
    abu = ab / (torch.linalg.norm(ab, dim=-1, keepdim=True) + 1e-7)
    return ((torch.abs(torch.sum(n1 * n2, -1)) > 0.9)
            & (torch.abs(torch.sum(abu * n1, -1)) < 0.1)
            & (torch.abs(torch.sum(abu * n2, -1)) < 0.1))


def center_gate(p: Prep) -> torch.Tensor:
    """[P] bool: the pairs that cast center votes."""
    if not p.cfg["filter_coplanar"]:
        return torch.ones(p.idx.shape[0], dtype=torch.bool, device=p.pc.device)
    keep = ~coplanar(p)
    return keep | (keep.float().mean() < GATE_FLOOR)


def prior_gate(p: Prep) -> Optional[torch.Tensor]:
    """[n_sphere] bool: the directions that may win the up vote; None with
    the prior off."""
    deg = p.cfg["up_prior_deg"]
    if deg <= 0:
        return None
    d = torch.tensor(p.cfg.get("up_prior_dir", (0.0, 1.0, 0.0)), dtype=torch.float32,
                     device=p.pc.device)
    cos_max = torch.cos(torch.deg2rad(torch.tensor(float(deg), dtype=torch.float32)))
    return torch.abs(torch.sum(p.sphere * d, -1)) >= cos_max.to(p.pc.device)


def _kept(p: Prep, keep: torch.Tensor) -> Prep:
    """``p`` over the pairs ``keep`` holds, with their near-tie decodes."""
    rows = torch.nonzero(keep).reshape(-1)
    at = torch.cumsum(keep.long(), 0) - 1
    nr = p.near
    sel = keep[nr.rows]
    near = Near(at[nr.rows[sel]], nr.tr[sel], nr.margin[sel])
    return dataclasses.replace(p, idx=p.idx[rows], preds=p.preds[rows], tr=p.tr[rows],
                               near=near)


def prepare(cfg: dict, weights: Dict[str, torch.Tensor], crop, draws) -> ScanPrep:
    p = pose.prepare(cfg, weights, crop, draws)
    keep = center_gate(p)
    c = p
    if not bool(keep.all()):
        c = _kept(p, keep)
        c.grid1 = pose.center_grid(c, torch.ones(p.pc.shape[0], device=p.pc.device))
    fields = {f.name: getattr(p, f.name) for f in dataclasses.fields(Prep)}
    return ScanPrep(**{**fields, "grid1": c.grid1}, center=c)


def _up(p: Prep, mask, counts):
    """The signed up axis from its sphere ``counts``, the argmax over the
    directions the prior allows."""
    allowed = prior_gate(p)
    i = int(torch.argmax(counts if allowed is None else torch.where(allowed, counts, -1.0)))
    _, aux = logits(p, "up")
    l_up, l_down = aux_losses(p, p.sphere[i], aux, mask.float())
    return -p.sphere[i] if l_down < l_up else p.sphere[i]


def _right_dir(p: Prep, h_dir, up):
    """The direction the geometric right sign is taken against."""
    return h_dir if p.cfg["geo_right_dir"] == "direct" else cross(h_dir, up)


def estimate(p: ScanPrep, draws) -> dict:
    """The reference's own pose: T, R, scale, up, right, n_filtered,
    grid_max."""
    cfg, c = p.cfg, p.center
    flat, _ = peak(p.grid1, cfg["peak_rounds"])
    T = voxel_center(p, flat)
    grid_max = float(p.grid1.reshape(-1)[flat])
    mask = backvote(p, T)
    lg, _ = logits(p, "up")
    up = _up(p, mask, axis_counts(p, mask, lg, draws["up_sub"], draws["up_gumbel"]))
    if cfg["asym_center_refine"]:
        grid2, u_h, gate, _ = pose._second_pass(c, T, up)
        if gate:
            T2 = voxel_center(p, peak(grid2, cfg["peak_rounds"])[0])
            T = T + torch.dot(T2 - T, u_h) * u_h
        mask = backvote(p, T)
    if cfg["regress_right"]:
        asym, w = pose._right_weights(p, T, up)
        right, _, _ = pose._vote_axis(p, mask, "right", draws, w)
        if cfg["geo_right_sign"]:
            h_dir, gate = protrusion(p, T, up, asym)
            if gate and float(torch.dot(right, _right_dir(p, h_dir, up))) < 0:
                right = -right
        right = orthonormal_right(up, right)
    else:
        right = torch.stack([torch.zeros_like(up[0]), -up[2], up[1]])
        right = right / (torch.linalg.norm(right) + 1e-9)
    if float(torch.linalg.norm(right)) < 1e-7:
        right = orthonormal_right(up, draws["fallback"])
    scale = scale_of(p, mask)
    return {"T": T, "R": pose._assemble(up, right), "scale": scale, "up": up, "right": right,
            "n_filtered": float(mask.sum()), "grid_max": grid_max}


def judge(p: ScanPrep, draws, out: dict) -> Dict[str, float]:
    """``pose.judge``'s numbers, read on this reference's mechanisms:
    ``t_vox``, ``center_gap``, ``center2_gap`` and ``peak_rel`` on the gated
    grid (its near ties those of the kept pairs); ``survivors_rel`` and
    ``scale_rel`` on the back-vote of every pair; ``up_gap`` the program's
    up bin's count gap to the best bin the prior allows (a bin it does not
    allow reads its whole gap), ``up_sign`` as there; ``right_gap`` as there,
    and ``right_sign`` the margin of the geometric sign taken against the
    protrusion direction itself under ``geo_right_dir: direct``; and
    ``axis_dev``."""
    cfg, c = p.cfg, p.center
    dev = p.pc.device
    f = {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in out.items()}
    T, up_p, right_p = f["T"].reshape(3), f["up"].reshape(3), f["right"].reshape(3)
    res = cfg["res"]
    nums: Dict[str, float] = {}

    cos_up = torch.abs(p.sphere @ up_p)
    axis_dev = 1.0 - float(cos_up.max())
    up_from = cos_up >= cos_up.max() - 1e-6

    # the center, on the gated grid
    g = p.edge
    rounds = cfg["peak_rounds"]
    peak1, searched1 = peak(p.grid1, rounds)
    ones = torch.ones(p.pc.shape[0], device=dev)
    if cfg["asym_center_refine"]:
        best = None
        for v in top_voxels(p.grid1, peak1, searched1):
            T1 = voxel_center(p, v)
            grid2, u_h, gate, w2 = pose._second_pass(c, T1, up_p)
            paths = [(None, None, T1)]
            if gate:
                peak2, searched2 = peak(grid2, rounds)
                paths = [(w, peak2, T1 + torch.dot(voxel_center(p, w) - T1, u_h) * u_h)
                         for w in top_voxels(grid2, peak2, searched2)]
            for w, peak2, T_fin in paths:
                d = float(torch.linalg.norm(T_fin - T)) / res
                if best is None or d < best[0]:
                    best = (d, v, T1, w, peak2, grid2, w2)
        d, v1, T1, v2, peak2, grid2, w2 = best
        nums["center2_gap"] = 0.0 if v2 is None else pose._gap(c, grid2, w2, peak2, v2)
    else:
        ijk_f = (T - p.corner) / res
        ijk = torch.round(ijk_f)
        d = float(torch.linalg.norm(ijk_f - ijk))
        inside = bool(((ijk >= 0) & (ijk < g)).all())
        v1 = int((ijk[0] * g + ijk[1]) * g + ijk[2]) if inside else None
        T1 = T
    nums["t_vox"] = d
    nums["center_gap"] = 1.0 if v1 is None else pose._gap(c, p.grid1, ones, peak1, v1)
    if "grid_max" in out and v1 is not None:
        ref = float(p.grid1.reshape(-1)[v1])
        gain, loss = pose.near_shift(c, ones, v1)
        got = float(f["grid_max"])
        nums["peak_rel"] = max(0.0, ref + loss - got, got - ref - gain) / max(ref, 1e-30)

    # the survivors, of every pair
    n_prog = float(f["n_filtered"]) if "n_filtered" in out else None
    mask1 = backvote(p, T1)
    add1, rem1 = toggles(p, T1, mask1)
    if cfg["asym_center_refine"]:
        mask = backvote(p, T)
        add, rem = toggles(p, T, mask)
        worlds1 = list(worlds(mask1, add1, rem1))
    else:
        mask, add, rem = mask1, add1, rem1
    finals = list(worlds(mask, add, rem, n_prog))
    if not cfg["asym_center_refine"]:
        worlds1 = finals

    # up, on the first pass's survivors, among the directions the prior allows
    allowed = prior_gate(p)
    lg, aux = logits(p, "up")
    i_up, up_gap = None, None
    for m in worlds1:
        counts, slack = axis_counts(p, m, lg, draws["up_sub"], draws["up_gumbel"], slack=True)
        if allowed is not None:
            counts = torch.where(allowed, counts, 0.0)
            slack = torch.where(allowed, slack, 0.0)
        i = int(torch.argmax(torch.where(up_from, counts + slack, -1.0)))
        i_up = i if i_up is None else i_up
        gap = near_gap(counts, slack, i)
        up_gap = gap if up_gap is None else min(up_gap, gap)
        if up_gap == 0.0:
            break
    nums["up_gap"] = up_gap
    l_up, l_down = aux_losses(p, p.sphere[i_up], aux, mask1.float())
    ref_up = -p.sphere[i_up] if l_down < l_up else p.sphere[i_up]
    nums["up_sign"] = (0.0 if float(torch.dot(ref_up, up_p)) > 0
                       else pose._sign_margin(l_up, l_down))

    n_ref = float(mask.sum())
    if n_prog is not None:
        nums["survivors_rel"] = max(0.0, n_ref - len(rem) - n_prog,
                                    n_prog - n_ref - len(add)) / max(n_ref, 1.0)
    scale_p = f["scale"].reshape(3)
    nums["scale_rel"] = min(float(torch.max(torch.abs(scale_p - s) / s))
                            for s in (scale_of(p, m) for m in finals))

    # right
    if cfg["regress_right"]:
        asym, w = pose._right_weights(p, T, up_p)
        lg, aux = logits(p, "right")
        proj = p.sphere - (p.sphere @ up_p)[:, None] * up_p[None, :]
        proj = proj / (torch.linalg.norm(proj, dim=-1, keepdim=True) + 1e-9)
        cos_r = torch.abs(proj @ right_p)
        line = torch.abs(p.sphere @ up_p) >= 1.0 - 1e-6
        consistent = (cos_r >= 1.0 - 1e-5) | line
        j_ref, right_gap = None, None
        for m in finals:
            counts, slack = axis_counts(p, m, lg, draws["right_sub"], draws["right_gumbel"], w,
                                        slack=True)
            pick = torch.where(consistent, counts + slack, -1.0)
            j = int(torch.argmax(pick if bool(consistent.any()) else cos_r))
            j_ref = j if j_ref is None else j_ref
            gap = near_gap(counts, slack, j)
            right_gap = gap if right_gap is None else min(right_gap, gap)
            if right_gap == 0.0:
                break
        nums["right_gap"] = right_gap
        on_line = bool(line[j_ref])
        if not on_line:
            axis_dev = max(axis_dev, 1.0 - float(cos_r.max()))
        aux_mask = mask.float() if w is None else mask.float() * w
        l_a, l_b = aux_losses(p, p.sphere[j_ref], aux, aux_mask)
        r = -p.sphere[j_ref] if l_b < l_a else p.sphere[j_ref]
        margin = pose._sign_margin(l_a, l_b)
        if cfg["geo_right_sign"]:
            h_dir, gate = protrusion(p, T, up_p, asym)
            if gate:
                dot = float(torch.dot(r, _right_dir(p, h_dir, up_p)))
                margin = abs(dot)
                if dot < 0:
                    r = -r
        r = orthonormal_right(up_p, r)
        nums["right_sign"] = 0.0 if on_line or float(torch.dot(r, right_p)) > 0 else margin
        R_ref = pose._assemble(up_p, right_p)
    else:
        r = torch.stack([torch.zeros_like(up_p[0]), -up_p[2], up_p[1]])
        r = r / (torch.linalg.norm(r) + 1e-9)
        R_ref = pose._assemble(up_p, r)
    nums["axis_dev"] = max(axis_dev, float(torch.max(torch.abs(f["R"].reshape(3, 3) - R_ref))))
    return nums
