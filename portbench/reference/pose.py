"""The plain reference of a CPPF pose (You et al., CVPR 2022), as the
benchmark's configurations state it: one crop and its random draws in,
the 9D pose out, in float32 with TF32 off, histograms summed in float64.

    jitter → first-point voxel downsample → KNN (k smallest, ties to the
    lower index) → PCA normals → SPRIN + pair head → pair sample → Gumbel
    decode of the translation bins → dense center-vote grid (trilinear) →
    back-vote → cone votes on the sphere → aux-bit sign → scale

with the category branches a configuration turns on: a second center pass
on the protruding points (``asym_center_refine``), the right axis
(``regress_right``) weighted by the protrusion (``asym_right_votes``) and
signed by it (``geo_right_sign``).  It imports nothing of the program and
takes nothing the program made: weights from ``portbench/weights/``, the
crop and the draws from the benchmark.

Where the program's order of float operations decides a discrete choice
(the KNN's squared norms, the neighbourhood mean, the CDF of a weighted
subsample), the reference sums in that order too, so that two correct
programs meet the same choices; everything else is written plainly.  The
center peak is found on the dense grid by the branch-and-bound the
configuration states (``peak_rounds`` windows at most), as the program's
peak kernels find it without the grid.

:func:`follows` refuses a configuration that turns on a mechanism written
nowhere here (:data:`FOLLOWS`); :func:`prepare` does what every use needs
(preprocess, network, decode, first grid); :func:`estimate` is the
reference's own pose; :func:`judge` reads the program's pose against the
reference: each discrete choice the program made (the peak voxel, the axis
bin, a sign) is followed, and scored by how far the reference's own scores
put it below their best, as a served token is scored by its logit's gap to
the best.

A sound program whose float32 sums run in another order (a fused or
reordered network) gives logits a few 1e-5 away, and then the Gumbel
decodes whose two best scores lie closer than ``DECODE_TIE`` may go the
other way.  The judge does not count that against it: each such decode's
other choice is followed as well (:class:`Near`), in the grid's mass at a
voxel, in the back-vote's survivors (the masks that toggling them gives,
:func:`worlds`, each re-drawing the axis votes' subsample) and in the axis
votes' counts; every number is the program's most favourable reading over
them.  TF32 moves the logits by ~1e-2, far past the tie, and is still
read.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference import model

TWO_PI = 6.283185307179586
SCAN_BLOCK = 16
# how far below its maximum a grid voxel may lie and still be a candidate
# for a peak the program does not report (mug's first and second pass)
CANDIDATE_SHARE = 0.05
MAX_CANDIDATES = 8
# a Gumbel decode whose best two scores lie closer than this may go either
# way in a sound float32 program (see the module's docstring)
DECODE_TIE = 5e-4
# the most survivor masks (the reference's and its toggles) an axis vote is
# read on
MAX_WORLDS = 256


def cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    y = 1.0 - (i / (n - 1)) * 2.0
    radius = np.sqrt(np.maximum(0.0, 1.0 - y * y))
    theta = math.pi * (3.0 - math.sqrt(5.0)) * i
    return np.stack([np.cos(theta) * radius, y, np.sin(theta) * radius], -1)


def orthonormal_right(up, right):
    right = right - torch.dot(up, right) * up
    return right / (torch.linalg.norm(right) + 1e-9)


def grid_edge(cfg: dict) -> int:
    edge = int(cfg["scale_range"][1] / cfg["res"]) + 4
    return (edge + 7) // 8 * 8


# ---- preprocess --------------------------------------------------------------

def sq_norm(pc):
    """|p|² as fma(z, z, fma(y, y, x·x)) in float32."""
    p = pc.double()
    acc = (p[:, 0] * p[:, 0]).float()
    for k in (1, 2):
        acc = (p[:, k] * p[:, k] + acc.double()).float()
    return acc


def knn(pc, k: int, valid, chunk: int = 1024):
    """[N, k] indices of the k nearest rows, nearest first, ties to the
    lower index (a stable sort of |p|² − 2p·q + |q|²)."""
    penalty = torch.where(valid, 0.0, float("inf")).to(pc.dtype)
    sq = sq_norm(pc)
    out = []
    for s in range(0, pc.shape[0], chunk):
        block = pc[s:s + chunk]
        d2 = sq[None, :] - 2.0 * (block @ pc.T) + sq_norm(block)[:, None]
        d2 = d2 + penalty[None, :]
        out.append(torch.sort(d2, dim=-1, stable=True).indices[:, :k])
    return torch.cat(out)


def det3(m):
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def smallest_eigvec(C):
    """Eigenvector of the smallest eigenvalue of symmetric [..., 3, 3], in
    closed form (trigonometric eigenvalue, cross product of two rows)."""
    eye = torch.eye(3, dtype=C.dtype, device=C.device)
    q = torch.diagonal(C, dim1=-2, dim2=-1).sum(-1) / 3.0
    B = C - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    r = torch.clamp(det3(B) / (2.0 * p ** 3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    A = C - lam[..., None, None] * eye
    r0, r1, r2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    cands = torch.stack([cross(r0, r1), cross(r1, r2), cross(r2, r0)], -2)
    best = torch.argmax(torch.sum(cands * cands, -1), -1)
    vec = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    norm = torch.linalg.norm(vec, dim=-1, keepdim=True)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=C.dtype, device=C.device).expand_as(vec)
    return torch.where(norm > 1e-12, vec / (norm + 1e-30), up)


def normals(pc, nbr_idx):
    nbrs = pc[nbr_idx]
    centred = nbrs - nbrs.mean(-2, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", centred, centred) / nbrs.shape[-2]
    n = smallest_eigvec(cov)
    s = torch.sum(n, -1) + 1e-9 * n[..., 2]
    return n * torch.where(s < 0, -1.0, 1.0)[..., None]


def preprocess(cfg: dict, crop: np.ndarray, jitter: torch.Tensor):
    """(pc [npoint_pad, 3], normals, n_valid, valid [npoint_pad], nbr_idx):
    the crop padded (stride-subsampled past ``npoint_max``), jittered by
    clip(res/4 · jitter, ±res/2), the first point of each occupied voxel
    kept in index order, the first ``npoint_pad`` of them."""
    dev = jitter.device
    n_max, n_pad, res = cfg["npoint_max"], cfg["npoint_pad"], cfg["res"]
    pad = np.zeros((n_max, 3), np.float32)
    n_raw = min(len(crop), n_max)
    if len(crop) > n_max:
        pad[:] = crop[np.linspace(0, len(crop) - 1, n_max).astype(int)]
    else:
        pad[:n_raw] = crop[:n_raw]
    raw = torch.from_numpy(pad).to(dev)
    raw = raw + torch.clamp(res / 4 * jitter, -res / 2, res / 2)
    rows = raw[:n_raw]
    v = torch.floor(rows / torch.tensor(res, dtype=torch.float32, device=dev)).long()
    c = v - v.amin(0)
    span = c.amax(0) + 1
    key = (c[:, 0] * span[1] + c[:, 1]) * span[2] + c[:, 2]
    order = torch.argsort(key, stable=True)
    ks = key[order]
    first = torch.ones_like(ks, dtype=torch.bool)
    first[1:] = ks[1:] != ks[:-1]
    keep = torch.sort(order[first]).values[:n_pad]
    n_valid = int(keep.shape[0])
    pc = torch.zeros((n_pad, 3), dtype=torch.float32, device=dev)
    pc[:n_valid] = rows[keep]
    valid = torch.arange(n_pad, device=dev) < n_valid
    nbr = knn(pc, cfg["knn"], valid)
    nrm = torch.where(valid[:, None], normals(pc, nbr), 0.0)
    return pc, nrm, n_valid, valid, nbr


# ---- the pose's pieces -------------------------------------------------------

@dataclass
class Prep:
    """What every use of one crop needs: the cloud, the pairs, their
    logits and decoded translations, the grid's frame and first grid."""
    cfg: dict
    pc: torch.Tensor
    normals: torch.Tensor
    n_valid: int
    valid: torch.Tensor
    idx: torch.Tensor       # [P, 2] int64
    preds: torch.Tensor     # [P, out_dim]
    tr: torch.Tensor        # [P, 2] (proj_len, odist)
    corner: torch.Tensor
    dims: torch.Tensor      # int32 [3], capped at the grid
    sphere: torch.Tensor    # [n_sphere, 3] float32
    grid1: torch.Tensor     # float64 [g, g, g], every pair weighing 1
    near: Optional["Near"] = None

    @property
    def res(self) -> torch.Tensor:
        return torch.tensor(self.cfg["res"], dtype=torch.float32, device=self.pc.device)

    @property
    def edge(self) -> int:
        return self.grid1.shape[0]


@dataclass
class Near:
    """The translation decodes within ``DECODE_TIE`` of going the other
    way: for each, its pair's row, the pair's (proj_len, odist) with that
    decode's other choice, and the decode's margin."""
    rows: torch.Tensor
    tr: torch.Tensor
    margin: torch.Tensor


def second_choice(scores: torch.Tensor, best: torch.Tensor):
    """(margin of the chosen ``best`` over the runner-up, the runner-up's
    index) of each row of ``scores``."""
    top = torch.topk(scores, 2, -1)
    other = torch.where(top.indices[:, 0] == best, top.indices[:, 1], top.indices[:, 0])
    chosen = torch.gather(scores, -1, best[:, None])[:, 0]
    return chosen - torch.gather(scores, -1, other[:, None])[:, 0], other


def pair_frames(pc, idx):
    a = pc[idx[:, 0]]
    ab = a - pc[idx[:, 1]]
    ab_len = torch.linalg.norm(ab, dim=-1)
    degenerate = ab_len < 1e-7
    ab_unit = ab / (ab_len + 1e-7)[:, None]
    zero = torch.zeros_like(ab_unit[:, 0])
    co = torch.stack([zero, -ab_unit[:, 2], ab_unit[:, 1]], -1)
    co_alt = torch.stack([-ab_unit[:, 1], ab_unit[:, 0], zero], -1)
    co = torch.where((torch.linalg.norm(co, dim=-1) < 1e-7)[:, None], co_alt, co)
    co_unit = co / (torch.linalg.norm(co, dim=-1) + 1e-7)[:, None]
    return a, ab_unit, degenerate, co_unit


def circle(m, n_rots: int, like):
    i = torch.arange(n_rots, dtype=like.dtype, device=like.device)
    step = torch.tensor(TWO_PI, dtype=like.dtype, device=like.device) / torch.clamp(m, min=1).to(
        like.dtype)
    angle = i[None, :] * step[:, None]
    return torch.cos(angle), torch.sin(angle), i[None, :] < m[:, None]


def _pair_votes(p: Prep, idx, tr, point_w):
    """Every pair's ``num_rots`` votes ``c + cos·x + sin·y`` on its circle:
    (the flat index of each vote's lowest trilinear corner [n, R], its
    three fractions, its weight: the larger of the pair's points'
    ``point_w``, 0 outside the grid)."""
    cfg, g = p.cfg, p.edge
    n_rots = cfg["num_rots"]
    dims_f = p.dims.float()
    a, ab_unit, degenerate, co_unit = pair_frames(p.pc, idx)
    c = a - ab_unit * tr[:, 0:1]
    x = co_unit * tr[:, 1:2]
    y = cross(x, ab_unit)
    w = torch.maximum(point_w[idx[:, 0]], point_w[idx[:, 1]])
    w = torch.where(degenerate, 0.0, w)
    m = torch.full((idx.shape[0],), n_rots, dtype=torch.int32, device=p.pc.device)
    cos_a, sin_a, ok = circle(m, n_rots, p.pc)
    fl, fr = [], []
    for k in range(3):
        gk = (c[:, k, None] + cos_a * x[:, k, None] + sin_a * y[:, k, None]
              - p.corner[k]) / p.res
        ok = ok & (gk >= 0.01) & (gk < torch.clamp(dims_f[k], max=g) - 1.01)
        fk = torch.clamp(torch.floor(gk).to(torch.int32), 0, g - 2)
        fl.append(fk.long())
        fr.append((gk - fk).double())
    wv = torch.where(ok, w[:, None], 0.0).double()
    return (fl[0] * g + fl[1]) * g + fl[2], fr, wv


def _corners(g: int, fr):
    """(flat offset, trilinear weight [n, R]) of each of a vote's corners."""
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                yield ((dx * g + dy) * g + dz,
                       (fr[0] if dx else 1 - fr[0]) * (fr[1] if dy else 1 - fr[1])
                       * (fr[2] if dz else 1 - fr[2]))


def center_grid(p: Prep, point_w: torch.Tensor, chunk: int = 1 << 15) -> torch.Tensor:
    """The dense center-vote grid [g, g, g], float64: every pair's votes
    (:func:`_pair_votes`) trilinear into the voxels."""
    g = p.edge
    grid = torch.zeros(g * g * g, dtype=torch.float64, device=p.pc.device)
    for s in range(0, p.idx.shape[0], chunk):
        base, fr, wv = _pair_votes(p, p.idx[s:s + chunk], p.tr[s:s + chunk], point_w)
        for off, hat in _corners(g, fr):
            grid.index_add_(0, (base + off).reshape(-1), (hat * wv).reshape(-1))
    return grid.view(g, g, g)


def mass_at(p: Prep, idx, tr, point_w, flat: int) -> torch.Tensor:
    """[n] float64: each pair's share of the voxel ``flat`` of the grid
    that :func:`center_grid` makes with ``point_w``."""
    base, fr, wv = _pair_votes(p, idx, tr, point_w)
    out = torch.zeros(idx.shape[0], dtype=torch.float64, device=p.pc.device)
    for off, hat in _corners(p.edge, fr):
        out += torch.where(base + off == flat, hat * wv, 0.0).sum(-1)
    return out


def near_shift(p: Prep, point_w, flat: int):
    """(the most, the least) by which the near-tie decodes can move the
    grid's mass at ``flat``: the sums of their other choices' gains and
    losses there."""
    nr = p.near
    if nr is None or nr.rows.numel() == 0:
        return 0.0, 0.0
    idx = p.idx[nr.rows]
    d = (mass_at(p, idx, nr.tr, point_w, flat) - mass_at(p, idx, p.tr[nr.rows], point_w, flat))
    return float(d.clamp(min=0).sum()), float(d.clamp(max=0).sum())


def backvote(p: Prep, center: torch.Tensor, chunk: int = 1 << 15, idx_all=None,
             tr_all=None) -> torch.Tensor:
    """[P] bool: pairs whose (adaptive) vote circle has an in-grid sample
    within ``backvote_tol_vox`` voxels of ``center`` (of ``idx_all`` with
    ``tr_all`` where given, else of every pair)."""
    cfg = p.cfg
    tol = cfg["backvote_tol_vox"] * cfg["res"]
    dims_f = p.dims.float()
    idx_all = p.idx if idx_all is None else idx_all
    tr_all = p.tr if tr_all is None else tr_all
    out = []
    for s in range(0, idx_all.shape[0], chunk):
        idx, tr = idx_all[s:s + chunk], tr_all[s:s + chunk]
        a, ab_unit, degenerate, co_unit = pair_frames(p.pc, idx)
        odist = tr[:, 1]
        m = torch.clamp((odist / p.res * TWO_PI).to(torch.int32), max=cfg["num_rots"])
        c = a - ab_unit * tr[:, 0:1]
        y_unit = cross(co_unit, ab_unit)
        cos_a, sin_a, ok = circle(m, cfg["num_rots"], p.pc)
        ok = ok & (~degenerate)[:, None]
        dist2 = torch.zeros_like(cos_a)
        for k in range(3):
            off = cos_a * (co_unit[:, k] * odist)[:, None] + sin_a * (y_unit[:, k] * odist)[:, None]
            ck = c[:, k, None] + off
            gk = (ck - p.corner[k]) / p.res
            ok = ok & (gk >= 0.0) & (gk < dims_f[k] - 1.0)
            d = ck - center[k]
            dist2 = dist2 + d * d
        out.append((ok & (dist2 <= tol * tol)).any(-1))
    return torch.cat(out)


def cumsum_blocked(x):
    """Prefix sums of a float32 vector in XLA's CPU order (blocks of 16
    left to right, the blocks' totals scanned the same way)."""
    n = x.shape[0]
    m = -(-n // SCAN_BLOCK)
    rows = torch.nn.functional.pad(x, (0, m * SCAN_BLOCK - n)).reshape(m, SCAN_BLOCK)
    for j in range(1, SCAN_BLOCK):
        rows[:, j] += rows[:, j - 1]
    if m > 1:
        rows[1:] += cumsum_blocked(rows[:, -1].clone())[:-1, None]
    return rows.reshape(-1)[:n]


def subsample(p: Prep, mask, sub_u, pair_w=None):
    """The axis vote's pairs: ``sub_u`` inverted through the CDF of the
    surviving pairs (weighted by ``pair_w``)."""
    keep = (mask | ~mask.any()).float()
    cdf = torch.cumsum(keep, 0) if pair_w is None else cumsum_blocked(keep * pair_w)
    return torch.clamp(torch.searchsorted(cdf, sub_u * cdf[-1], right=True), 0, mask.shape[0] - 1)


def cone_axes(p: Prep, sub, bins) -> torch.Tensor:
    """[n, num_rots, 3]: each pair's cone axes normalize(tan ψ · offset ±
    âb) at the angle bin ``bins``."""
    cfg = p.cfg
    ang = bins.float() / (cfg["rot_num_bins"] - 1) * math.pi
    _, ab_unit, degenerate, co_unit = pair_frames(p.pc, p.idx[sub])
    y_unit = cross(co_unit, ab_unit)
    i = torch.arange(cfg["num_rots"], dtype=torch.float32, device=p.pc.device)
    rot = i * (TWO_PI / cfg["num_rots"])
    t = torch.tan(ang)
    sign = torch.where(t > 0, 1.0, -1.0)
    offset = (torch.cos(rot)[None, :, None] * co_unit[:, None, :]
              + torch.sin(rot)[None, :, None] * y_unit[:, None, :])
    cand = t[:, None, None] * offset + (sign[:, None] * ab_unit)[:, None, :]
    cand = cand / (torch.linalg.norm(cand, dim=-1, keepdim=True) + 1e-7)
    return torch.where(degenerate[:, None, None], 0.0, cand)


def _cos_tol(p: Prep) -> float:
    return torch.cos(torch.deg2rad(torch.tensor(p.cfg["angle_prec"], dtype=torch.float32))).item()


def axis_counts(p: Prep, mask, logits, sub_u, gumbel, pair_w=None, chunk: int = 1 << 16,
                slack: bool = False):
    """Sphere counts [n_sphere] of one axis vote: the :func:`subsample`'s
    angle bins decoded on ``gumbel``, each pair's ``num_rots`` cone axes
    counted at every sphere direction within ``angle_prec``.  With
    ``slack``, (counts, [n_sphere] the most the near-tie decodes' other
    choices can move each count)."""
    sub = subsample(p, mask, sub_u, pair_w)
    scores = logits[sub] + gumbel
    bins = torch.argmax(scores, -1)
    cand = cone_axes(p, sub, bins).reshape(-1, 3)
    cos_tol = _cos_tol(p)
    counts = torch.zeros(p.sphere.shape[0], dtype=torch.float64, device=p.pc.device)
    for s in range(0, cand.shape[0], chunk):
        counts += ((cand[s:s + chunk] @ p.sphere.T) > cos_tol).double().sum(0)
    if not slack:
        return counts
    margin, other = second_choice(scores, bins)
    near = margin < DECODE_TIE
    if not bool(near.any()):
        return counts, torch.zeros_like(counts)

    def per_pair(b):
        hits = (cone_axes(p, sub[near], b) @ p.sphere.T) > cos_tol
        return hits.double().sum(1)

    return counts, (per_pair(other[near]) - per_pair(bins[near])).abs().sum(0)


def aux_losses(p: Prep, cand, aux_logits, aux_mask):
    """(BCE with the aux bits pointing along ``cand``, BCE pointing
    against it), each a mean over ``aux_mask``."""
    a, b = p.idx[:, 0], p.idx[:, 1]
    ab = p.pc[a] - p.pc[b]
    ab_unit = ab / (torch.linalg.norm(ab, dim=-1, keepdim=True) + 1e-7)
    n_a = p.normals[a]
    n_canon = n_a * torch.where(torch.sum(n_a * ab_unit, -1, keepdim=True) < 0, -1.0, 1.0)
    target = (torch.sum(n_canon * cand, -1) > 0).float()

    def bce(tgt):
        loss = (torch.clamp(aux_logits, min=0) - aux_logits * tgt
                + torch.log1p(torch.exp(-torch.abs(aux_logits))))
        return torch.sum(loss * aux_mask) / torch.clamp(torch.sum(aux_mask), min=1.0)

    return bce(target), bce(1.0 - target)


def asymmetry(p: Prep, center, axis, n_bins: int = 12):
    """Per-point protrusion score in [0, 1] about the line (center, axis):
    the radius's excess over its height slab's mean, in slab deviations."""
    mf = p.valid.float()
    d = p.pc - center[None, :]
    h = torch.sum(d * axis[None, :], -1)
    r = torch.linalg.norm(d - h[:, None] * axis[None, :], dim=-1)
    y_lo = torch.where(p.valid, h, 1e9).min()
    y_hi = torch.where(p.valid, h, -1e9).max()
    t = (h - y_lo) / torch.clamp(y_hi - y_lo, min=1e-6)
    b = torch.clamp((t * n_bins).to(torch.int32), 0, n_bins - 1)
    bins = torch.arange(n_bins, dtype=torch.int32, device=h.device)
    onehot = (b[:, None] == bins[None, :]).float()
    onehot = onehot * mf[:, None]
    cnt = onehot.sum(0)
    mean = torch.sum(onehot * r[:, None], 0) / torch.clamp(cnt, min=1.0)
    var = torch.sum(onehot * (r[:, None] - mean[None, :]) ** 2, 0) / torch.clamp(cnt, min=1.0)
    r_mean = torch.sum(mf * r) / torch.clamp(torch.sum(mf), min=1.0)
    sigma = torch.sqrt(var) + 0.03 * torch.clamp(r_mean, min=1e-6)
    excess = (r - mean[b.long()]) / sigma[b.long()]
    return torch.clamp((excess - 1.0) * 0.5, 0.0, 1.0) * mf


def protrusion(p: Prep, center, up, asym):
    """(unit direction of the protrusion-weighted centroid off the axis,
    whether there is one)."""
    w = torch.where(p.valid, asym, 0.0)
    cen = torch.sum(w[:, None] * (p.pc - center), 0)
    cen = cen - torch.dot(cen, up) * up
    n = torch.linalg.norm(cen)
    return cen / (n + 1e-9), bool((n > 1e-6) & (torch.sum(w) > 1.0))


def scale_of(p: Prep, mask):
    cfg = p.cfg
    pred = p.preds[:, -3:]
    m = mask.float()[:, None]
    mean = torch.sum(pred * m, 0) / torch.clamp(torch.sum(m, 0), min=1.0)
    smean = torch.tensor(cfg["scale_mean"], dtype=torch.float32, device=pred.device)
    return torch.exp(mean) * smean * cfg["scale_multiplier"]


def logits(p: Prep, axis: str):
    B, R = p.cfg["tr_num_bins"], p.cfg["rot_num_bins"]
    if axis == "up":
        return p.preds[:, 2 * B:2 * B + R], p.preds[:, -5]
    return p.preds[:, 2 * B + R:2 * B + 2 * R], p.preds[:, -4]


def voxel_center(p: Prep, flat: int) -> torch.Tensor:
    g = p.edge
    ijk = torch.tensor([flat // (g * g), (flat // g) % g, flat % g], device=p.pc.device)
    return p.corner + ijk.float() * p.cfg["res"]


def top_voxels(grid: torch.Tensor, best: int, allowed: torch.Tensor,
               share: float = CANDIDATE_SHARE):
    """Flat indices of the ``allowed`` voxels within ``share`` of the voxel
    ``best``, best first (first index on ties), at most ``MAX_CANDIDATES``."""
    flat = torch.where(allowed.reshape(-1), grid.reshape(-1), -1.0)
    vals, order = torch.topk(flat, min(MAX_CANDIDATES, flat.numel()))
    top = float(grid.reshape(-1)[best])
    out = [int(i) for v, i in zip(vals.tolist(), order.tolist()) if v >= (1 - share) * top]
    return out if best in out else [best] + out


def _pool_cols(m: torch.Tensor, f: int) -> torch.Tensor:
    a, b = m.shape
    m = torch.nn.functional.pad(m, (0, -(-b // f) * f - b))
    return m.reshape(a, -1, f).sum(-1)


def _maxpool(m: torch.Tensor, fa: int, fb: int) -> torch.Tensor:
    a, b = m.shape
    ca, cb = -(-a // fa), -(-b // fb)
    m = torch.nn.functional.pad(m, (0, cb * fb - b, 0, ca * fa - a))
    return m.reshape(ca, fa, cb, fb).amax((1, 3))


def peak(grid: torch.Tensor, rounds: int, window: int = 16, coarse: int = 8):
    """The center peak as the program's branch-and-bound defines it, on the
    dense grid: every ``coarse``³ cell bounded by the least of the block
    maxima of the grid's three projections (y and z columns pooled to at
    most 64 bins); then up to ``rounds`` times, while some cell's bound
    beats the best voxel so far, the best cell's window-aligned
    ``window``³ box is searched and its cells drop out.  Returns (the best
    voxel's flat index, a bool grid of the voxels searched)."""
    g = grid.shape[0]
    pf = 1
    while g > 64 * pf:
        pf *= 2
    mxy, mxz, myz = (_pool_cols(grid.sum(2), pf), _pool_cols(grid.sum(1), pf),
                     _pool_cols(grid.sum(0), pf))
    bnd = torch.minimum(torch.minimum(_maxpool(mxy, coarse, coarse // pf)[:, :, None],
                                      _maxpool(mxz, coarse, coarse // pf)[:, None, :]),
                        _maxpool(myz, coarse, coarse // pf)[None, :, :])
    n = bnd.shape[0]
    searched = torch.zeros_like(grid, dtype=torch.bool)
    best, best_flat = float("-inf"), 0
    for _ in range(rounds):
        if not float(bnd.max()) > best:
            break
        cflat = int(torch.argmax(bnd))
        cell = (cflat // (n * n), (cflat // n) % n, cflat % n)
        o = [c * coarse // window * window for c in cell]
        box = torch.zeros((window,) * 3, dtype=grid.dtype, device=grid.device)
        part = grid[o[0]:o[0] + window, o[1]:o[1] + window, o[2]:o[2] + window]
        box[:part.shape[0], :part.shape[1], :part.shape[2]] = part
        searched[o[0]:o[0] + window, o[1]:o[1] + window, o[2]:o[2] + window] = True
        wflat = int(torch.argmax(box))
        wmax = float(box.reshape(-1)[wflat])
        if wmax > best:
            local = (wflat // (window * window), (wflat // window) % window, wflat % window)
            best = wmax
            best_flat = ((o[0] + local[0]) * g + o[1] + local[1]) * g + o[2] + local[2]
        lo = [c * coarse for c in range(n)]
        full = [torch.tensor([(x >= o[k]) and (x + coarse <= o[k] + window) for x in lo],
                             device=grid.device) for k in range(3)]
        bnd = torch.where(full[0][:, None, None] & full[1][None, :, None] & full[2][None, None, :],
                          float("-inf"), bnd)
    return best_flat, searched


# ---- entry points ------------------------------------------------------------

# each configuration key that selects a mechanism of the program's pose, with
# the one value this reference implements; a key it leaves out (such as
# ``halfspace_margin`` or ``up_prior_dir``) acts only where one of these is on
FOLLOWS = {"splat": "trilinear", "center_mode": "hier", "geo_right_dir": "cross",
           "axis_topk": 1, "filter_coplanar": False, "coplanar_halfspace": False,
           "up_prior_deg": 0.0, "adaptive_voting": False, "sharp_axis_votes": False,
           "aux_align_weight": False, "subvoxel_refine": False, "pair_balance": 0.0,
           "pair_sep_power": 0.0, "z_right": False}


def follows(cfg: dict) -> None:
    """Raise ``ValueError`` naming each key of :data:`FOLLOWS` that ``cfg``
    leaves out or states at another value than the one this reference
    implements: a cell so configured would be judged as if the mechanism
    were off."""
    wrong = [f"{k}: stated {cfg[k]!r}, followed {v!r}" if k in cfg
             else f"{k}: not stated, followed {v!r}"
             for k, v in FOLLOWS.items() if k not in cfg or cfg[k] != v]
    if wrong:
        raise ValueError(f"reference/pose.py does not follow configuration "
                         f"{cfg.get('name')!r}: " + "; ".join(wrong))


def prepare(cfg: dict, weights: Dict[str, torch.Tensor], crop: np.ndarray,
            draws: Dict[str, torch.Tensor]) -> Prep:
    pc, nrm, n_valid, valid, nbr = preprocess(cfg, crop, draws["jitter"])
    feat = model.point_features(weights, cfg, pc, nrm, nbr, valid)
    nv = torch.tensor(n_valid, dtype=torch.int32, device=pc.device)
    idx = torch.minimum((draws["pair_u"] * nv).to(torch.int32), nv - 1).long()
    preds = model.pair_head(weights, cfg, pc, nrm, feat, idx)
    B = cfg["tr_num_bins"]
    v0, v1 = cfg["vote_range"]
    tl = preds[:, :2 * B].reshape(-1, 2, B)
    scores = [tl[:, 0] + draws["tr_gumbel"][0], tl[:, 1] + draws["tr_gumbel"][1]]
    i0, i1 = torch.argmax(scores[0], -1), torch.argmax(scores[1], -1)
    tr = torch.stack([i0.float() / (B - 1) * 2 * v0 - v0, i1.float() / (B - 1) * v1], -1)
    rows, alts, margins = [], [], []
    for k, best in ((0, i0), (1, i1)):
        margin, other = second_choice(scores[k], best)
        at = torch.nonzero(margin < DECODE_TIE).reshape(-1)
        alt = tr[at].clone()
        j = other[at]
        alt[:, k] = j.float() / (B - 1) * 2 * v0 - v0 if k == 0 else j.float() / (B - 1) * v1
        rows.append(at)
        alts.append(alt)
        margins.append(margin[at])
    near = Near(torch.cat(rows), torch.cat(alts), torch.cat(margins))
    res = torch.tensor(cfg["res"], dtype=torch.float32, device=pc.device)
    corner = torch.where(valid[:, None], pc, 1e9).amin(0)
    top = torch.where(valid[:, None], pc, -1e9).amax(0)
    edge = grid_edge(cfg)
    dims = torch.minimum(((top - corner) / res).to(torch.int32) + 1,
                         torch.tensor(edge, dtype=torch.int32, device=pc.device))
    sphere = torch.from_numpy(fibonacci_sphere(cfg["n_sphere"]).astype(np.float32)).to(pc.device)
    p = Prep(cfg, pc, nrm, n_valid, valid, idx, preds, tr, corner, dims, sphere,
             torch.zeros((edge,) * 3, dtype=torch.float64, device=pc.device), near)
    p.grid1 = center_grid(p, torch.ones(pc.shape[0], device=pc.device))
    return p


def toggles(p: Prep, center, mask):
    """(pairs out of ``mask`` that a near-tie decode's other choice brings
    within the back-vote's reach of ``center``, pairs in it that it takes
    out), each ordered by the decode's margin, smallest first."""
    nr = p.near
    if nr is None or nr.rows.numel() == 0:
        return [], []
    reach = backvote(p, center, idx_all=p.idx[nr.rows], tr_all=nr.tr)
    was = mask[nr.rows]
    add, rem = {}, {}
    for row, r, w, m in zip(nr.rows.tolist(), reach.tolist(), was.tolist(),
                            nr.margin.tolist()):
        if r != w:
            side = rem if w else add
            side[row] = min(m, side.get(row, m))
    return (sorted(add, key=add.get), sorted(rem, key=rem.get))


def worlds(mask, add: List[int], rem: List[int], n_target: Optional[float] = None):
    """The survivor masks a sound program may hold: ``mask`` first, then
    ``mask`` with toggles of :func:`toggles` (one at a time where the
    program's count is unknown; else the sets of at most two that give its
    count ``n_target``), at most ``MAX_WORLDS`` in all."""
    yield mask
    d = None if n_target is None else int(round(n_target)) - int(mask.sum())
    if d is None:
        sets = [(r,) for r in add + rem]
    elif d == 0:
        sets = [(a, r) for a in add for r in rem]
    elif 0 < d <= 2:
        sets = list(itertools.combinations(add, d))
    elif -2 <= d < 0:
        sets = list(itertools.combinations(rem, -d))
    else:
        sets = []
    for rows in sets[:MAX_WORLDS - 1]:
        m = mask.clone()
        m[list(rows)] = ~m[list(rows)]
        yield m


def near_gap(counts, slack, j: int) -> float:
    """The axis bin ``j``'s count gap to the best, a share of the best, at
    the most favourable reading of the near-tie decodes (``slack``)."""
    lo = float((counts - slack).max())
    return max(0.0, lo - float(counts[j] + slack[j])) / max(float(counts.max()), 1.0)


def _vote_axis(p: Prep, mask, axis: str, draws, pair_w=None):
    """(signed axis, sphere counts, the unsigned winner's index)."""
    lg, aux = logits(p, axis)
    counts = axis_counts(p, mask, lg, draws[axis + "_sub"], draws[axis + "_gumbel"], pair_w)
    i = int(torch.argmax(counts))
    aux_mask = mask.float() if pair_w is None else mask.float() * pair_w
    l_up, l_down = aux_losses(p, p.sphere[i], aux, aux_mask)
    return (-p.sphere[i] if l_down < l_up else p.sphere[i]), counts, i


def _right_weights(p: Prep, center, up):
    asym = asymmetry(p, center, up)
    w = None
    if p.cfg["asym_right_votes"]:
        w = 0.05 + 0.95 * torch.maximum(asym[p.idx[:, 0]], asym[p.idx[:, 1]])
    return asym, w


def _second_pass(p: Prep, T1, up):
    """(the second pass's grid, the protrusion's direction, whether there
    is one, the points' weights in the grid)."""
    asym_c = asymmetry(p, T1, up)
    point_w = 0.05 + 0.95 * asym_c
    grid2 = center_grid(p, point_w)
    u_h, gate = protrusion(p, T1, up, asym_c)
    return grid2, u_h, gate, point_w


def _assemble(up, right):
    return torch.stack([right, up, cross(right, up)], -1)


def estimate(p: Prep, draws) -> dict:
    """The reference's own pose: T, R, scale, up, right, n_filtered,
    grid_max."""
    cfg = p.cfg
    flat, _ = peak(p.grid1, cfg["peak_rounds"])
    T = voxel_center(p, flat)
    grid_max = float(p.grid1.reshape(-1)[flat])
    mask = backvote(p, T)
    up, _, _ = _vote_axis(p, mask, "up", draws)
    if cfg["asym_center_refine"]:
        grid2, u_h, gate, _ = _second_pass(p, T, up)
        if gate:
            T2 = voxel_center(p, peak(grid2, cfg["peak_rounds"])[0])
            T = T + torch.dot(T2 - T, u_h) * u_h
        mask = backvote(p, T)
    if cfg["regress_right"]:
        asym, w = _right_weights(p, T, up)
        right, _, _ = _vote_axis(p, mask, "right", draws, w)
        if cfg["geo_right_sign"]:
            h_dir, gate = protrusion(p, T, up, asym)
            if gate and float(torch.dot(right, cross(h_dir, up))) < 0:
                right = -right
        right = orthonormal_right(up, right)
    else:
        right = torch.stack([torch.zeros_like(up[0]), -up[2], up[1]])
        right = right / (torch.linalg.norm(right) + 1e-9)
    if float(torch.linalg.norm(right)) < 1e-7:
        right = orthonormal_right(up, draws["fallback"])
    scale = scale_of(p, mask)
    return {"T": T, "R": _assemble(up, right), "scale": scale, "up": up, "right": right,
            "n_filtered": float(mask.sum()), "grid_max": grid_max}


def _gap(p: Prep, grid: torch.Tensor, point_w, best: int, flat: int) -> float:
    """How far the voxel ``flat`` lies below the peak ``best``, a share of
    the peak's mass (0 where it lies above), at the most favourable reading
    of the near-tie decodes (:func:`near_shift`)."""
    if flat == best:
        return 0.0
    top = float(grid.reshape(-1)[best])
    _, top_loss = near_shift(p, point_w, best)
    flat_gain, _ = near_shift(p, point_w, flat)
    return max(0.0, top + top_loss - float(grid.reshape(-1)[flat]) - flat_gain) / max(top, 1e-30)


def _sign_margin(l_a, l_b) -> float:
    """How decisively the reference's aux losses pick a sign: their
    difference over the smaller."""
    return abs(float(l_a) - float(l_b)) / max(min(float(l_a), float(l_b)), 1e-30)


def judge(p: Prep, draws, out: dict) -> Dict[str, float]:
    """How far the program's pose ``out`` (T, R, scale, up, right, and where
    the program reports them n_filtered and grid_max, as floats or tensors)
    lies from what the reference makes of the same crop and draws.  Each
    discrete choice of the program is followed; the numbers:

    - ``t_vox``: voxels from the program's T to the nearest T the reference
      reaches on a path of peak candidates (bottle: the lattice of the grid);
    - ``center_gap`` / ``center2_gap``: the chosen first / second-pass
      peak's gap to its grid's maximum, a share of the maximum;
    - ``peak_rel``: the program's peak mass against the grid's at its voxel;
    - ``survivors_rel``: the program's back-vote survivors against the
      reference's at the program's T;
    - ``up_gap`` / ``right_gap``: the program's axis bin's count gap to the
      best bin, a share of the best; ``up_sign`` / ``right_sign``: where the
      program's sign is not the reference's, how decisive the reference's
      choice was (0 where they agree);
    - ``axis_dev``: 1 − |cos| between the program's axes and the sphere
      directions they must come from, and the largest entry of R minus the
      rotation of its axes;
    - ``scale_rel``: the largest relative error of the three scales.
    """
    cfg = p.cfg
    dev = p.pc.device
    f = {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in out.items()}
    T, up_p, right_p = f["T"].reshape(3), f["up"].reshape(3), f["right"].reshape(3)
    res = cfg["res"]
    nums: Dict[str, float] = {}

    # the sphere directions the program's up may have come from: the nearest,
    # and at the poles its antipode, which the sphere also holds
    cos_up = torch.abs(p.sphere @ up_p)
    axis_dev = 1.0 - float(cos_up.max())
    up_from = cos_up >= cos_up.max() - 1e-6

    # the center: the program's first-pass voxel (and second-pass peak)
    g = p.edge
    rounds = cfg["peak_rounds"]
    peak1, searched1 = peak(p.grid1, rounds)
    ones = torch.ones(p.pc.shape[0], device=dev)
    if cfg["asym_center_refine"]:
        best = None
        for v in top_voxels(p.grid1, peak1, searched1):
            T1 = voxel_center(p, v)
            grid2, u_h, gate, w2 = _second_pass(p, T1, up_p)
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
        nums["center2_gap"] = 0.0 if v2 is None else _gap(p, grid2, w2, peak2, v2)
    else:
        ijk_f = (T - p.corner) / res
        ijk = torch.round(ijk_f)
        d = float(torch.linalg.norm(ijk_f - ijk))
        inside = bool(((ijk >= 0) & (ijk < g)).all())
        v1 = int((ijk[0] * g + ijk[1]) * g + ijk[2]) if inside else None
        T1 = T
    nums["t_vox"] = d
    nums["center_gap"] = 1.0 if v1 is None else _gap(p, p.grid1, ones, peak1, v1)
    if "grid_max" in out and v1 is not None:
        ref = float(p.grid1.reshape(-1)[v1])
        gain, loss = near_shift(p, ones, v1)
        got = float(f["grid_max"])
        nums["peak_rel"] = max(0.0, ref + loss - got, got - ref - gain) / max(ref, 1e-30)

    # the survivors: the reference's masks at the program's first-pass and
    # final T, and the masks the near-tie decodes may give instead
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

    # up, on the first pass's survivors
    lg, aux = logits(p, "up")
    i_up, up_gap = None, None
    for m in worlds1:
        counts, slack = axis_counts(p, m, lg, draws["up_sub"], draws["up_gumbel"], slack=True)
        i = int(torch.argmax(torch.where(up_from, counts + slack, -1.0)))
        i_up = i if i_up is None else i_up
        gap = near_gap(counts, slack, i)
        up_gap = gap if up_gap is None else min(up_gap, gap)
        if up_gap == 0.0:
            break
    nums["up_gap"] = up_gap
    l_up, l_down = aux_losses(p, p.sphere[i_up], aux, mask1.float())
    ref_up = -p.sphere[i_up] if l_down < l_up else p.sphere[i_up]
    nums["up_sign"] = 0.0 if float(torch.dot(ref_up, up_p)) > 0 else _sign_margin(l_up, l_down)

    # the survivors and the scale at the program's final T
    n_ref = float(mask.sum())
    if n_prog is not None:
        nums["survivors_rel"] = max(0.0, n_ref - len(rem) - n_prog,
                                    n_prog - n_ref - len(add)) / max(n_ref, 1.0)
    scale_p = f["scale"].reshape(3)
    nums["scale_rel"] = min(float(torch.max(torch.abs(scale_p - s) / s))
                            for s in (scale_of(p, m) for m in finals))

    # right
    if cfg["regress_right"]:
        asym, w = _right_weights(p, T, up_p)
        lg, aux = logits(p, "right")
        proj = p.sphere - (p.sphere @ up_p)[:, None] * up_p[None, :]
        proj = proj / (torch.linalg.norm(proj, dim=-1, keepdim=True) + 1e-9)
        cos_r = torch.abs(proj @ right_p)
        # the directions the program's right may have come from: those whose
        # projection it is, and up's own line, whose vote leaves a right axis
        # of rounding noise or the fallback normal (and no sign to judge)
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
        margin = _sign_margin(l_a, l_b)
        if cfg["geo_right_sign"]:
            h_dir, gate = protrusion(p, T, up_p, asym)
            ref_dir = cross(h_dir, up_p)
            if gate:
                dot = float(torch.dot(r, ref_dir))
                margin = abs(dot)
                if dot < 0:
                    r = -r
        r = orthonormal_right(up_p, r)
        nums["right_sign"] = 0.0 if on_line or float(torch.dot(r, right_p)) > 0 else margin
        R_ref = _assemble(up_p, right_p)
    else:
        r = torch.stack([torch.zeros_like(up_p[0]), -up_p[2], up_p[1]])
        r = r / (torch.linalg.norm(r) + 1e-9)
        R_ref = _assemble(up_p, r)
    nums["axis_dev"] = max(axis_dev, float(torch.max(torch.abs(f["R"].reshape(3, 3) - R_ref))))
    return nums
