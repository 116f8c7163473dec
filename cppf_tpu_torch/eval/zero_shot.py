"""Zero-shot multi-instance detection and 9D pose on a whole depth frame
(counterpart of cppf_tpu/eval/zero_shot.py; reference nocs/zero_shot.ipynb).

A regression-variant checkpoint (``cls_bins: false``, 9 outputs a pair:
proj_len, odist, ψ_up, ψ_right, two aux logits, three log-scales) runs on
every pair of a whole frame, and the detections come from one global
center-vote heatmap.  The stages, each a function so a caller can time it:

1. prep: :func:`frame_clouds` (backprojection, jitter, voxel downsample at
   ``res`` for the network and at ``4·res`` for voting, KNN, normals) and
   :func:`sample_pairs` (pairs drawn on the host, degenerate pairs dropped);
2. network: :func:`frame_predictions` (SPRIN features, PPF head over the
   pairs in chunks);
3. heatmap: :func:`frame_heatmap`, the adaptive center-vote grid of the
   whole frame through ``ppf_vote_dense`` and its ``dense_hist_pairs``
   kernel, which makes the votes from the pair parameters;
4. detect: :func:`detect_from_heatmap` (smoothed peak proposals, evidence
   re-rank with NMS and the support-plane veto, then per proposal the
   back-vote mask, the axis vote, the aux sign, the scale and the box
   anchor).

Random draws: the jitter, the pair indices and the axis-vote permutation
come from ``np.random.default_rng(seed)`` on the host in the JAX package's
order, and the RANSAC uniforms of :func:`scene_planes` are JAX's
``uniform(PRNGKey(seed + k), (200, 3))`` (``core/threefry.py``) unless the
caller injects them, so both packages draw the same numbers for a seed.
Tensors live on the path's device; proposals, the heatmap's host copy and
the detections are numpy, as in the JAX package.

:func:`main` is the command-line entry point (``python -m
cppf_tpu_torch.eval.zero_shot --ckpt ...``): detect on a PNG depth frame
and draw the boxes on its colour frame.
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from cppf_tpu_torch.config import REPO_ROOT, load_config
from cppf_tpu_torch.core import threefry
from cppf_tpu_torch.core.geometry import (backproject, calculate_2d_projections, fibonacci_sphere,
                                          get_3d_bbox, transform_coordinates_3d)
from cppf_tpu_torch.data.png import read_png, write_png
from cppf_tpu_torch.device import pin_float32, resolve_device
from cppf_tpu_torch.eval.anchor import anchor_box_t
from cppf_tpu_torch.eval.viz import draw_line
from cppf_tpu_torch.models.convert import ASSETS, load_encoders, load_npz_params
from cppf_tpu_torch.ops.knn import knn_indices
from cppf_tpu_torch.ops.normals import estimate_normals
from cppf_tpu_torch.ops.quantize import voxel_downsample_host
from cppf_tpu_torch.ops.ransac import segment_plane
from cppf_tpu_torch.ops.voting import (backvote, circle_support, ppf_vote_dense, rot_vote,
                                       sphere_bin_count)
from cppf_tpu_torch.train.checkpoints import maybe_load_any

log = logging.getLogger("cppf_tpu_torch.zero_shot")

DEMO_INTRINSICS = np.array([[591.0125, 0, 322.525], [0, 590.16775, 244.11084], [0, 0, 1]])
PAIR_CHUNK = 1 << 20   # pairs a chunk: 48 MiB of pair parameters, one dense_hist_pairs launch
PLANE_ITERS = 200


class Detection(NamedTuple):
    T: np.ndarray
    R: np.ndarray
    scale: np.ndarray       # absolute 3D scale
    RT: np.ndarray          # [4,4] R*|s| convention
    mask: np.ndarray        # [n_points] bool instance mask on the voting cloud
    score: float


class FrameClouds(NamedTuple):
    high_pc: torch.Tensor       # [N_hi, 3] network cloud (voxels of res)
    high_normal: torch.Tensor   # [N_hi, 3]
    nbr_idx: torch.Tensor       # [N_hi, knn] int32
    lo_idx: torch.Tensor        # [N] indices into high_pc of the voting cloud (4·res)


class HeatmapState(NamedTuple):
    """Everything stages 1-3 produce: the voting cloud, pairs and
    predictions as tensors on the path's device; the heatmap [dims] on the
    host, with its world ``corner`` (float32) and ``dims`` (int32)."""
    pc: torch.Tensor
    pc_normal: torch.Tensor
    point_idxs: torch.Tensor
    preds: torch.Tensor
    grid: np.ndarray
    corner: np.ndarray
    dims: np.ndarray


def boundary_contrast(smoothed: np.ndarray, loc: np.ndarray, margin: int = 10):
    """Peak value minus the mean over the 12 edges of the ``margin``-box
    boundary around ``loc`` (notebook cell 9)."""
    lll = np.maximum(np.zeros(3, int), loc - margin)
    rrr = np.minimum(np.array(smoothed.shape) - 1, loc + margin)
    nbr_val = (
        np.mean(smoothed[lll[0]:rrr[0], lll[1], lll[2]])
        + np.mean(smoothed[lll[0]:rrr[0], lll[1], rrr[2]])
        + np.mean(smoothed[lll[0]:rrr[0], rrr[1], lll[2]])
        + np.mean(smoothed[lll[0]:rrr[0], rrr[1], rrr[2]])
        + np.mean(smoothed[lll[0], lll[1]:rrr[1], lll[2]])
        + np.mean(smoothed[lll[0], lll[1]:rrr[1], rrr[2]])
        + np.mean(smoothed[rrr[0], lll[1]:rrr[1], lll[2]])
        + np.mean(smoothed[rrr[0], lll[1]:rrr[1], rrr[2]])
        + np.mean(smoothed[lll[0], lll[1], lll[2]:rrr[2]])
        + np.mean(smoothed[lll[0], rrr[1], lll[2]:rrr[2]])
        + np.mean(smoothed[rrr[0], lll[1], lll[2]:rrr[2]])
        + np.mean(smoothed[rrr[0], rrr[1], lll[2]:rrr[2]])
    ) / 12
    diff = smoothed[loc[0], loc[1], loc[2]] - nbr_val
    return float(diff), lll, rrr


def extract_proposals_host(grid: np.ndarray, corner: np.ndarray, res: float,
                           thresh: float = 50.0, margin: int = 10):
    """Iterative peak proposals on the Gaussian-smoothed heatmap (notebook
    cell 9, host numpy and scipy): [(center, contrast)], best first."""
    from scipy.ndimage import gaussian_filter

    smoothed = gaussian_filter(grid, sigma=1)
    proposals = []
    max_val = None
    while True:
        loc = np.array(np.unravel_index(np.argmax(smoothed), smoothed.shape))
        diff, lll, rrr = boundary_contrast(smoothed, loc, margin)
        if diff > thresh:
            if max_val is None:
                max_val = diff
            proposals.append((corner + loc * res, float(diff)))
        if diff < thresh or diff < max_val * 0.7:
            break
        smoothed[lll[0]:rrr[0], lll[1]:rrr[1], lll[2]:rrr[2]] = 0
    return proposals


def plane_uniforms(seed: int, num_iterations: int = PLANE_ITERS) -> torch.Tensor:
    """The RANSAC uniforms of one :func:`scene_planes` round: JAX's
    ``uniform(PRNGKey(seed), (num_iterations, 3))``, drawn on the CPU."""
    return threefry.draw_many([("uniform", threefry.key(seed), (num_iterations, 3))], "cpu")[0]


def scene_planes(pc: torch.Tensor, fit_tol: float = 0.008, member_tol: float = 0.015,
                 min_frac: float = 0.2, min_extent: float = 0.3, max_planes: int = 2,
                 seed: int = 0, uniforms: Optional[Sequence] = None) -> np.ndarray:
    """Host bool mask of the points on the dominant support surfaces.

    Up to ``max_planes`` rounds of :func:`segment_plane` at ``fit_tol``; a
    round's plane counts only if it holds ≥ ``min_frac`` of the remaining
    points and its inliers span ≥ ``min_extent`` along both in-plane
    principal axes (a table is wide every way, a tangent band of a curved
    object is not).  Membership is then taken at ``member_tol``.  Round
    ``k`` uses ``uniforms[k]`` when given, else :func:`plane_uniforms`
    (``seed + k``)."""
    pc_np = pc.cpu().numpy()
    on_plane = np.zeros(len(pc_np), bool)
    remaining = np.arange(len(pc_np))
    for k in range(max_planes):
        if len(remaining) < 100:
            break
        u = plane_uniforms(seed + k) if uniforms is None else torch.as_tensor(uniforms[k])
        plane, mask = segment_plane(u.to(pc.device), pc[torch.from_numpy(remaining).to(pc.device)],
                                    fit_tol)
        mask = mask.cpu().numpy()
        if mask.sum() < min_frac * len(remaining):
            break
        plane = plane.cpu().numpy()
        inl = pc_np[remaining[mask]]
        cen = inl - inl.mean(0)
        in_plane = cen - np.outer(cen @ plane[:3], plane[:3])
        cov = in_plane.T @ in_plane / max(len(inl), 1)
        _, evecs = np.linalg.eigh(cov)
        # the two largest eigenvectors span the plane; the extent along each
        spans = [np.ptp(in_plane @ evecs[:, j]) for j in (1, 2)]
        remaining = remaining[~mask]
        if min(spans) < min_extent:
            continue
        on_plane |= np.abs(pc_np @ plane[:3] + plane[3]) < member_tol
    return on_plane


def _center(T, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(T, np.float32), device=like.device)


def rank_proposals(hm: HeatmapState, proposals, res: float, nms_radius: float = 0.15,
                   contrib_thresh: int = 12, plane_veto: float = 0.5,
                   plane_u: Optional[Sequence] = None):
    """Object-evidence re-ranking of the cell-9 proposals (an addition over
    the reference notebook): score = contrast × the pairs whose vote circle
    passes within ``res`` of the center (:func:`circle_support`); greedy 3D
    NMS at ``nms_radius``; a survivor whose instance mask (pairs at 3·res,
    points in more than ``contrib_thresh`` of them) lies more than
    ``plane_veto`` on a support plane (:func:`scene_planes`, uniforms
    ``plane_u``) is dropped.  Returns [(T, score)], best first."""
    if not proposals:
        return []
    tr = hm.preds[:, :2]
    scored = []
    for T_est, diff in proposals:
        tight = circle_support(hm.pc, tr, hm.point_idxs, _center(T_est, hm.pc), res)
        scored.append((T_est, diff * float(tight.sum())))
    scored.sort(key=lambda p: -p[1])

    kept = []
    for T_est, score in scored:
        if all(np.linalg.norm(T_est - k[0]) > nms_radius for k in kept):
            kept.append((T_est, score))

    on_plane = scene_planes(hm.pc, uniforms=plane_u)
    n = hm.pc.shape[0]
    out = []
    for T_est, score in kept:
        loose = circle_support(hm.pc, tr, hm.point_idxs, _center(T_est, hm.pc), 3 * res)
        contrib = torch.bincount(hm.point_idxs[loose].reshape(-1).long(), minlength=n)
        sel = (contrib > contrib_thresh).cpu().numpy()
        if sel.sum() and on_plane[sel].mean() > plane_veto:
            continue
        out.append((T_est, score))
    return out


def filter_degenerate_pairs(pc: torch.Tensor, pc_normal: torch.Tensor,
                            point_idxs: torch.Tensor) -> torch.Tensor:
    """Drop the coplanar pairs a PPF cannot tell apart (notebook cell 6):
    |n₁·n₂| > 0.9 with both normals ⟂ the pair axis."""
    idx = point_idxs.long()
    n1, n2 = pc_normal[idx[:, 0]], pc_normal[idx[:, 1]]
    ab = pc[idx[:, 0]] - pc[idx[:, 1]]
    ab = ab / (torch.linalg.norm(ab, dim=-1, keepdim=True) + 1e-7)
    bad = ((torch.abs(torch.sum(n1 * n2, -1)) > 0.9)
           & (torch.abs(torch.sum(ab * n1, -1)) < 0.1)
           & (torch.abs(torch.sum(ab * n2, -1)) < 0.1))
    return point_idxs[~bad]


def frame_clouds(depth: np.ndarray, intrinsics: np.ndarray, res: float, knn: int,
                 rng: np.random.Generator, device) -> FrameClouds:
    """Stage 1a (notebook cell 3): the whole frame backprojected, jittered
    (host draws), x/y flipped, voxel-downsampled at ``res`` (network cloud,
    with KNN and normals) and again at ``4·res`` (voting cloud)."""
    pc_full, _ = backproject(depth, intrinsics, np.ones_like(depth, dtype=bool))
    pc_full = pc_full / 1000.0
    pc_full = pc_full + np.clip(res / 4 * rng.standard_normal(pc_full.shape), -res / 2, res / 2)
    pc_full[:, 0] = -pc_full[:, 0]
    pc_full[:, 1] = -pc_full[:, 1]

    hi_idx = voxel_downsample_host(pc_full.astype(np.float32), res, device)
    high_np = pc_full[hi_idx].astype(np.float32)
    high_pc = torch.from_numpy(high_np).to(device)
    nbr_idx = knn_indices(high_pc, knn)
    high_normal = estimate_normals(high_pc, knn, nbr_idx=nbr_idx)
    lo_idx = voxel_downsample_host(high_np, res * 4, device)
    return FrameClouds(high_pc, high_normal, nbr_idx, torch.from_numpy(lo_idx).to(device).long())


def sample_pairs(pc: torch.Tensor, pc_normal: torch.Tensor, n_pairs: int,
                 rng: np.random.Generator) -> torch.Tensor:
    """Stage 1b (notebook cell 6): ``n_pairs`` index pairs drawn on the host,
    degenerate ones dropped; int32 [P, 2] on ``pc``'s device."""
    idx = torch.from_numpy(rng.integers(0, pc.shape[0], (n_pairs, 2))).to(pc.device)
    return filter_degenerate_pairs(pc, pc_normal, idx).to(torch.int32)


def frame_predictions(point_encoder, ppf_encoder, clouds: FrameClouds,
                      point_idxs: torch.Tensor, chunk: int = PAIR_CHUNK) -> torch.Tensor:
    """Stage 2 (notebook cell 7): SPRIN features on the network cloud, taken
    at the voting cloud, then the PPF head ``chunk`` pairs at a time.
    Returns [P, 9]."""
    feat = point_encoder(clouds.high_pc, clouds.high_normal, clouds.nbr_idx)[clouds.lo_idx]
    pc, pc_normal = clouds.high_pc[clouds.lo_idx], clouds.high_normal[clouds.lo_idx]
    return torch.cat([ppf_encoder(pc, pc_normal, feat, point_idxs[s:s + chunk])
                      for s in range(0, max(point_idxs.shape[0], 1), chunk)])


def _pair_circles(pc, preds_tr, point_idxs, res: float, window: int):
    """Each pair's vote-circle center (float64 [P, 3]) and its reach to a
    window's center: the circle's radius plus the window's half diagonal
    and 2 voxels (float64 [P])."""
    idx = point_idxs.long()
    a = pc[idx[:, 0]]
    d = a - pc[idx[:, 1]]
    du = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-7)
    cc = (a - preds_tr[:, :1] * du).double()
    return cc, torch.abs(preds_tr[:, 1]).double() + (window // 2 * np.sqrt(3) + 2) * res


def _window_origin(cell: np.ndarray, dims: np.ndarray, window: int, coarse_pool: int):
    """Voxel origin of the ``window``³ grid centred on a coarse cell,
    clipped into the frame's grid."""
    return np.clip(cell * coarse_pool + coarse_pool // 2 - window // 2, 0,
                   np.maximum(dims - window, 0)).astype(int)


def _window_pairs(wo: np.ndarray, circles, corner: np.ndarray, res: float, window: int,
                  pair_budget: int):
    """(indices of the pairs whose circle can reach the window at ``wo``,
    vote weight): past ``pair_budget`` the pairs are subsampled by a stride
    and the weight is the stride, so the window's mass stays comparable."""
    cc, reach = circles
    wc = torch.as_tensor(corner + (wo + window // 2) * res, dtype=torch.float64,
                         device=cc.device)
    keep = torch.nonzero(torch.linalg.norm(cc - wc, dim=-1) <= reach)[:, 0]
    if keep.numel() <= pair_budget:
        return keep, 1.0
    stride = keep.numel() // pair_budget + 1
    return keep[::stride], float(stride)


def _sparse_frame_grid(pc, preds_tr, point_idxs, corner, dims, res, num_rots: int,
                       n_cands: int = 24, window: int = 48, coarse_pool: int = 8,
                       pair_budget: int = 1 << 17, keep_mass: float = 50.0, halo: int = 13,
                       pair_chunk: int = PAIR_CHUNK) -> np.ndarray:
    """Whole-frame heatmap from a pooled pass and exact windows (cppf_tpu
    eval/zero_shot.py:225-339), both through ``ppf_vote_dense``:

    1. the grid pooled by ``coarse_pool`` on every axis ranks candidate
       cells (a cell's mass bounds every voxel inside it);
    2. each candidate — the top ``n_cands`` cells plus every further cell of
       mass ≥ ``keep_mass``, at most ``4·n_cands`` — gets an exact
       ``window``³ grid from only the pairs whose vote circle can reach it
       (subsampled by a stride past ``pair_budget``, the lost mass restored
       by the vote weight ``comp``), and its core (the cell dilated by
       ``halo``) is written to the output, zeros elsewhere.

    ``corner`` float32 [3] and ``dims`` int32 [3] are host arrays; returns
    the host grid [dims]."""
    dev = pc.device
    n = pc.shape[0]
    dims = np.asarray(dims)
    gshape_c = tuple(int(np.ceil(d / coarse_pool / 8) * 8) * coarse_pool for d in dims)
    coarse = ppf_vote_dense(
        pc, preds_tr, torch.ones(n, device=dev), point_idxs, _center(corner, pc), res,
        torch.from_numpy(dims).to(dev), gshape_c, n_rots=num_rots, adaptive=True,
        pool=(coarse_pool,) * 3, pair_chunk=pair_chunk).cpu().numpy()

    order = np.argsort(coarse.reshape(-1))[::-1]
    masses = coarse.reshape(-1)[order]
    n_above = int(np.sum(masses >= keep_mass))
    n_keep = min(max(n_cands, n_above), 4 * n_cands)
    if n_above > 4 * n_cands:
        log.warning("sparse grid candidate cap: %d cells above keep_mass=%.0f, keeping %d; "
                    "peaks in the dropped cells are not scored", n_above, keep_mass, 4 * n_cands)
    flat = order[:n_keep]
    cands = np.stack(np.unravel_index(flat, coarse.shape), -1)
    cands = cands[coarse.reshape(-1)[flat] > 0]

    circles = _pair_circles(pc, preds_tr, point_idxs, res, window)
    out = torch.zeros(tuple(int(x) for x in dims), dtype=torch.float32, device=dev)
    for cell in cands:
        wo = _window_origin(cell, dims, window, coarse_pool)
        # only the exact-halo core is written: the coarse cell (+1 voxel of
        # trilinear spill) dilated by `halo`, clipped to window ∩ grid, so
        # no peak scores its contrast against the zeroed background
        lo = np.maximum(np.maximum(cell * coarse_pool - 1 - halo, wo), 0)
        hi = np.minimum(np.minimum((cell + 1) * coarse_pool + 1 + halo, wo + window), dims)
        if np.any(lo >= hi):
            continue
        keep, comp = _window_pairs(wo, circles, corner, res, window, pair_budget)
        if keep.numel() == 0:
            continue
        win = ppf_vote_dense(
            pc, preds_tr[keep], torch.full((n,), comp, device=dev), point_idxs[keep],
            _center(corner + wo * res, pc), res,
            torch.from_numpy(np.minimum(dims - wo, window).astype(np.int32)).to(dev),
            (window,) * 3, n_rots=num_rots, adaptive=True, pair_chunk=pair_chunk)
        out[tuple(slice(int(l), int(h)) for l, h in zip(lo, hi))] = \
            win[tuple(slice(int(l - o), int(h - o)) for l, h, o in zip(lo, hi, wo))]
    return out.cpu().numpy()


def frame_heatmap(pc: torch.Tensor, preds_tr: torch.Tensor, point_idxs: torch.Tensor,
                  res: float, num_rots: int, sparse: bool = False,
                  pair_chunk: int = PAIR_CHUNK):
    """Stage 3 (notebook cell 8): the adaptive center-vote heatmap of the
    whole frame.  Returns (grid [dims] host float32, corner, dims).

    The default (``sparse=False``) is the dense route on every device: one
    ``ppf_vote_dense`` pass, pool (1,1,1), over the whole frame's grid
    (``dims`` rounded up to multiples of 8), one ``dense_hist_pairs``
    launch a pair chunk.  It computes the grid of the JAX package's ``ppf_vote``
    route, which JAX takes everywhere but on a TPU (a TPU serialises the
    scatter).  ``sparse=True`` takes :func:`_sparse_frame_grid`."""
    pc_np = pc.cpu().numpy()
    corner = pc_np.min(0)
    dims = ((pc_np.max(0) - corner) / res).astype(np.int32) + 1
    if sparse:
        grid = _sparse_frame_grid(pc, preds_tr, point_idxs, corner, dims, res, num_rots,
                                  pair_chunk=pair_chunk)
    else:
        gshape = tuple(int(np.ceil(d / 8) * 8) for d in dims)
        grid = ppf_vote_dense(
            pc, preds_tr, torch.ones(pc.shape[0], device=pc.device), point_idxs,
            _center(corner, pc), res, torch.from_numpy(dims).to(pc.device), gshape,
            n_rots=num_rots, adaptive=True, pair_chunk=pair_chunk)
        grid = _to_host(grid[: dims[0], : dims[1], : dims[2]])
    return grid, corner, dims


def _to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host array.  From the card it goes through page-locked
    memory, which the copy engine fills several times faster than pageable
    memory: the frame's 46 MB heatmap took 19 ms of a 36 ms heatmap stage
    through pageable memory on an H100 (``scripts/pose_stages.py --frame``)."""
    if t.device.type != "cuda":
        return t.contiguous().numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()


def _encoders(encoders_or_params, device):
    if isinstance(encoders_or_params, dict):
        return load_encoders(encoders_or_params, 9, device)
    return tuple(encoders_or_params)


@torch.no_grad()
def zero_shot_heatmap(depth: np.ndarray, encoders_or_params, cfg,
                      intrinsics: np.ndarray = DEMO_INTRINSICS, n_pairs: int = 5_000_000,
                      num_rots: int = 72, seed: int = 0, predict_fn=None,
                      sparse: Optional[bool] = None, device=None,
                      pair_chunk: int = PAIR_CHUNK) -> HeatmapState:
    """Stages 1-3 on the uint16 millimetre ``depth``.

    ``encoders_or_params`` is a (PointEncoder, PPFEncoder) pair on the
    device or a params tree (``models.convert.load_npz_params``), loaded
    with ``out_dim`` 9.  ``predict_fn(pc, pc_normal, point_idxs)``, when
    given, replaces the network: numpy in, [P, 9] numpy out.  ``sparse``:
    see :func:`frame_heatmap` (``None`` is the dense route).  Runs on
    ``cuda`` unless ``device`` says otherwise."""
    dev = resolve_device(device)
    pin_float32()
    rng = np.random.default_rng(seed)
    clouds = frame_clouds(depth, intrinsics, cfg.res, cfg.knn, rng, dev)
    pc, pc_normal = clouds.high_pc[clouds.lo_idx], clouds.high_normal[clouds.lo_idx]
    point_idxs = sample_pairs(pc, pc_normal, n_pairs, rng)
    if predict_fn is not None:
        preds = torch.as_tensor(np.asarray(predict_fn(
            pc.cpu().numpy(), pc_normal.cpu().numpy(), point_idxs.cpu().numpy()), np.float32),
            device=dev)
    else:
        preds = frame_predictions(*_encoders(encoders_or_params, dev), clouds, point_idxs,
                                  pair_chunk)
    grid, corner, dims = frame_heatmap(pc, preds[:, :2].contiguous(), point_idxs, cfg.res,
                                       num_rots, bool(sparse), pair_chunk)
    return HeatmapState(pc, pc_normal, point_idxs, preds, grid, corner, dims)


def _bce(logits: torch.Tensor, t: torch.Tensor) -> float:
    return float(torch.mean(torch.clamp(logits, min=0) - logits * t
                            + torch.log1p(torch.exp(-torch.abs(logits)))))


@torch.no_grad()
def detect_from_heatmap(hm: HeatmapState, cfg, num_rots: int = 72, angle_tol: float = 2.0,
                        prop_thresh: float = 50.0, contrib_thresh: int = 12, seed: int = 0,
                        nms_radius: float = 0.15, anchor_t: bool = True,
                        plane_u: Optional[Sequence] = None) -> List[Detection]:
    """Stage 4 (notebook cells 9-11): proposals, re-rank, then per proposal
    the back-vote membership at 3·res, the instance mask (points in more
    than ``contrib_thresh`` member pairs), the up axis voted by up to 10 000
    member pairs on a sphere at ``angle_tol``, its sign by the aux logits,
    the mean scale, and (``anchor_t``) the observed-extent box anchor."""
    rng = np.random.default_rng(seed)
    res = cfg.res
    pc, pc_normal, point_idxs = hm.pc, hm.pc_normal, hm.point_idxs
    dev = pc.device
    n = pc.shape[0]
    preds_tr = hm.preds[:, :2]
    preds_up, preds_up_aux, preds_scale = hm.preds[:, 2], hm.preds[:, 4], hm.preds[:, 6:9]

    proposals = extract_proposals_host(hm.grid, hm.corner, res, thresh=prop_thresh)
    proposals = rank_proposals(hm, proposals, res, nms_radius=nms_radius,
                               contrib_thresh=contrib_thresh, plane_u=plane_u)

    sphere_np = fibonacci_sphere(int(4 * np.pi / np.deg2rad(angle_tol))).astype(np.float32)
    sphere = torch.from_numpy(sphere_np).to(dev)
    cos_tol = float(np.cos(np.deg2rad(angle_tol)))
    corner = torch.from_numpy(hm.corner).to(dev)
    dims = torch.from_numpy(hm.dims).to(dev)
    scale_mean = torch.tensor(cfg.scale_mean, dtype=torch.float64, device=dev)
    pc_np = None
    detections: List[Detection] = []
    for T_est, diff in proposals:
        _, pmask = backvote(pc, preds_tr, point_idxs, corner, res, dims, _center(T_est, pc),
                            3 * res, n_rots=num_rots)
        masked = point_idxs[pmask].long()
        if masked.shape[0] == 0:
            continue
        pc_sel = torch.bincount(masked.reshape(-1), minlength=n) > contrib_thresh
        keep = pc_sel[masked[:, 0]] | pc_sel[masked[:, 1]]
        masked = masked[keep]
        if masked.shape[0] < 10:
            continue

        # axis vote over up to 10 000 member pairs
        perm = torch.from_numpy(rng.permutation(masked.shape[0])[:10000]).to(dev)
        cands = rot_vote(pc, preds_up[pmask][keep][perm], masked[perm], n_rots=num_rots)
        best = int(torch.argmax(sphere_bin_count(cands.reshape(-1, 3), sphere, cos_tol)))
        best_up = sphere_np[best]

        # aux disambiguation over the member pairs
        ab = pc[masked[:, 0]] - pc[masked[:, 1]]
        abu = ab / (torch.linalg.norm(ab, dim=-1, keepdim=True) + 1e-7)
        nrm = pc_normal[masked[:, 0]]
        nrm = torch.where((torch.sum(nrm * abu, -1) < 0)[:, None], -nrm, nrm)
        target = (torch.sum(nrm * sphere[best], -1) > 0).to(torch.float32)
        logits = preds_up_aux[pmask][keep]
        up = -best_up if _bce(logits, 1.0 - target) < _bce(logits, target) else best_up

        right = np.array([0, -up[2], up[1]])
        right = right / np.linalg.norm(right)
        R_est = np.stack([right, up, np.cross(right, up)], -1)
        pred_scale = torch.mean(torch.exp(preds_scale[pmask][keep]).double() * scale_mean * 2,
                                0).cpu().numpy()
        mask = pc_sel.cpu().numpy()
        if anchor_t:
            if pc_np is None:
                pc_np = pc.cpu().numpy()
            T_est = anchor_box_t(T_est, R_est, pred_scale, pc_np[mask])
        RT = np.eye(4)
        RT[:3, :3] = R_est * np.linalg.norm(pred_scale)
        RT[:3, 3] = T_est
        detections.append(Detection(T_est, R_est, pred_scale, RT, mask, diff))
    return detections


def zero_shot_detect(depth: np.ndarray, encoders_or_params, cfg,
                     intrinsics: np.ndarray = DEMO_INTRINSICS, n_pairs: int = 5_000_000,
                     num_rots: int = 72, angle_tol: float = 2.0, prop_thresh: float = 50.0,
                     contrib_thresh: int = 12, seed: int = 0, predict_fn=None,
                     nms_radius: float = 0.15, anchor_t: bool = True,
                     sparse: Optional[bool] = None, device=None,
                     plane_u: Optional[Sequence] = None,
                     pair_chunk: int = PAIR_CHUNK) -> List[Detection]:
    """Detections (T, R, scale, RT, instance mask, score) of every object in
    one depth frame: :func:`zero_shot_heatmap` then
    :func:`detect_from_heatmap`.  Runs on ``cuda`` unless ``device`` says
    otherwise."""
    hm = zero_shot_heatmap(depth, encoders_or_params, cfg, intrinsics, n_pairs, num_rots, seed,
                           predict_fn, sparse, device, pair_chunk)
    return detect_from_heatmap(hm, cfg, num_rots=num_rots, angle_tol=angle_tol,
                               prop_thresh=prop_thresh, contrib_thresh=contrib_thresh,
                               seed=seed, nms_radius=nms_radius, anchor_t=anchor_t,
                               plane_u=plane_u)


# the 12 edges of the get_3d_bbox corners, in the order the JAX CLI draws them
CLI_EDGES = ((0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
             (0, 4), (1, 5), (2, 6), (3, 7))
REPO_CKPT = os.path.join(REPO_ROOT, "checkpoints", "bowl_reg")


# the JAX CLI's order of names: the proposal-contrast selection first
CLI_NAMES = ("params_zs", "params_best", "best")


def cli_weights(ckpt: str, params_name: Optional[str] = None,
                names: Sequence[str] = CLI_NAMES) -> dict:
    """The params tree the CLI serves from the checkpoint directory
    ``ckpt``: the first of ``params_name`` (when named) or ``names`` found
    there, each as ``<name>.npz``, else as the reference pair
    ``point_encoder_epoch<name>.pth`` + ``ppf_encoder_epoch<name>.pth``
    (``train/checkpoints.maybe_load_any``).  The repo's own
    ``checkpoints/bowl_reg`` (or a link to it) holds only the JAX
    package's checkpoints; its ``params_zs`` is served from
    ``assets/bowl_reg_params_zs.npz``.  Raises ``FileNotFoundError``
    otherwise."""
    names = [params_name] if params_name else list(names)
    repo = os.path.isdir(ckpt) and os.path.realpath(ckpt) == os.path.realpath(REPO_CKPT)
    for name in names:
        params = maybe_load_any(ckpt, name)
        if params is None and repo and name == "params_zs":
            params = load_npz_params(os.path.join(ASSETS, "bowl_reg_params_zs.npz"))
        if params is not None:
            return params
    raise FileNotFoundError(f"no {' or '.join(n + '.npz' for n in names)} and no reference "
                            f"pair {{point,ppf}}_encoder_epoch<name>.pth of those names under "
                            f"{ckpt}")


def detection_box(d: Detection) -> np.ndarray:
    """The pixels [8, 2] of a detection's unit box (its scale over the
    scale's norm, posed by ``RT``) in the demo camera."""
    bbox3d = get_3d_bbox(d.scale / np.linalg.norm(d.scale), 0)
    return calculate_2d_projections(transform_coordinates_3d(bbox3d, d.RT), DEMO_INTRINSICS)


def draw_detections(img: np.ndarray, dets: Sequence[Detection]) -> np.ndarray:
    """Each detection's :func:`detection_box` drawn on the RGB ``img`` in
    red at thickness 2, in place."""
    for d in dets:
        proj = detection_box(d)
        for i, j in CLI_EDGES:
            draw_line(img, proj[i], proj[j], (255, 0, 0), 2)
    return img


def main(argv=None):
    """Detect every bowl in a depth frame and draw the boxes on its colour
    frame (counterpart of the JAX package's ``python -m
    cppf_tpu.eval.zero_shot``).  Runs on ``cuda`` unless ``--device cpu``.
    Returns (the detections, the drawn RGB image)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", required=True, help="regression-variant checkpoint dir")
    parser.add_argument("--color", default="data/demo/0000_color.png")
    parser.add_argument("--depth", default="data/demo/0000_depth.png")
    parser.add_argument("--out", default="zero_shot_vis.png")
    parser.add_argument("--n_pairs", type=int, default=5000000)
    parser.add_argument("--params_name", default=None,
                        help="weights to load, <ckpt>/<name>.npz or the reference pair "
                             "<ckpt>/{point,ppf}_encoder_epoch<name>.pth (default: the first "
                             "of params_zs, the proposal-contrast selection, params_best, "
                             "best)")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    snap = os.path.join(args.ckpt, "config.yaml")
    cfg = load_config("bowl", snapshot=snap if os.path.exists(snap) else None)
    cfg.cls_bins = False
    params = cli_weights(args.ckpt, args.params_name)

    depth = read_png(args.depth)
    dets = zero_shot_detect(depth, params, cfg, n_pairs=args.n_pairs, device=device)
    print(f"{len(dets)} detections")
    img = np.ascontiguousarray(read_png(args.color)[:, :, :3])
    for d in dets:
        print("T:", d.T, "scale:", d.scale)
    draw_detections(img, dets)
    write_png(args.out, img)
    print(f"wrote {args.out}")
    return dets, img


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, force=True)
    main()
