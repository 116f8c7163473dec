"""Hough voting (counterpart of cppf_tpu/ops/voting.py, main-path part).

Each function keeps the JAX function's arguments and its order of
operations, so that on the CPU the two agree to float rounding: candidate
math stays componentwise ([P, R] arrays per axis), scalars are divided as
0-d tensors (torch's ``scalar / tensor`` multiplies by a reciprocal, which
rounds differently), and cross products are written out in XLA's term
order.

The center-vote peak (:func:`ppf_vote_peak`) and the dense histogram
(:func:`ppf_vote_dense`) run their accumulation passes through
:mod:`cppf_tpu_torch.ops.vote_hist`: hand-written CUDA kernels for CUDA
tensors, their plain versions for CPU tensors.  So does the axis vote's
sphere count (:func:`rot_vote_sphere_count`).
"""
from __future__ import annotations

from typing import Tuple

import torch

from cppf_tpu_torch.core.geometry import cross
from cppf_tpu_torch.ops.vote_hist import (bound_projections, bound_projections_pairs,
                                          dense_hist, dense_hist_pairs, refine_window,
                                          refine_window_pairs, sphere_count, vote_frame)
from cppf_tpu_torch.utils import prof

TWO_PI = 6.283185307179586
_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}  # same-width integers


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    if not (torch.is_tensor(x) and x.device == like.device):
        prof.host_sync(like.device)  # an upload
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def pair_frames(pc: torch.Tensor, point_idxs: torch.Tensor):
    """Per-pair geometry: (a, ab_unit, degenerate_mask, co_unit), ``co_unit``
    the normalised (0, −âb.z, âb.y), or (−âb.y, âb.x, 0) when âb ≈ ±x."""
    idx = point_idxs.long()
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


def _adaptive_rots(odist, res, n_rots: int, adaptive: bool):
    if adaptive:
        return torch.clamp((odist / res * TWO_PI).to(torch.int32), max=n_rots)
    return torch.full(odist.shape, n_rots, dtype=torch.int32, device=odist.device)


def _circle(m, n_rots: int, like: torch.Tensor):
    """(cos, sin) [P, R] of the sample angles i·(2π/m) and rot_valid [P, R]."""
    i = torch.arange(n_rots, dtype=like.dtype, device=like.device)
    step = _scalar(TWO_PI, like) / torch.clamp(m, min=1).to(like.dtype)
    angle = i[None, :] * step[:, None]
    return torch.cos(angle), torch.sin(angle), i[None, :] < m[:, None]


def pair_vote_params(pc, preds_tr, probs, point_idxs, res, n_rots: int, adaptive: bool,
                     pair_mask) -> torch.Tensor:
    """Everything a pair's votes derive from, as one contiguous [P, 12]
    block of ``pc``'s type (float32 for the kernels: 48 bytes a pair, three
    16-byte loads):

    ====== =================================================================
    column
    ====== =================================================================
    0      weight ``max(probs[a], probs[b])``, times a float ``pair_mask``;
           0 for a degenerate pair or one a bool ``pair_mask`` drops
    1      rotation count ``m`` (:func:`_adaptive_rots`), integer bits
    2-4    circle center ``c = a − âb·proj_len``
    5-7    ``x = co_unit·odist``
    8-10   ``y = x × âb``
    11     0
    ====== =================================================================

    Vote ``i < m`` of the pair is ``c + cos(i·2π/m)·x + sin(i·2π/m)·y``
    (:func:`votes_from_pair_params`).  ``res`` is a 0-d tensor or a number."""
    res = _scalar(res, pc)
    a, ab_unit, degenerate, co_unit = pair_frames(pc, point_idxs)
    proj_len, odist = preds_tr[:, 0], preds_tr[:, 1]
    m = _adaptive_rots(odist, res, n_rots, adaptive)

    c = a - ab_unit * proj_len[:, None]
    x = co_unit * odist[:, None]
    y = cross(x, ab_unit)

    idx = point_idxs.long()
    w = torch.maximum(probs[idx[:, 0]], probs[idx[:, 1]])
    keep = ~degenerate
    if pair_mask.dtype == torch.bool:
        keep = keep & pair_mask
    else:
        w = w * pair_mask
    w = torch.where(keep, w, 0.0)
    # assembled as integers so that the copy cannot touch the bits of m
    bits = _BITS[pc.dtype]
    cols = [w[:, None], c, x, y, torch.zeros_like(w)[:, None]]
    block = torch.cat([cols[0].view(bits), m.to(bits)[:, None]]
                      + [t.contiguous().view(bits) for t in cols[1:]], 1)
    return block.view(pc.dtype)


def votes_from_pair_params(params, corner, res, dims_f, grid_shape, n_rots: int,
                           halfspace=None):
    """The [P, R] half of :func:`_vote_coords`: every vote of every pair of
    a :func:`pair_vote_params` block.  The pairs front ends of the vote
    kernels do this arithmetic in registers, in this operation order; this
    is their plain version.  Returns (f, r, w) as :func:`_vote_coords`."""
    res = _scalar(res, params)
    w = params[:, 0]
    m = params[:, 1].view(_BITS[params.dtype]).to(torch.int32)
    c, x, y = params[:, 2:5], params[:, 5:8], params[:, 8:11]
    cos_a, sin_a, valid = _circle(m, n_rots, params)

    if halfspace is not None:
        a_ref, n_ref, hs_gate, hs_margin = halfspace
        hdot = torch.zeros_like(cos_a)
        for k in range(3):
            ck = c[:, k, None] + cos_a * x[:, k, None] + sin_a * y[:, k, None]
            hdot = hdot + (ck - a_ref[:, k, None]) * n_ref[:, k, None]
        valid = valid & (~hs_gate[:, None] | (hdot <= hs_margin))

    fcomp, rcomp = [], []
    for k in range(3):
        gk = (c[:, k, None] + cos_a * x[:, k, None] + sin_a * y[:, k, None]
              - corner[k]) / res
        dk = torch.clamp(dims_f[k], max=grid_shape[k])
        valid = valid & (gk >= 0.01) & (gk < dk - 1.01)
        fk = torch.clamp(torch.floor(gk).to(torch.int32), 0, grid_shape[k] - 2)
        fcomp.append(fk)
        rcomp.append(gk - fk)
    wv = torch.where(valid, w[:, None], 0.0)
    return fcomp, rcomp, wv


def _vote_coords(pc, preds_tr, probs, point_idxs, corner, res, dims_f, grid_shape,
                 n_rots, adaptive, pair_mask, halfspace=None):
    """Componentwise voxel coordinates of every vote (cppf_tpu ops/voting.py
    :67-135).  Returns (f, r, w): three int32 [P, R] floors clipped to
    [0, g-2], three f32 [P, R] fractions, and [P, R] weights with every
    validity mask folded in as zeros.  ``halfspace = (a_ref [P,3], n_ref
    [P,3], gate [P] bool, margin)`` keeps, for gated pairs, only candidates
    with (cand − a_ref)·n_ref ≤ margin."""
    params = pair_vote_params(pc, preds_tr, probs, point_idxs, res, n_rots, adaptive,
                              pair_mask)
    return votes_from_pair_params(params, corner, res, dims_f, grid_shape, n_rots,
                                  halfspace=halfspace)


def ppf_vote(pc, preds_tr, probs, point_idxs, corner, res, grid_dims,
             grid_shape: Tuple[int, int, int], n_rots: int = 72, adaptive: bool = False,
             pair_mask=None, splat: str = "trilinear", halfspace=None) -> torch.Tensor:
    """Dense center-vote grid [gx, gy, gz] by ``index_add_`` — the oracle for
    the peak kernels (cppf_tpu ops/voting.py:177-233)."""
    gx, gy, gz = grid_shape
    if pair_mask is None:
        pair_mask = torch.ones(point_idxs.shape[0], dtype=torch.bool, device=pc.device)
    (fx, fy, fz), (rx, ry, rz), wv = _vote_coords(
        pc, preds_tr, probs, point_idxs, corner, res, grid_dims.to(pc.dtype), grid_shape,
        n_rots, adaptive, pair_mask, halfspace=halfspace)
    grid = torch.zeros(gx * gy * gz, dtype=torch.float32, device=pc.device)
    if splat == "nearest":
        nx, ny, nz = (torch.where(r > 0.5, f + 1, f).long() for f, r in
                      ((fx, rx), (fy, ry), (fz, rz)))
        grid.index_add_(0, ((nx * gy + ny) * gz + nz).reshape(-1), wv.reshape(-1))
        return grid.view(gx, gy, gz)
    base = ((fx.long() * gy + fy) * gz + fz).reshape(-1)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                wk = ((rx if dx else 1.0 - rx) * (ry if dy else 1.0 - ry)
                      * (rz if dz else 1.0 - rz)) * wv
                grid.index_add_(0, base + (dx * gy * gz + dy * gz + dz), wk.reshape(-1))
    return grid.view(gx, gy, gz)


def ppf_vote_dense(pc, preds_tr, probs, point_idxs, corner, res, grid_dims,
                   grid_shape: Tuple[int, int, int], n_rots: int = 72, adaptive: bool = False,
                   pair_mask=None, splat: str = "trilinear",
                   pool: Tuple[int, int, int] = (1, 1, 1),
                   pair_chunk: int = 1 << 20, halfspace=None) -> torch.Tensor:
    """Dense vote histogram [ceil(gx/px), ceil(gy/py), ceil(gz/pz)] through
    :func:`dense_hist_pairs` (cppf_tpu ops/voting.py:527-585): with ``pool``
    (1,1,1) it is :func:`ppf_vote`'s grid, else that grid pool-summed exactly.

    Unlike the JAX function, pairs go ``pair_chunk`` at a time: each chunk's
    :func:`pair_vote_params` block (48 bytes a pair) is added into one grid
    by one ``dense_hist_pairs`` launch, which makes the votes in registers,
    so no [P, R] vote vector exists on the card.  On the CPU the plain
    version makes them (``votes_from_pair_params``) a chunk at a time.

    ``halfspace`` (per-pair rows, as :func:`_vote_coords`) gates the votes
    before they are summed, which the pairs front end cannot: a chunk's
    votes are then made by :func:`votes_from_pair_params` and summed by the
    votes front end, :func:`dense_hist`."""
    cx, cy, cz = (-(-g // p) for g, p in zip(grid_shape, pool))
    out = torch.zeros((cx, cy, cz), dtype=torch.float32, device=pc.device)
    dims_f = grid_dims.to(pc.dtype)
    frame = vote_frame(corner, res, dims_f)
    kw = dict(cx=cx, cy=cy, cz=cz, px=pool[0], py=pool[1], pz=pool[2], splat=splat, out=out)
    for s in range(0, point_idxs.shape[0], pair_chunk):
        sl = slice(s, s + pair_chunk)
        mask = (torch.ones(point_idxs[sl].shape[0], dtype=torch.bool, device=pc.device)
                if pair_mask is None else pair_mask[sl])
        params = pair_vote_params(pc, preds_tr[sl], probs, point_idxs[sl], res, n_rots,
                                  adaptive, mask)
        if halfspace is None:
            dense_hist_pairs(params, frame, n_rots=n_rots, grid_shape=grid_shape, **kw)
            continue
        hs = (halfspace[0][sl], halfspace[1][sl], halfspace[2][sl], halfspace[3])
        f, r, w = votes_from_pair_params(params, corner, res, dims_f, grid_shape, n_rots,
                                         halfspace=hs)
        dense_hist(*(a.reshape(-1) for a in (*f, *r, w)), **kw)
    return out


def _maxpool2d(m: torch.Tensor, fa: int, fb: int) -> torch.Tensor:
    """Max over non-overlapping fa×fb blocks, zero-padding ragged edges."""
    a, b = m.shape
    ca, cb = -(-a // fa), -(-b // fb)
    m = torch.nn.functional.pad(m, (0, cb * fb - b, 0, ca * fa - a))
    return m.reshape(ca, fa, cb, fb).amax((1, 3))


def _poolf(g: int) -> int:
    """Power-of-two pool factor that keeps a projection axis ≤ 64 bins."""
    p = 1
    while g > 64 * p:
        p *= 2
    return p


def ppf_vote_peak(pc, preds_tr, probs, point_idxs, corner, res, grid_dims,
                  grid_shape: Tuple[int, int, int], n_rots: int = 72, adaptive: bool = False,
                  pair_mask=None, splat: str = "trilinear", window: int = 16,
                  coarse_factor: int = 8, max_rounds: int = 0, bound_dtype: str = "float32",
                  halfspace=None, reduce_fn=None):
    """Argmax and max of the :func:`ppf_vote` grid without building the grid
    (cppf_tpu ops/voting.py:280-524), by branch-and-bound:

    On a CUDA tensor (and without ``halfspace``) both passes take the pairs
    front ends of the kernels, which make each vote in registers from
    :func:`pair_vote_params`; else the votes of :func:`_vote_coords` are
    built once and go through the votes front ends (``LAUNCHES`` says which).

    1. ``bound_projections`` accumulates the 2D projections Mxy/Mxz/Myz
       (y/z columns pooled to ≤ 64 bins); every voxel of a coarse
       ``coarse_factor``³ cell is bounded by the min of their block maxima.
    2. Refine rounds: ``refine_window`` counts the exact fine mass in the
       ``window``³ box, window-aligned, around the best uncovered cell; the
       covered cells drop out; repeat while an uncovered bound beats the
       best voxel and fewer than ``max_rounds`` rounds ran (0 = no cap).

    The loop condition reads one scalar to the host a round, so
    ``max_rounds=2`` costs at most two syncs.  Ties go to the first maximum
    (``argmax``).  Bounds are float32 sums and need no inflation, so
    ``bound_dtype`` accepts only "float32".  Returns (idx [3] int32, peak).

    ``reduce_fn`` (default: none) is applied to every sum over votes: to
    each of Mxy, Mxz, Myz after the bound pass and to each window.  With the
    pairs split over ranks, an all-reduce there gives every rank the sums of
    all pairs (``parallel/mesh.py::sharded_ppf_vote_peak``); it must give
    every rank the same bits, since the loop's host read of ``bnd.max() >
    best`` decides each rank's control flow.
    """
    if bound_dtype != "float32":
        raise ValueError(f"bound_dtype must be 'float32', got {bound_dtype!r}")
    if window % coarse_factor or window < coarse_factor:
        raise ValueError("window must be a positive multiple of coarse_factor")
    dev = pc.device
    gx, gy, gz = grid_shape
    f8, w8 = coarse_factor, window
    cx_n, cy_n, cz_n = (-(-g // f8) for g in grid_shape)
    if pair_mask is None:
        pair_mask = torch.ones(point_idxs.shape[0], dtype=torch.bool, device=dev)

    # ---- bound pass ---------------------------------------------------------
    pfy, pfz = _poolf(gy), _poolf(gz)
    if f8 % pfy or f8 % pfz:
        raise ValueError(f"pool factors ({pfy}, {pfz}) must divide coarse_factor {f8}")
    by_n, bz_n = -(-gy // pfy), -(-gz // pfz)
    bound_kw = dict(by_n=by_n, bz_n=bz_n, pfy=pfy, pfz=pfz, splat=splat)
    dims_f = grid_dims.to(pc.dtype)
    if dev.type == "cuda" and halfspace is None:
        # pairs front ends: the kernels make the votes, no [P, R] tensor exists
        params = pair_vote_params(pc, preds_tr, probs, point_idxs, res, n_rots, adaptive,
                                  pair_mask)
        frame = vote_frame(corner, res, dims_f)
        pairs_kw = dict(n_rots=n_rots, grid_shape=grid_shape)
        mxy, mxz, myz = bound_projections_pairs(params, frame, **pairs_kw, **bound_kw)

        def refine(o):
            return refine_window_pairs(o, params, frame, **pairs_kw, w8=w8, splat=splat)
    else:
        # votes front ends: the CPU's plain versions, and the half-space gate
        fcomp, rcomp, wv = _vote_coords(pc, preds_tr, probs, point_idxs, corner, res, dims_f,
                                        grid_shape, n_rots, adaptive, pair_mask,
                                        halfspace=halfspace)
        votes = [a.reshape(-1) for a in (*fcomp, *rcomp, wv)]
        mxy, mxz, myz = bound_projections(*votes, gx=gx, gy=gy, **bound_kw)

        def refine(o):
            return refine_window(o, *votes, w8=w8, splat=splat)

    if reduce_fn is not None:
        mxy, mxz, myz = reduce_fn(mxy), reduce_fn(mxz), reduce_fn(myz)

    bnd = torch.minimum(
        torch.minimum(_maxpool2d(mxy, f8, f8 // pfy)[:, :, None],
                      _maxpool2d(mxz, f8, f8 // pfz)[:, None, :]),
        _maxpool2d(myz, f8, f8 // pfz)[None, :, :])

    # ---- refine loop --------------------------------------------------------
    round_cap = max_rounds if max_rounds > 0 else cx_n * cy_n * cz_n
    cells = [torch.arange(n, dtype=torch.int32, device=dev) * f8 for n in (cx_n, cy_n, cz_n)]
    best = torch.tensor(float("-inf"), device=dev)
    prof.host_sync(dev)
    bidx = torch.zeros(3, dtype=torch.int32, device=dev)
    rounds = 0
    while rounds < round_cap:
        prof.host_sync(dev)
        if not bool(bnd.max() > best):
            break
        cflat = torch.argmax(bnd)
        cell = torch.stack([cflat // (cy_n * cz_n), (cflat // cz_n) % cy_n,
                            cflat % cz_n]).to(torch.int32)
        o = (cell * f8) // w8 * w8  # window-aligned: covers whole cells
        win = refine(o)
        if reduce_fn is not None:
            win = reduce_fn(win)
        wflat = torch.argmax(win)
        local = torch.stack([wflat // (w8 * w8), (wflat // w8) % w8,
                             wflat % w8]).to(torch.int32)
        prof.host_sync(dev)  # indexing by a 0-d tensor reads it
        wmax = win.reshape(-1)[wflat]
        better = wmax > best
        best = torch.where(better, wmax, best)
        bidx = torch.where(better, o + local, bidx)
        full = [(c >= o[k]) & (c + f8 <= o[k] + w8) for k, c in enumerate(cells)]
        covered = full[0][:, None, None] & full[1][None, :, None] & full[2][None, None, :]
        bnd = torch.where(covered, float("-inf"), bnd)
        rounds += 1
    prof.annotate(rounds=rounds)
    return bidx, torch.clamp(best, min=0.0)


def grid_argmax(grid: torch.Tensor, corner: torch.Tensor, res) -> torch.Tensor:
    """World coordinates of the highest-vote voxel (first maximum)."""
    flat_idx = torch.argmax(grid)
    gy, gz = grid.shape[1], grid.shape[2]
    ijk = torch.stack([flat_idx // (gy * gz), (flat_idx % (gy * gz)) // gz, flat_idx % gz])
    return corner + ijk.to(grid.dtype) * res


def backvote(pc, preds_tr, point_idxs, corner, res, grid_dims, pred_center, tol,
             n_rots: int = 72, chunk: int = 1 << 18):
    """Center-consistency filter (cppf_tpu ops/voting.py:599-668): sweep each
    pair's (always adaptive) vote circle; a pair hits when some in-grid sample
    lies within ``tol`` of ``pred_center``.  Pairs go ``chunk`` at a time
    (the [chunk, n_rots] temporaries stay ~1 GB on a 5 M-pair frame; a pose's
    100 000 pairs are one chunk).  Returns (offsets [P,3], the negated offset
    of the first hit or zeros; mask [P] bool)."""
    res = _scalar(res, pc)
    dims_f = grid_dims.to(pc.dtype)
    parts = [_backvote_chunk(pc, preds_tr[s:s + chunk], point_idxs[s:s + chunk], corner, res,
                             dims_f, pred_center, tol, n_rots)
             for s in range(0, max(point_idxs.shape[0], 1), chunk)]
    return torch.cat([o for o, _ in parts]), torch.cat([h for _, h in parts])


def _backvote_chunk(pc, preds_tr, point_idxs, corner, res, dims_f, pred_center, tol,
                    n_rots: int):
    a, ab_unit, degenerate, co_unit = pair_frames(pc, point_idxs)
    proj_len, odist = preds_tr[:, 0], preds_tr[:, 1]
    m = _adaptive_rots(odist, res, n_rots, adaptive=True)
    c = a - ab_unit * proj_len[:, None]
    y_unit = cross(co_unit, ab_unit)
    cos_a, sin_a, rot_valid = _circle(m, n_rots, pc)

    in_bounds = rot_valid & (~degenerate)[:, None]
    dist2 = torch.zeros_like(cos_a)
    offs = []
    for k in range(3):
        off_k = (cos_a * (co_unit[:, k] * odist)[:, None]
                 + sin_a * (y_unit[:, k] * odist)[:, None])
        center_k = c[:, k, None] + off_k
        gk = (center_k - corner[k]) / res
        in_bounds = in_bounds & (gk >= 0.0) & (gk < dims_f[k] - 1.0)
        d = center_k - pred_center[k]
        dist2 = dist2 + d * d
        offs.append(off_k)
    hit = in_bounds & (dist2 <= tol * tol)
    any_hit = hit.any(-1)
    first = torch.argmax(hit.to(torch.uint8), -1, keepdim=True)
    off = -torch.stack([o.gather(1, first)[:, 0] for o in offs], -1)
    return torch.where(any_hit[:, None], off, 0.0), any_hit


def circle_support(pc, preds_tr, point_idxs, pred_center, tol,
                   chunk: int = 1 << 20) -> torch.Tensor:
    """Exact center-consistency mask, the continuous form of :func:`backvote`
    (cppf_tpu ops/voting.py:780-820): a pair hits when the analytic
    distance ``√(axial² + (radial − |odist|)²)`` from ``pred_center`` to its
    vote circle is ≤ ``tol``; degenerate pairs never hit.  Returns [P] bool."""
    out = []
    for s in range(0, max(point_idxs.shape[0], 1), chunk):
        a, ab_unit, degenerate, _ = pair_frames(pc, point_idxs[s:s + chunk])
        tr = preds_tr[s:s + chunk]
        c = a - ab_unit * tr[:, 0:1]
        v = pred_center[None, :] - c
        axial = torch.sum(v * ab_unit, -1)
        radial = torch.linalg.norm(v - axial[:, None] * ab_unit, dim=-1)
        dist2 = axial * axial + (radial - torch.abs(tr[:, 1])) ** 2
        out.append((dist2 <= tol * tol) & ~degenerate)
    return torch.cat(out)


def rot_vote(pc, preds_rot, point_idxs, n_rots: int = 72, chunk: int = 1 << 16) -> torch.Tensor:
    """Candidate axes [P, n_rots, 3] (cppf_tpu ops/voting.py:823-866): each
    pair's ``normalize(tan ψ · offset ± âb)`` on a cone around âb; zeros for
    degenerate pairs."""
    i = torch.arange(n_rots, dtype=pc.dtype, device=pc.device)
    angle = i * (TWO_PI / n_rots)
    cos_a, sin_a = torch.cos(angle), torch.sin(angle)
    out = []
    for s in range(0, max(point_idxs.shape[0], 1), chunk):
        _, ab_unit, degenerate, co_unit = pair_frames(pc, point_idxs[s:s + chunk])
        y = cross(co_unit, ab_unit)
        offset = cos_a[None, :, None] * co_unit[:, None, :] + sin_a[None, :, None] * y[:, None, :]
        t = torch.tan(preds_rot[s:s + chunk])
        sign_ab = torch.where(t > 0, 1.0, -1.0)[:, None] * ab_unit
        up = t[:, None, None] * offset + sign_ab[:, None, :]
        up = up / (torch.linalg.norm(up, dim=-1, keepdim=True) + 1e-7)
        out.append(torch.where(degenerate[:, None, None], 0.0, up))
    return torch.cat(out)


def sphere_bin_count(candidates, sphere_pts, cos_tol, chunk: int = 8192) -> torch.Tensor:
    """Count the candidate axes [M, 3] within ``cos_tol`` of each sphere
    direction (cppf_tpu ops/voting.py:932-962), one [chunk, S] cosine
    product at a time.  Returns float32 [S]."""
    sph_t = sphere_pts.T.to(torch.float32)
    counts = torch.zeros(sphere_pts.shape[0], dtype=torch.float32, device=sphere_pts.device)
    for s in range(0, candidates.shape[0], chunk):
        cos = candidates[s:s + chunk].to(torch.float32) @ sph_t
        counts += (cos > cos_tol).to(torch.float32).sum(0)
    return counts


def cone_table(n_rots: int, like: torch.Tensor) -> torch.Tensor:
    """(cos, sin) [2, n_rots] of the cone's sample angles i·2π/n_rots."""
    i = torch.arange(n_rots, dtype=like.dtype, device=like.device)
    ang = i * (TWO_PI / n_rots)
    return torch.stack([torch.cos(ang), torch.sin(ang)])


def sphere_pair_params(pc, preds_rot, point_idxs, weights=None) -> torch.Tensor:
    """Everything a pair's cone axes derive from, as one contiguous [P, 12]
    block of ``pc``'s type (float32 for the kernel: three 16-byte loads):
    columns 0-2 ``co_unit``, 3 ``t = tan ψ``, 4-6 ``y_unit = co_unit × âb``,
    7 1 for a degenerate pair else 0, 8-10 ``sign(t)·âb``, 11 the weight (0
    without ``weights``).  Axis ``r`` of the pair is ``t·(cos a_r·co +
    sin a_r·y) + sign(t)·âb``, normalised (:func:`rot_vote_sphere_count_plain`)."""
    _, ab_unit, degenerate, co_unit = pair_frames(pc, point_idxs)
    y_unit = cross(co_unit, ab_unit)
    t = torch.tan(preds_rot)
    sign = torch.where(t > 0, 1.0, -1.0)
    w = torch.zeros_like(t) if weights is None else weights.to(t.dtype)
    return torch.cat([co_unit, t[:, None], y_unit, degenerate.to(t.dtype)[:, None],
                      sign[:, None] * ab_unit, w[:, None]], 1)


def rot_vote_sphere_count(pc, preds_rot, point_idxs, sphere_pts, cos_tol, n_rots: int = 72,
                          chunk: int = 1024, weights=None) -> torch.Tensor:
    """Cone-vote axis candidates binned on the sphere (cppf_tpu ops/voting.py
    :869-929): each pair's ``n_rots`` unit axes normalize(tan ψ·offset ± âb)
    count toward every sphere direction within ``cos_tol``; degenerate pairs
    cast the zero axis.  ``weights`` [P] scales each pair's votes
    (``sharp_axis_votes``' confidences).

    On CPU tensors :func:`rot_vote_sphere_count_plain`.  On CUDA tensors the
    pairs' vectors (:func:`sphere_pair_params`) are made once and one kernel
    launch (``vote_hist.sphere_count``) makes every axis in registers and
    counts it: no [P·n_rots, S] tensor exists.  Its counts equal the plain
    version's to the bit (weighted: within a fixed-point unit a hit);
    ``chunk`` is the plain version's."""
    if pc.device.type == "cpu":
        return rot_vote_sphere_count_plain(pc, preds_rot, point_idxs, sphere_pts, cos_tol,
                                           n_rots=n_rots, chunk=chunk, weights=weights)
    return sphere_count(sphere_pair_params(pc, preds_rot, point_idxs, weights),
                        cone_table(n_rots, pc), sphere_pts.to(torch.float32).contiguous(),
                        cos_tol, weighted=weights is not None)


def rot_vote_sphere_count_plain(pc, preds_rot, point_idxs, sphere_pts, cos_tol,
                                n_rots: int = 72, chunk: int = 1024,
                                weights=None) -> torch.Tensor:
    """Plain version of :func:`rot_vote_sphere_count`: componentwise per
    chunk of pairs, each chunk's [chunk·n_rots, S] cosines in memory."""
    s0, s1, s2 = (sphere_pts[:, k].to(torch.float32) for k in range(3))
    i = torch.arange(n_rots, dtype=pc.dtype, device=pc.device)
    ang = i * (TWO_PI / n_rots)
    cos_a, sin_a = torch.cos(ang), torch.sin(ang)
    counts = torch.zeros(sphere_pts.shape[0], dtype=torch.float32, device=pc.device)
    for s in range(0, point_idxs.shape[0], chunk):
        _, ab_unit, degenerate, co_unit = pair_frames(pc, point_idxs[s:s + chunk])
        y_unit = cross(co_unit, ab_unit)
        t = torch.tan(preds_rot[s:s + chunk])
        sign = torch.where(t > 0, 1.0, -1.0)
        comps = [t[:, None] * (cos_a[None, :] * co_unit[:, k, None]
                               + sin_a[None, :] * y_unit[:, k, None])
                 + (sign * ab_unit[:, k])[:, None] for k in range(3)]
        norm = torch.sqrt(comps[0] * comps[0] + comps[1] * comps[1]
                          + comps[2] * comps[2]) + 1e-7
        ok = (~degenerate)[:, None]
        ux, uy, uz = (torch.where(ok, cmp / norm, 0.0).reshape(-1) for cmp in comps)
        cos = ux[:, None] * s0[None, :] + uy[:, None] * s1[None, :] + uz[:, None] * s2[None, :]
        hits = (cos > cos_tol).to(torch.float32)
        if weights is not None:
            wk = weights[s:s + chunk].to(torch.float32).repeat_interleave(n_rots)
            hits = hits * wk[:, None]
        counts += hits.sum(0)
    return counts


# ---- sub-voxel center refinement (cppf_tpu ops/voting.py:671-777) ----------

def center_refine_terms(pc, preds_tr, point_idxs, center, weights, cutoff,
                        chunk: int = 1 << 18):
    """Gauss-Newton normal-equation terms of the sub-voxel center solve: a
    pair (a, b) with (proj_len, odist) puts the center o on a circle,
    ``(a − o)·âb = proj_len`` (axial) and ``‖(a − o) − ((a − o)·âb)âb‖ =
    odist`` (radial); a pair whose residuals' squared sum reaches
    ``cutoff²`` (or a degenerate one) weighs 0.  Pairs go ``chunk`` at a
    time, as :func:`backvote`.  Returns (H [3, 3], g [3], wsum): sums over
    the pairs, so a pair-sharded caller all-reduces them.  The residuals are
    float32, as JAX's; the sums are float64, so that their order (the
    device's, the chunks', the ranks') does not reach the solve."""
    f64 = dict(dtype=torch.float64, device=pc.device)
    H, g, wsum = torch.zeros((3, 3), **f64), torch.zeros(3, **f64), torch.zeros((), **f64)
    for s in range(0, point_idxs.shape[0], chunk):
        a, ab_unit, degenerate, _ = pair_frames(pc, point_idxs[s:s + chunk])
        proj_len, odist = preds_tr[s:s + chunk, 0], preds_tr[s:s + chunk, 1]
        am = a - center
        t = torch.sum(am * ab_unit, -1)
        e_ax = t - proj_len
        r = am - t[:, None] * ab_unit
        rn = torch.linalg.norm(r, dim=-1)
        e_rad = rn - odist
        r_hat = r / (rn + 1e-9)[:, None]
        w = (weights[s:s + chunk] * ~degenerate
             * (e_ax * e_ax + e_rad * e_rad < cutoff * cutoff)).double()
        u, r_hat, e_ax, e_rad = ab_unit.double(), r_hat.double(), e_ax.double(), e_rad.double()
        H = H + (torch.einsum("p,pi,pj->ij", w, u, u)
                 + torch.einsum("p,pi,pj->ij", w, r_hat, r_hat))
        g = g + (torch.einsum("p,p,pi->i", w, e_ax, u)
                 + torch.einsum("p,p,pi->i", w, e_rad, r_hat))
        wsum = wsum + w.sum()
    return H, g, wsum


def center_refine_solve(H, g, wsum, c, min_pairs: float):
    """One damped Gauss-Newton update of the center ``c`` from (reduced)
    normal-equation terms, solved in their type and rounded to ``c``'s;
    ``c`` unchanged where the step is not finite or fewer than
    ``min_pairs`` pairs weigh in."""
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    H = H + 1e-4 * torch.trace(H) * eye + 1e-9
    delta, info = torch.linalg.solve_ex(H, g)
    ok = (info == 0) & torch.isfinite(delta).all() & (wsum >= min_pairs)
    return torch.where(ok, (c + delta).to(c.dtype), c)


def center_refine_cutoffs(res, iters: int, like: torch.Tensor) -> torch.Tensor:
    """The annealed trim radii, from the back-vote band 3·res down to
    0.75·res, of ``like``'s type and device."""
    return (torch.linspace(3.0, 0.75, iters, dtype=like.dtype, device=like.device)
            * _scalar(res, like))


def center_refine_clamp(c, T_init, res):
    """``c`` pulled into the 2·res trust region about the voted peak
    ``T_init``; ``T_init`` where ``c`` is not finite."""
    d = c - T_init
    dn = torch.linalg.norm(d)
    c = T_init + d * torch.clamp(2.0 * _scalar(res, c) / (dn + 1e-9), max=1.0)
    return torch.where(torch.isfinite(c).all(), c, T_init)


def center_refine(pc, preds_tr, point_idxs, T_init, pair_mask, res, iters: int = 3,
                  min_pairs: float = 64.0, reduce_fn=None) -> torch.Tensor:
    """Sub-voxel center (cppf_tpu ops/voting.py:745-777): ``iters``
    Gauss-Newton steps on the circle constraints of the ``pair_mask`` pairs
    (:func:`center_refine_terms`, trimmed at :func:`center_refine_cutoffs`),
    clamped to 2·res about ``T_init``.  ``reduce_fn``, when given, sums the
    terms over ranks each step (one call on H, g and wsum together)."""
    w0 = pair_mask.to(pc.dtype)
    c = T_init
    for cutoff in center_refine_cutoffs(res, iters, pc):
        H, g, wsum = center_refine_terms(pc, preds_tr, point_idxs, c, w0, cutoff)
        if reduce_fn is not None:
            both = reduce_fn(torch.cat([H.reshape(-1), g, wsum.reshape(1)]))
            H, g, wsum = both[:9].reshape(3, 3), both[9:12], both[12]
        c = center_refine_solve(H, g, wsum, c, min_pairs)
    return center_refine_clamp(c, T_init, res)
