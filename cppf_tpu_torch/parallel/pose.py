"""Pair-sharded inference: the whole 9D pose over the ``pair`` ranks of a
:class:`~cppf_tpu_torch.parallel.mesh.PairMesh` (counterpart of
cppf_tpu/parallel/pose.py).

Each rank runs the per-point work (KNN, SPRIN features, the pair sample)
whole, and the pair stages on its own rows of the pairs
(``mesh.shard_rows``): the PPF head, the translation decode, both peak
kernels (``sharded_ppf_vote_peak``: bound projections and windows summed
over the ranks), the back-vote and the cone votes of the subsampled pairs
it holds.  The branches are those of the one-device pose
(``pipeline/pose.py::decode_pose``), run on the rank's
:class:`~cppf_tpu_torch.pipeline.pose.PairStages`.  What the decode reads
of every pair crosses between the ranks as:

- the back-vote mask, all-gathered (a byte a pair): the axis subsample's
  CDF over it is then the one-device CDF, bit for bit;
- the sphere counts of the cone votes (integer sums, exact in float32) and
  each bound projection and window of the center vote, all-reduced;
- the numerator and count of the aux BCEs and of the masked scale mean,
  all-reduced (so these sums differ from one device's by float order).

- the center vote's gates (``center_vote_masks``: the coplanar filter
  with its 5 % guard, the half-space gate, the separation weights from the
  quantile of every pair's separation) are computed over every pair on
  every rank, each rank then taking its rows;
- ``subvoxel_refine``'s normal equations (H [3, 3], g [3], the weight
  sum), all-reduced once a Gauss-Newton step (``sharded_center_refine``);
- ``center_mode="grid"``: the rank's dense grid, all-reduced
  (``sharded_ppf_vote``).

No rank ever holds another's ``[P, out_dim]`` predictions.  The draws
(``PoseDraws``) are the one-device pose's, the same on every rank: from one
JAX key (``PoseDraws.from_jax_key``) the ranks reproduce
``cppf_tpu.parallel.pose.sharded_estimate_pose(mesh, key, ...)``.  Every
flag of the one-device pose runs here.
"""
from __future__ import annotations

import torch

from cppf_tpu_torch.ops.voting import backvote, center_refine, grid_argmax, rot_vote_sphere_count
from cppf_tpu_torch.parallel.mesh import (PairMesh, shard_halfspace, shard_rows,
                                          sharded_ppf_vote, sharded_ppf_vote_peak)
from cppf_tpu_torch.pipeline.pose import (AxisDraws, PairStages, PoseConfig, PoseDraws,
                                          PoseResult, _aux_sign, _axis_angles,
                                          _axis_subsample, _masked_mean, _pick_axis,
                                          center_vote_masks, decode_pose, decode_translation,
                                          grid_frame, pair_predictions, sharp_weights)


def sharded_ppf_head(mesh: PairMesh, ppf_encoder, pc, pc_normal, feat, point_idxs):
    """PPF head predictions [P_rank, out_dim] of this rank's rows of the
    pairs ``point_idxs`` [P, 2] (no collective)."""
    mesh.check(pc, pc_normal, feat, point_idxs)
    return ppf_encoder(pc, pc_normal, feat, point_idxs[shard_rows(point_idxs.shape[0], mesh)])


def sharded_backvote(mesh: PairMesh, pc, preds_tr, point_idxs, corner, res, grid_dims,
                     pred_center, tol, n_rots: int = 72, *, n_pairs: int) -> torch.Tensor:
    """The back-vote mask [n_pairs] bool of every pair: ``backvote`` of this
    rank's rows (``preds_tr``, ``point_idxs``), all-gathered.  The offsets,
    which no caller reads, stay on their ranks."""
    mesh.check(pc, preds_tr, point_idxs, pred_center)
    hit = backvote(pc, preds_tr, point_idxs, corner, res, grid_dims, pred_center, tol,
                   n_rots=n_rots)[1]
    return mesh.gather_rows(hit, n_pairs)


def sharded_center_refine(mesh: PairMesh, pc, preds_tr, point_idxs, T_init, pair_mask, res,
                          iters: int = 3, min_pairs: float = 64.0) -> torch.Tensor:
    """``ops/voting.py::center_refine`` of every rank's pairs: this rank's
    rows (``preds_tr``, ``point_idxs``, ``pair_mask``) give its normal
    equations, and one all-reduce a Gauss-Newton step sums H [3, 3], g [3]
    and the weight sum over the pair group, so that every rank solves the
    same system.  The same T on every rank."""
    mesh.check(pc, preds_tr, point_idxs, T_init, pair_mask)
    return center_refine(pc, preds_tr, point_idxs, T_init, pair_mask, res, iters=iters,
                         min_pairs=min_pairs, reduce_fn=mesh.reduce)


def sharded_sphere_histogram(mesh: PairMesh, pc, angles, sub_idxs, sphere_pts, cos_tol,
                             n_rots: int = 72, weights=None) -> torch.Tensor:
    """Sphere counts [n_sphere] of the cone votes of every rank's
    subsampled pairs: this rank's (``angles``, ``sub_idxs``, ``weights``,
    e.g. ``sharp_axis_votes``' confidences) counted, then summed over the
    pair group."""
    mesh.check(pc, angles, sub_idxs, sphere_pts, weights)
    return mesh.reduce(rot_vote_sphere_count(pc, angles, sub_idxs, sphere_pts, cos_tol,
                                             n_rots=n_rots, weights=weights))


def _vote_axis_sharded(mesh: PairMesh, pc, pc_normal, point_idxs, pair_mask, angle_logits,
                       aux_logits, sphere_pts, pcfg: PoseConfig, draws: AxisDraws,
                       pair_weights=None, prior_gate=None) -> torch.Tensor:
    """``pipeline/pose.py::_vote_axis`` over the ranks: the subsample of
    every pair (``pair_mask``, ``pair_weights``: [P], the same on every
    rank), each rank decoding and cone-voting the subsampled pairs among its
    rows (``angle_logits``, ``aux_logits``: its rows), the counts and the
    BCE sums summed over the ranks."""
    rows = shard_rows(point_idxs.shape[0], mesh)
    sub = _axis_subsample(pair_mask, pair_weights, draws.sub_u)
    own = (sub >= rows.start) & (sub < rows.stop)
    mine = sub[own]
    logits = angle_logits[mine - rows.start]
    angles, cos_tol = _axis_angles(logits, draws.gumbel[own], pcfg, pc.dtype)
    counts = sharded_sphere_histogram(
        mesh, pc, angles, point_idxs[mine], sphere_pts, cos_tol, n_rots=pcfg.num_rots,
        weights=sharp_weights(logits) if pcfg.sharp_axis_votes else None)
    aux_mask = pair_mask[rows].to(pc.dtype)
    if pair_weights is not None:
        aux_mask = aux_mask * pair_weights[rows]
    signed_bce = _aux_sign(pc, pc_normal, point_idxs[rows], aux_logits, aux_mask,
                           reduce_fn=mesh.reduce, align_weight=pcfg.aux_align_weight)
    return _pick_axis(counts, sphere_pts, pcfg, signed_bce, prior_gate)


def sharded_vote_pose(mesh: PairMesh, pc, pc_normal, point_idxs, preds, n_valid, sphere_pts,
                      pcfg: PoseConfig, draws: PoseDraws) -> PoseResult:
    """``vote_pose`` with the pairs split over the ranks: ``point_idxs``
    [P, 2] every pair, ``preds`` this rank's rows of the head's output."""
    n_pairs = point_idxs.shape[0]
    rows = shard_rows(n_pairs, mesh)
    idxs = point_idxs[rows]
    valid_mask = torch.arange(pc.shape[0], device=pc.device) < n_valid
    preds_tr = decode_translation(preds, draws.tr_gumbel[:, rows], pcfg)
    res = torch.tensor(pcfg.res, dtype=pc.dtype, device=pc.device)
    corner, grid_dims = grid_frame(pc, valid_mask, pcfg)
    # the coplanar filter's 5 % guard and the separation quantile read every
    # pair: computed whole on every rank, then cut to the rank's rows
    center_mask, base_mask, halfspace = center_vote_masks(pc, pc_normal, point_idxs, pcfg)
    center_mask = None if center_mask is None else center_mask[rows]
    base_mask = None if base_mask is None else base_mask[rows]
    halfspace = shard_halfspace(halfspace, rows)
    vote_kw = dict(n_rots=pcfg.num_rots, adaptive=pcfg.adaptive_voting, splat=pcfg.splat,
                   pair_mask=center_mask, halfspace=halfspace)

    def center_peak(weights):
        if pcfg.center_mode == "grid":
            grid = sharded_ppf_vote(mesh, pc, preds_tr, weights, idxs, corner, res, grid_dims,
                                    pcfg.grid_shape, **vote_kw)
            return grid_argmax(grid, corner, res), grid.max()
        peak_idx, peak = sharded_ppf_vote_peak(
            mesh, pc, preds_tr, weights, idxs, corner, res, grid_dims, pcfg.grid_shape,
            max_rounds=pcfg.peak_rounds, **vote_kw)
        return corner + peak_idx.to(pc.dtype) * pcfg.res, peak

    def consistent_pairs(center):
        return sharded_backvote(mesh, pc, preds_tr, idxs, corner, res, grid_dims, center,
                                3.0 * pcfg.res, n_rots=pcfg.num_rots, n_pairs=n_pairs)

    def refine_center(center, pair_mask):
        mask = pair_mask[rows] if base_mask is None else pair_mask[rows] & base_mask
        return sharded_center_refine(mesh, pc, preds_tr, idxs, center, mask, res)

    def vote_axis(pair_mask, angle_logits, aux_logits, axis_draws, pair_weights=None,
                  prior_gate=None):
        return _vote_axis_sharded(mesh, pc, pc_normal, point_idxs, pair_mask, angle_logits,
                                  aux_logits, sphere_pts, pcfg, axis_draws, pair_weights,
                                  prior_gate)

    def scale_mean(scale_pred, pair_mask):
        return _masked_mean(scale_pred, pair_mask[rows], dim=0, reduce_fn=mesh.reduce)

    stages = PairStages(center_peak, consistent_pairs, refine_center, vote_axis, scale_mean)
    return decode_pose(pc, point_idxs, preds, n_valid, sphere_pts, pcfg, draws, stages)


@torch.no_grad()
def sharded_estimate_pose(mesh: PairMesh, point_encoder, ppf_encoder, pc, pc_normal, n_valid,
                          sphere_pts, pcfg: PoseConfig, draws: PoseDraws,
                          nbr_idx=None) -> PoseResult:
    """Single-instance 9D pose with the pairs split over the mesh's
    ``pair`` ranks, every argument the same on every rank (as
    ``pipeline/pose.py::estimate_pose``, whose pose it equals up to the
    order of float sums).  Every rank returns the same pose."""
    mesh.check(pc, pc_normal, sphere_pts, draws.pair_u, nbr_idx)

    def head(pc_, pc_normal_, feat, point_idxs):
        return sharded_ppf_head(mesh, ppf_encoder, pc_, pc_normal_, feat, point_idxs)

    point_idxs, preds = pair_predictions(point_encoder, head, pc, pc_normal, n_valid, pcfg,
                                         draws.pair_u, nbr_idx)
    return sharded_vote_pose(mesh, pc, pc_normal, point_idxs, preds, n_valid, sphere_pts, pcfg,
                             draws)
