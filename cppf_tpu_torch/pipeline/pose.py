"""Single-instance 9D pose (counterpart of cppf_tpu/pipeline/pose.py):

    SPRIN features → pair sampling → PPF head → multinomial bin decode
    → center-vote peak → back-vote filter → axis vote on the sphere
    → aux-bit sign → R/T/S assembly

Every branch of the JAX pipeline is ported: the regressed right axis
(``regress_right``, with ``asym_right_votes`` and ``geo_right_sign``), the
second center pass ``asym_center_refine``, the coplanar center filter
``filter_coplanar`` and its vote-preserving form ``coplanar_halfspace``,
the stratified pair sample ``pair_balance``, the separation-weighted center
vote ``pair_sep_power``, the confidence-weighted cone votes
``sharp_axis_votes``, the aligned aux BCE ``aux_align_weight``, the
sub-voxel center ``subvoxel_refine``, the top-K axis decode ``axis_topk``,
the dense-grid center ``center_mode="grid"`` and the laptop plane
override.  Left out: the JAX ``PoseConfig``'s ``up_sym``/``right_sym``,
which its pipeline never reads, and ``pose_f32``, whose float32 pinning the
port always applies (``device.pin_float32``).

On the card the center vote runs through the kernels of
``csrc/vote_hist.cu``: the pairs front ends of ``bound_projections`` and
``refine_window`` (``center_mode="hier"``) or of ``dense_hist``
(``"grid"``), and their votes front ends when ``coplanar_halfspace`` gates
the votes, which only a vote made outside the kernel can be.

Random draws are injectable (:class:`PoseDraws`): JAX and torch give
different numbers from one seed, so a test hands both the same uniforms and
Gumbel noise (``jax.random.categorical`` is ``argmax(logits + gumbel)``).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cppf_tpu_torch.core import threefry
from cppf_tpu_torch.core.geometry import (assemble_rotation, cross, fibonacci_sphere,
                                          orthonormal_right)
from cppf_tpu_torch.core.targets import radial_asymmetry_about
from cppf_tpu_torch.ops.knn import knn_indices
from cppf_tpu_torch.ops.voting import (backvote, center_refine, grid_argmax, ppf_vote_dense,
                                       ppf_vote_peak, rot_vote_sphere_count)
from cppf_tpu_torch.utils import prof

CENTER_MODES = ("hier", "grid")
_STRATA_HASH = 256  # hash-table size of pair_balance's orientation bins (a power of two)
_SCAN_BLOCK = 16  # the base length of XLA's rewrite of a cumulative sum


@dataclass(frozen=True)
class PoseConfig:
    """Static pipeline parameters (the JAX PoseConfig's, less ``up_sym``,
    ``right_sym`` and ``pose_f32``; see the module docstring)."""

    tr_num_bins: int = 32
    rot_num_bins: int = 36
    vote_range: Tuple[float, float] = (0.12, 0.12)
    scale_mean: Tuple[float, float, float] = (0.07, 0.03, 0.07)
    res: float = 4e-3
    knn: int = 60
    regress_right: bool = False
    z_right: bool = False
    num_rots: int = 72
    n_pairs: int = 100000
    rot_subsample: int = 10000
    angle_prec: float = 1.5
    adaptive_voting: bool = False
    grid_shape: Tuple[int, int, int] = (64, 64, 64)
    splat: str = "trilinear"
    # "hier": the branch-and-bound peak (ppf_vote_peak); "grid": the dense
    # histogram (ppf_vote_dense) and its argmax
    center_mode: str = "hier"
    peak_rounds: int = 2
    scale_multiplier: float = 2.0
    filter_coplanar: bool = False
    # coplanar pairs vote only behind their surface: candidates more than
    # halfspace_margin voxels in front of it (toward the camera) are dropped;
    # takes precedence over filter_coplanar
    coplanar_halfspace: bool = False
    halfspace_margin: float = 2.0
    # pair sample stratified by normal orientation, a point weighted
    # 1 / count(its bin)^pair_balance (0: uniform)
    pair_balance: float = 0.0
    # center votes weighted by clip(sep / q75(sep), 0, 1)^pair_sep_power (0: off)
    pair_sep_power: float = 0.0
    # cone votes weighted by the confidence of the pair's angle bins
    sharp_axis_votes: bool = False
    # aux BCE of each pair weighted by |n_canon · axis|
    aux_align_weight: bool = False
    # Gauss-Newton sub-voxel center on the back-vote survivors
    subvoxel_refine: bool = False
    asym_right_votes: bool = False
    asym_center_refine: bool = False
    geo_right_sign: bool = False
    geo_right_dir: str = "cross"
    axis_topk: int = 1
    axis_topk_min_frac: float = 0.2
    # gravity prior on the up axis: only sphere directions within this many
    # degrees of ±up_prior_dir may win its vote (0 = off).  No category
    # config sets it; the SUN RGB-D driver does (eval/sunrgbd_inference.py)
    up_prior_deg: float = 0.0
    up_prior_dir: Tuple[float, float, float] = (0.0, 1.0, 0.0)

    @classmethod
    def from_config(cls, cfg, n_pairs: Optional[int] = None, scale_multiplier: float = 2.0):
        g = cfg.resolved_grid_edge()
        return cls(
            tr_num_bins=cfg.tr_num_bins, rot_num_bins=cfg.rot_num_bins,
            vote_range=tuple(cfg.vote_range), scale_mean=tuple(cfg.scale_mean),
            res=cfg.res, knn=cfg.knn, regress_right=cfg.regress_right, z_right=cfg.z_right,
            num_rots=cfg.num_rots, n_pairs=n_pairs or cfg.infer_pairs,
            angle_prec=cfg.angle_prec, adaptive_voting=cfg.adaptive_voting,
            grid_shape=(g, g, g), scale_multiplier=scale_multiplier,
            filter_coplanar=cfg.filter_coplanar, asym_right_votes=cfg.asym_right_votes,
            asym_center_refine=cfg.asym_center_refine, geo_right_sign=cfg.geo_right_sign,
            geo_right_dir=cfg.geo_right_dir, axis_topk=cfg.axis_topk,
            coplanar_halfspace=cfg.coplanar_halfspace, pair_balance=cfg.pair_balance,
            pair_sep_power=cfg.pair_sep_power, sharp_axis_votes=cfg.sharp_axis_votes,
            aux_align_weight=cfg.aux_align_weight, subvoxel_refine=cfg.subvoxel_refine,
        )

    def __post_init__(self):
        if self.center_mode not in CENTER_MODES:
            raise ValueError(f"center_mode must be one of {CENTER_MODES}, got {self.center_mode!r}")

    def sphere_points(self) -> np.ndarray:
        n = int(4 * np.pi / (self.angle_prec / 180 * np.pi))
        return fibonacci_sphere(n).astype(np.float32)


class AxisDraws(NamedTuple):
    sub_u: torch.Tensor   # [rot_subsample] uniforms of the pair subsample (pose.py:327)
    gumbel: torch.Tensor  # [rot_subsample, rot_num_bins] angle-bin noise (pose.py:332)


class PoseDraws(NamedTuple):
    """Every random number the pipeline consumes."""

    pair_u: torch.Tensor           # [n_pairs, 2] pair-sampling uniforms (pose.py:439)
    tr_gumbel: torch.Tensor        # [2, n_pairs, tr_num_bins] translation decodes (:546-547)
    up: AxisDraws                  # the up-axis vote
    fallback_normal: torch.Tensor  # [3] degenerate-right fallback (pose.py:743)
    jitter: Optional[torch.Tensor] = None  # [N_raw, 3] preprocess jitter, standard normal
    right: Optional[AxisDraws] = None      # the right-axis vote, with ``regress_right``

    def to(self, device) -> "PoseDraws":
        def axis(d):
            return None if d is None else AxisDraws(*(t.to(device) for t in d))

        return PoseDraws(self.pair_u.to(device), self.tr_gumbel.to(device), axis(self.up),
                         self.fallback_normal.to(device),
                         None if self.jitter is None else self.jitter.to(device),
                         axis(self.right))

    @classmethod
    def sample(cls, pcfg: PoseConfig, generator: torch.Generator, device,
               n_raw: Optional[int] = None) -> "PoseDraws":
        """Draws in the order of JAX's key splits: pairs, translation, up,
        right (only with ``regress_right``), fallback."""
        def rand(*shape):
            return torch.rand(shape, generator=generator, device=device)

        def gumbel(*shape):
            # jax.random.gumbel: -log(-log(U)), U uniform on [tiny, 1)
            u = torch.clamp(rand(*shape), min=torch.finfo(torch.float32).tiny)
            return -torch.log(-torch.log(u))

        def axis():
            return AxisDraws(rand(s), gumbel(s, pcfg.rot_num_bins))

        p, s = pcfg.n_pairs, pcfg.rot_subsample
        jitter = (None if n_raw is None else
                  torch.randn((n_raw, 3), generator=generator, device=device))
        pair_u, tr_gumbel, up = rand(p, 2), gumbel(2, p, pcfg.tr_num_bins), axis()
        right = axis() if pcfg.regress_right else None
        return cls(pair_u, tr_gumbel, up, torch.randn(3, generator=generator, device=device),
                   jitter, right)

    @classmethod
    def from_jax_key(cls, pcfg: PoseConfig, key, device, n_raw: int) -> "PoseDraws":
        """The draws that the JAX ``CategoryRunner.estimate(key, ...)``
        consumes (cppf_tpu/eval/nocs_inference.py:105, pipeline/pose.py:794,
        :533, :544, :315), remade in torch from ``key`` (two uint32 words,
        ``jax.random.key_data``); the preprocess jitter is for ``n_raw``
        padded points."""
        return cls.from_jax_keys(pcfg, *threefry.split((int(key[0]), int(key[1]))), device,
                                 n_raw)

    @classmethod
    def from_jax_keys(cls, pcfg: PoseConfig, pre_key, pose_key, device,
                      n_raw: int) -> "PoseDraws":
        """The draws of a preprocess key and a pose key taken apart, as
        ``CategoryRunner.estimate_batch`` takes them from one split: the
        jitter for ``n_raw`` padded points from ``pre_key``, every pose draw
        from ``pose_key`` (cppf_tpu/eval/nocs_inference.py:169-178)."""
        rng_pairs, rng_vote = threefry.split((int(pose_key[0]), int(pose_key[1])))
        with prof.span("draws"):
            return cls.from_jax_vote_key(pcfg, rng_vote, device, pairs_key=rng_pairs,
                                         pre_key=pre_key, n_raw=n_raw)

    @classmethod
    def from_jax_vote_key(cls, pcfg: PoseConfig, vote_key, device, pairs_key=None,
                          pre_key=None, n_raw: Optional[int] = None) -> "PoseDraws":
        """The draws that the JAX ``vote_pose(vote_key, ...)`` consumes
        (cppf_tpu/pipeline/pose.py:533-547); the pair uniforms from
        ``pairs_key`` (else none: ``vote_pose`` takes its pairs given) and
        the jitter for ``n_raw`` padded points from ``pre_key`` (else
        none)."""
        rng_tr, rng_up, rng_right, rng_fallback = threefry.split(
            (int(vote_key[0]), int(vote_key[1])), 4)
        p, s = pcfg.n_pairs, pcfg.rot_subsample
        requests = [("normal", rng_fallback, (3,))]
        requests += [("gumbel", k, (p, pcfg.tr_num_bins)) for k in threefry.split(rng_tr)]
        for k in (rng_up, rng_right) if pcfg.regress_right else (rng_up,):
            rng_bin, rng_sub = threefry.split(k)
            requests += [("uniform", rng_sub, (s,)), ("gumbel", rng_bin, (s, pcfg.rot_num_bins))]
        if pairs_key is not None:
            requests.append(("uniform", (int(pairs_key[0]), int(pairs_key[1])), (p, 2)))
        if pre_key is not None:
            requests.append(("normal", (int(pre_key[0]), int(pre_key[1])), (n_raw, 3)))
        fallback, tr0, tr1, *rest = threefry.draw_many(requests, device)
        n_axes = 4 if pcfg.regress_right else 2
        axes, rest = rest[:n_axes], rest[n_axes:]
        pair_u = rest.pop(0) if pairs_key is not None else torch.empty((0, 2), device=device)
        jitter = rest.pop(0) if pre_key is not None else None
        right = AxisDraws(*axes[2:]) if pcfg.regress_right else None
        return cls(pair_u, torch.stack([tr0, tr1]), AxisDraws(*axes[:2]), fallback, jitter, right)


class PoseResult(NamedTuple):
    T: torch.Tensor           # [3] center
    R: torch.Tensor           # [3, 3] rotation (orthonormal columns)
    scale: torch.Tensor       # [3] absolute per-axis scale
    RT: torch.Tensor          # [4, 4] with R·|scale| convention of the eval
    scale_unit: torch.Tensor  # scale / |scale|
    up: torch.Tensor
    right: torch.Tensor
    n_filtered: torch.Tensor  # pairs surviving the back-vote
    grid_max: torch.Tensor


def _masked_mean(x, mask, dim=None, reduce_fn=None):
    """Mean of ``x`` over the entries ``mask`` keeps (1 where it keeps
    none).  ``reduce_fn``, when given, sums the numerator and the count
    over ranks first (one call on both): the mean over every rank's pairs."""
    m = mask.to(x.dtype)
    while m.dim() < x.dim():
        m = m[..., None]
    if dim is None:
        num, den = torch.sum(x * m), torch.sum(m)
    else:
        num, den = torch.sum(x * m, dim), torch.sum(m, dim)
    if reduce_fn is not None:
        both = reduce_fn(torch.cat([num.reshape(-1), den.reshape(-1)]))
        num, den = both[:num.numel()].reshape(num.shape), both[num.numel():].reshape(den.shape)
    return num / torch.clamp(den, min=1.0)


def _bce_logits(logits, targets, mask, reduce_fn=None):
    """BCE-with-logits, mean over the masked entries (of every rank's,
    with ``reduce_fn``)."""
    loss = (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))
    return _masked_mean(loss, mask, reduce_fn=reduce_fn)


def cumsum_xla(x: torch.Tensor) -> torch.Tensor:
    """Prefix sums of the float32 vector ``x`` in the order of XLA's CPU
    ``jnp.cumsum``, so equal to its results to the bit, on any device:
    blocks of 16 summed left to right, the blocks' totals scanned the same
    way, each total added to the running sums of the blocks after it.  A
    CDF that searchsorted inverts then picks JAX's indices; a running or a
    float64 sum rounds otherwise in the last bit, and a uniform on a step
    then takes the neighbour."""
    n = x.shape[0]
    m = -(-n // _SCAN_BLOCK)
    rows = torch.nn.functional.pad(x, (0, m * _SCAN_BLOCK - n)).reshape(m, _SCAN_BLOCK)
    for j in range(1, _SCAN_BLOCK):
        rows[:, j] += rows[:, j - 1]
    if m > 1:
        rows[1:] += cumsum_xla(rows[:, -1])[:-1, None]
    return rows.reshape(-1)[:n]


def _axis_subsample(pair_mask, pair_weights, sub_u) -> torch.Tensor:
    """[S] indices of the pairs whose cone votes an axis takes: ``sub_u``
    inverted through the CDF of the surviving pairs (all pairs when none
    survives), weighted by ``pair_weights``."""
    any_alive = pair_mask.any()
    keep = (pair_mask | ~any_alive).to(torch.float32)
    if pair_weights is None:
        cdf = torch.cumsum(keep, 0)  # whole numbers: exact in any order
    else:
        cdf = cumsum_xla(keep * pair_weights)
    u = sub_u * cdf[-1]
    return torch.clamp(torch.searchsorted(cdf, u, right=True), 0, pair_mask.shape[0] - 1)


def _axis_angles(angle_logits, gumbel, pcfg: PoseConfig, dtype):
    """(decoded cone angles of the rows of ``angle_logits`` on their Gumbel
    noise, the cosine tolerance of the sphere bins)."""
    bin_idx = torch.argmax(angle_logits + gumbel, -1)
    angles = bin_idx.to(dtype) / (pcfg.rot_num_bins - 1) * math.pi
    cos_tol = torch.cos(torch.deg2rad(torch.tensor(pcfg.angle_prec, dtype=dtype)))
    return angles, cos_tol.item()


def _aux_sign(pc, pc_normal, point_idxs, aux_logits, aux_mask, reduce_fn=None,
              align_weight: bool = False):
    """``signed_bce(cand)`` → (±cand, its BCE): the sign whose aux-bit
    targets (the pair's canonical normal on the side of ``cand``) the
    logits of ``point_idxs``' pairs fit better; ``reduce_fn`` as in
    :func:`_bce_logits`.  With ``align_weight`` (``aux_align_weight``) a
    pair's BCE weighs |n_canon · cand| more."""
    idx = point_idxs.long()
    ab = pc[idx[:, 0]] - pc[idx[:, 1]]
    ab_unit = ab / (torch.linalg.norm(ab, dim=-1, keepdim=True) + 1e-7)
    n_a = pc_normal[idx[:, 0]]
    n_canon = n_a * torch.where(torch.sum(n_a * ab_unit, -1, keepdim=True) < 0, -1.0, 1.0)

    def signed_bce(cand):
        align = torch.sum(n_canon * cand, -1)
        target = (align > 0).to(pc.dtype)
        mask = aux_mask * torch.abs(align) if align_weight else aux_mask
        up_loss = _bce_logits(aux_logits, target, mask, reduce_fn)
        down_loss = _bce_logits(aux_logits, 1.0 - target, mask, reduce_fn)
        return torch.where(down_loss < up_loss, -cand, cand), torch.minimum(up_loss, down_loss)

    return signed_bce


def _pick_axis(counts, sphere_pts, pcfg: PoseConfig, signed_bce, prior_gate=None):
    """The axis from the sphere counts: the argmax signed by
    ``signed_bce``, or with ``axis_topk`` K > 1 the best-scoring of the K
    distinct peaks (greedy 20° suppression over both hemispheres) among
    those holding ``axis_topk_min_frac`` of the top peak's count.
    ``prior_gate`` [n_sphere] bool marks the directions that may win."""
    if prior_gate is not None:
        counts = torch.where(prior_gate, counts, -1.0)
    if pcfg.axis_topk <= 1:
        prof.host_sync(counts.device)  # indexing by a 0-d tensor reads it
        return signed_bce(sphere_pts[torch.argmax(counts)])[0]

    # indexing by a 0-d tensor reads it: twice a candidate, and the winner
    prof.host_sync(counts.device, n=2 * pcfg.axis_topk + 1)
    cos_sup = torch.cos(torch.deg2rad(torch.tensor(20.0, dtype=sphere_pts.dtype)))
    cand_idx = []
    c = counts
    for _ in range(pcfg.axis_topk):
        i = torch.argmax(c)
        cand_idx.append(i)
        c = torch.where(torch.abs(sphere_pts @ sphere_pts[i]) > cos_sup, -1.0, c)
    cand_idx = torch.stack(cand_idx)
    cand_counts = counts[cand_idx]
    signed, bce = zip(*(signed_bce(sphere_pts[i]) for i in cand_idx))
    ok = cand_counts >= pcfg.axis_topk_min_frac * cand_counts[0]
    bce = torch.where(ok, torch.stack(bce), math.inf)
    return torch.stack(signed)[torch.argmin(bce)]


def sharp_weights(angle_logits) -> torch.Tensor:
    """``sharp_axis_votes``' weight of each row of angle-bin logits: the
    largest softmax probability rescaled so that a uniform distribution
    weighs 0 and a one-hot one 1."""
    probs = torch.softmax(angle_logits, -1)
    uniform = 1.0 / angle_logits.shape[-1]
    return torch.clamp((probs.amax(-1) - uniform) / (1.0 - uniform), 0.0, 1.0)


def _vote_axis(pc, pc_normal, point_idxs, pair_mask, angle_logits, aux_logits, sphere_pts,
               pcfg: PoseConfig, draws: AxisDraws, pair_weights=None,
               prior_gate=None) -> torch.Tensor:
    """One orientation axis: subsample surviving pairs, decode their angle
    bins, cone-vote on the sphere, flip the argmax by the aux-bit BCE.

    ``pair_weights`` [P] biases the subsample and weights the aux BCE (see
    the JAX PoseConfig.asym_right_votes); ``axis_topk`` and ``prior_gate``
    as in :func:`_pick_axis`; ``sharp_axis_votes`` weights the cone votes
    by :func:`sharp_weights`, ``aux_align_weight`` the aux BCE by the
    alignment with the candidate."""
    sub = _axis_subsample(pair_mask, pair_weights, draws.sub_u)
    angles_sub, cos_tol = _axis_angles(angle_logits[sub], draws.gumbel, pcfg, pc.dtype)
    vote_w = sharp_weights(angle_logits[sub]) if pcfg.sharp_axis_votes else None
    counts = rot_vote_sphere_count(pc, angles_sub, point_idxs[sub], sphere_pts, cos_tol,
                                   n_rots=pcfg.num_rots, weights=vote_w)
    aux_mask = pair_mask.to(pc.dtype)
    if pair_weights is not None:
        aux_mask = aux_mask * pair_weights
    return _pick_axis(counts, sphere_pts, pcfg,
                      _aux_sign(pc, pc_normal, point_idxs, aux_logits, aux_mask,
                                align_weight=pcfg.aux_align_weight), prior_gate)


def up_prior_gate(sphere_pts, pcfg: PoseConfig):
    """[n_sphere] bool: the directions within ``up_prior_deg`` of
    ±``up_prior_dir``, in float32 as JAX computes it; None when the prior
    is off."""
    if pcfg.up_prior_deg <= 0:
        return None
    prior_dir = torch.tensor(pcfg.up_prior_dir, dtype=sphere_pts.dtype, device=sphere_pts.device)
    cos_max = torch.cos(torch.deg2rad(torch.tensor(pcfg.up_prior_deg, dtype=sphere_pts.dtype)))
    prof.host_sync(sphere_pts.device, n=2)  # prior_dir, and cos_max below
    return torch.abs(torch.sum(sphere_pts * prior_dir, -1)) >= cos_max.to(sphere_pts.device)


def _protrusion_centroid(pc, T_est, up, n_valid, asym):
    """Radial-asymmetry-weighted centroid direction about the (T, up) line,
    projected off the axis.  Returns (h_dir, gate): ``gate`` is False when
    the protruding geometry is occluded (no asymmetry mass)."""
    w_pt = torch.where(torch.arange(pc.shape[0], device=pc.device) < n_valid, asym, 0.0)
    cen = torch.sum(w_pt[:, None] * (pc - T_est), 0)
    cen = cen - torch.dot(cen, up) * up
    cen_n = torch.linalg.norm(cen)
    h_dir = cen / (cen_n + 1e-9)
    gate = (cen_n > 1e-6) & (torch.sum(w_pt) > 1.0)
    return h_dir, gate


def sample_pair_indices(pair_u: torch.Tensor, n_valid, pc_normal=None,
                        pair_balance: float = 0.0) -> torch.Tensor:
    """[n_pairs, 2] pair sample over the valid points from the uniforms
    ``pair_u`` (cppf_tpu pipeline/pose.py:420-454): uniform, or with
    ``pair_balance`` α > 0 stratified by orientation.  A point's normal,
    its sign folded to make its largest component positive, falls in one of
    5³ bins (components rounded to halves, hashed to 256 slots), and the
    point weighs 1 / count(its bin)^α; the uniforms are inverted through the
    CDF of those weights, summed as JAX sums it (:func:`cumsum_xla`)."""
    if pair_balance <= 0:
        return torch.minimum((pair_u * n_valid).to(torch.int32), n_valid - 1)
    n = pc_normal.shape[0]
    valid = (torch.arange(n, device=pc_normal.device) < n_valid).to(pc_normal.dtype)
    lead = torch.argmax(torch.abs(pc_normal), -1)
    sign = torch.sign(pc_normal.gather(1, lead[:, None])[:, 0])
    nrm = pc_normal * torch.where(sign == 0, 1.0, sign)[:, None]
    q = torch.round(nrm * 2.0).to(torch.int32)
    h = ((q[:, 0] * 25 + q[:, 1] * 5 + q[:, 2]) & (_STRATA_HASH - 1)).long()
    counts = torch.zeros(_STRATA_HASH, dtype=pc_normal.dtype,
                         device=pc_normal.device).index_add_(0, h, valid)
    w = valid / torch.clamp(counts[h], min=1.0) ** pair_balance
    cdf = cumsum_xla(w)
    idx = torch.searchsorted(cdf, pair_u * cdf[-1], right=True).to(torch.int32)
    return torch.clamp(idx, 0, n - 1)


def pair_predictions(point_encoder, ppf_encoder, pc, pc_normal, n_valid, pcfg: PoseConfig,
                     pair_u: torch.Tensor, nbr_idx=None):
    """Network half: SPRIN features, pair sample, PPF head.
    Returns (point_idxs [P, 2] int32, preds [P, out_dim])."""
    with prof.span("pose.network"):
        valid_mask = torch.arange(pc.shape[0], device=pc.device) < n_valid
        nbr = nbr_idx if nbr_idx is not None else knn_indices(pc, pcfg.knn, valid_mask)
        feat = point_encoder(pc, pc_normal, nbr, valid_mask)
        point_idxs = sample_pair_indices(pair_u, n_valid, pc_normal, pcfg.pair_balance)
        return point_idxs, ppf_encoder(pc, pc_normal, feat, point_idxs)


def decode_translation(preds, tr_gumbel, pcfg: PoseConfig) -> torch.Tensor:
    """Multinomial decode of the two translation bins → preds_tr [P, 2] =
    (proj_len, odist)."""
    B = pcfg.tr_num_bins
    v0, v1 = pcfg.vote_range
    tr_logits = preds[:, : 2 * B].reshape(-1, 2, B)
    idx0 = torch.argmax(tr_logits[:, 0] + tr_gumbel[0], -1)
    idx1 = torch.argmax(tr_logits[:, 1] + tr_gumbel[1], -1)
    proj_len = idx0.to(preds.dtype) / (B - 1) * 2 * v0 - v0
    odist = idx1.to(preds.dtype) / (B - 1) * v1
    return torch.stack([proj_len, odist], -1)


def grid_frame(pc, valid_mask, pcfg: PoseConfig):
    """(corner [3], grid_dims [3] int32): the vote grid's world origin and
    runtime extent from the valid points' bounding box, capped at the static
    grid shape."""
    res = torch.tensor(pcfg.res, dtype=pc.dtype, device=pc.device)
    corner = torch.where(valid_mask[:, None], pc, 1e9).amin(0)
    top = torch.where(valid_mask[:, None], pc, -1e9).amax(0)
    grid_dims = ((top - corner) / res).to(torch.int32) + 1
    cap = torch.tensor(pcfg.grid_shape, dtype=torch.int32, device=pc.device)
    prof.host_sync(pc.device, n=2)  # res and cap
    return corner, torch.minimum(grid_dims, cap)


def _coplanar(pc, pc_normal, point_idxs):
    """(coplanar [P] bool, n1 [P, 3], a [P, 3]): a pair is coplanar when its
    normals are parallel and both ⟂ its axis (its vote circle also hits the
    center mirrored across the shared plane)."""
    idx = point_idxs.long()
    n1 = pc_normal[idx[:, 0]]
    n2 = pc_normal[idx[:, 1]]
    a = pc[idx[:, 0]]
    ab = a - pc[idx[:, 1]]
    abu = ab / (torch.linalg.norm(ab, dim=-1, keepdim=True) + 1e-7)
    coplanar = ((torch.abs(torch.sum(n1 * n2, -1)) > 0.9)
                & (torch.abs(torch.sum(abu * n1, -1)) < 0.1)
                & (torch.abs(torch.sum(abu * n2, -1)) < 0.1))
    return coplanar, n1, a


def coplanar_center_mask(pc, pc_normal, point_idxs) -> torch.Tensor:
    """[P] bool center-vote mask of ``filter_coplanar``: False for a
    coplanar pair (:func:`_coplanar`), unless that would keep under 5 % of
    the pairs, when every pair votes."""
    keep = ~_coplanar(pc, pc_normal, point_idxs)[0]
    return keep | (torch.mean(keep.to(pc.dtype)) < 0.05)


def quantile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q`` quantile of the vector ``x``, interpolated linearly between
    its sorted neighbours with jnp.quantile's arithmetic."""
    xs = torch.sort(x).values
    pos = torch.tensor(q, dtype=x.dtype) * torch.tensor(x.shape[0] - 1, dtype=x.dtype)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    prof.host_sync(x.device, n=2)  # the uploads of low_w and high_w
    return xs[int(low)] * low_w.to(x.device) + xs[int(high)] * high_w.to(x.device)


def halfspace_gate(pc, pc_normal, point_idxs, pcfg: PoseConfig):
    """``coplanar_halfspace``'s gate (a [P, 3], n_out [P, 3], coplanar [P]
    bool, margin): each pair's first normal turned toward the camera at the
    origin, so that a coplanar pair votes only where (cand − a)·n_out ≤
    halfspace_margin · res, behind its surface."""
    coplanar, n1, a = _coplanar(pc, pc_normal, point_idxs)
    n_out = torch.where(torch.sum(n1 * a, -1, keepdim=True) > 0, -n1, n1)
    margin = torch.tensor(pcfg.halfspace_margin * pcfg.res, dtype=pc.dtype, device=pc.device)
    prof.host_sync(pc.device)
    return a, n_out, coplanar, margin


def center_vote_masks(pc, pc_normal, point_idxs, pcfg: PoseConfig):
    """What gates the center votes of the pairs ``point_idxs`` (all of
    them: the 5 % guard and the separation quantile read every pair):
    (center_mask [P] bool or float weights, or None for every pair;
    base_mask [P] bool of ``filter_coplanar``, or None; the
    ``coplanar_halfspace`` gate, or None)."""
    base_mask = halfspace = None
    if pcfg.coplanar_halfspace:
        halfspace = halfspace_gate(pc, pc_normal, point_idxs, pcfg)
    elif pcfg.filter_coplanar:
        base_mask = coplanar_center_mask(pc, pc_normal, point_idxs)
    center_mask = base_mask
    if pcfg.pair_sep_power > 0:
        idx = point_idxs.long()
        sep = torch.linalg.norm(pc[idx[:, 0]] - pc[idx[:, 1]], dim=-1)
        sep_ref = quantile_linear(sep, 0.75)
        sep_w = torch.clamp(sep / torch.clamp(sep_ref, min=1e-6), 0.0, 1.0)
        sep_w = sep_w ** pcfg.pair_sep_power
        center_mask = sep_w if base_mask is None else base_mask * sep_w
    return center_mask, base_mask, halfspace


class PairStages(NamedTuple):
    """The steps of :func:`decode_pose` that read every pair, as functions
    of what they are given (the rest is per-point or replicated):

    - ``center_peak(weights [N])`` → (T [3], peak) of the center vote;
    - ``consistent_pairs(T)`` → [P] bool back-vote mask of every pair;
    - ``refine_center(T, pair_mask)`` → the sub-voxel T of
      ``subvoxel_refine`` from the back-vote survivors ``pair_mask`` [P]
      (those ``filter_coplanar`` keeps);
    - ``vote_axis(pair_mask, angle_logits, aux_logits, draws, pair_weights,
      prior_gate)`` → axis [3], the logits being columns of ``preds``;
    - ``scale_mean(scale_pred, pair_mask)`` → [3] mean log-scale of the
      surviving pairs.

    :func:`vote_pose` makes them over all pairs on one device;
    ``parallel/pose.py`` over each rank's share of the pairs."""

    center_peak: Callable
    consistent_pairs: Callable
    refine_center: Callable
    vote_axis: Callable
    scale_mean: Callable


def vote_pose(pc, pc_normal, point_idxs, preds, n_valid, sphere_pts, pcfg: PoseConfig,
              draws: PoseDraws, laptop_up=None, laptop_up_valid=None,
              up_gate=None) -> PoseResult:
    """Voting half: decode pair predictions into a 9D pose (no network).
    ``up_gate`` as in :func:`decode_pose`.

    Where a gate thins the center vote (``filter_coplanar``,
    ``coplanar_halfspace``, ``pair_sep_power``) the span
    ``pose.center_gate`` holds its making, and under a profiler the device
    counters ``center_pairs_gated`` and ``center_pairs_voting`` add, each
    center pass, the pairs the gate reads and those it lets vote (a nonzero
    weight; every pair under ``coplanar_halfspace``, which thins votes)."""
    valid_mask = torch.arange(pc.shape[0], device=pc.device) < n_valid
    preds_tr = decode_translation(preds, draws.tr_gumbel, pcfg)
    res = torch.tensor(pcfg.res, dtype=pc.dtype, device=pc.device)
    prof.host_sync(pc.device)
    corner, grid_dims = grid_frame(pc, valid_mask, pcfg)
    gated = pcfg.filter_coplanar or pcfg.coplanar_halfspace or pcfg.pair_sep_power > 0
    voting = None
    with prof.span("pose.center_gate") if gated else contextlib.nullcontext():
        center_mask, base_mask, halfspace = center_vote_masks(pc, pc_normal, point_idxs, pcfg)
        if gated and prof.recording():
            voting = (point_idxs.shape[0] if center_mask is None
                      else torch.count_nonzero(center_mask))

    vote_kw = dict(n_rots=pcfg.num_rots, adaptive=pcfg.adaptive_voting, splat=pcfg.splat,
                   pair_mask=center_mask, halfspace=halfspace)

    def center_peak(weights):
        if voting is not None:
            prof.device_count("center_pairs_gated", point_idxs.shape[0])
            prof.device_count("center_pairs_voting", voting)
        if pcfg.center_mode == "grid":
            grid = ppf_vote_dense(pc, preds_tr, weights, point_idxs, corner, res, grid_dims,
                                  pcfg.grid_shape, **vote_kw)
            return grid_argmax(grid, corner, res), grid.max()
        peak_idx, peak = ppf_vote_peak(pc, preds_tr, weights, point_idxs, corner, res,
                                       grid_dims, pcfg.grid_shape, max_rounds=pcfg.peak_rounds,
                                       **vote_kw)
        return corner + peak_idx.to(pc.dtype) * pcfg.res, peak

    def consistent_pairs(center):
        return backvote(pc, preds_tr, point_idxs, corner, res, grid_dims, center,
                        3.0 * pcfg.res, n_rots=pcfg.num_rots)[1]

    def refine_center(center, pair_mask):
        mask = pair_mask if base_mask is None else pair_mask & base_mask
        return center_refine(pc, preds_tr, point_idxs, center, mask, res)

    def vote_axis(pair_mask, angle_logits, aux_logits, axis_draws, pair_weights=None,
                  prior_gate=None):
        return _vote_axis(pc, pc_normal, point_idxs, pair_mask, angle_logits, aux_logits,
                          sphere_pts, pcfg, axis_draws, pair_weights, prior_gate)

    def scale_mean(scale_pred, pair_mask):
        return _masked_mean(scale_pred, pair_mask, dim=0)

    stages = PairStages(center_peak, consistent_pairs, refine_center, vote_axis, scale_mean)
    return decode_pose(pc, point_idxs, preds, n_valid, sphere_pts, pcfg, draws, stages,
                       laptop_up, laptop_up_valid, up_gate)


def decode_pose(pc, point_idxs, preds, n_valid, sphere_pts, pcfg: PoseConfig,
                draws: PoseDraws, stages: PairStages, laptop_up=None,
                laptop_up_valid=None, up_gate=None) -> PoseResult:
    """The pose from the center vote, the back-vote mask and the axis votes
    of ``stages``; the branches run in the order of the JAX
    ``_vote_pose_body``.  ``point_idxs`` [P, 2] are every pair; ``preds``
    the rows that ``stages`` read (all of them on one device).  ``up_gate``
    is :func:`up_prior_gate` of ``sphere_pts`` and ``pcfg`` made before (a
    runner keeps its own); None makes it here."""
    n = pc.shape[0]
    B, R = pcfg.tr_num_bins, pcfg.rot_num_bins
    up_logits = preds[:, 2 * B: 2 * B + R]
    right_logits = preds[:, 2 * B + R: 2 * B + 2 * R]
    up_aux = preds[:, -5]
    right_aux = preds[:, -4]
    scale_pred = preds[:, -3:]
    probs = torch.ones(n, dtype=pc.dtype, device=pc.device)

    # --- center voting ------------------------------------------------------
    with prof.span("pose.center_vote", **{"pass": 1}):
        T_est, grid_max = stages.center_peak(probs)
    with prof.span("pose.backvote"):
        pair_mask = stages.consistent_pairs(T_est)
    if pcfg.subvoxel_refine:
        T_est = stages.refine_center(T_est, pair_mask)

    # --- orientation axes ---------------------------------------------------
    with prof.span("pose.axis_vote", axis="up"):
        up = stages.vote_axis(pair_mask, up_logits, up_aux, draws.up,
                              prior_gate=(up_prior_gate(sphere_pts, pcfg) if up_gate is None
                                          else up_gate))

    if pcfg.asym_center_refine:
        # second center pass on the protruding points' votes; only its
        # component along the protrusion direction is taken
        asym_c = radial_asymmetry_about(pc, T_est, up, n_valid)
        with prof.span("pose.center_vote", **{"pass": 2}):
            T_ref, _ = stages.center_peak((0.05 + 0.95 * asym_c) * probs)
        u_h, gate = _protrusion_centroid(pc, T_est, up, n_valid, asym_c)
        T_est = torch.where(gate, T_est + torch.dot(T_ref - T_est, u_h) * u_h, T_est)
        with prof.span("pose.backvote"):
            pair_mask = stages.consistent_pairs(T_est)
        if pcfg.subvoxel_refine:
            T_est = stages.refine_center(T_est, pair_mask)

    if pcfg.regress_right:
        right_w = asym = None
        if pcfg.asym_right_votes or pcfg.geo_right_sign:
            asym = radial_asymmetry_about(pc, T_est, up, n_valid)
        if pcfg.asym_right_votes:
            idx = point_idxs.long()
            right_w = 0.05 + 0.95 * torch.maximum(asym[idx[:, 0]], asym[idx[:, 1]])
        with prof.span("pose.axis_vote", axis="right"):
            right = stages.vote_axis(pair_mask, right_logits, right_aux, draws.right,
                                     pair_weights=right_w)
        if pcfg.geo_right_sign:
            h_dir, gate = _protrusion_centroid(pc, T_est, up, n_valid, asym)
            ref_dir = h_dir if pcfg.geo_right_dir == "direct" else cross(h_dir, up)
            right = torch.where(gate & (torch.dot(right, ref_dir) < 0), -right, right)
        right = orthonormal_right(up, right)
    else:
        right = torch.stack([torch.zeros_like(up[0]), -up[2], up[1]])
        right = right / (torch.linalg.norm(right) + 1e-9)

    if laptop_up is not None:
        # the laptop plane override: ``laptop_up`` is the base-plane normal
        # oriented toward the camera; it replaces up whenever it lines up
        # with up no better than with right
        lv = (torch.tensor(True, device=pc.device) if laptop_up_valid is None
              else torch.as_tensor(laptop_up_valid, device=pc.device))
        if not (torch.is_tensor(laptop_up_valid) and laptop_up_valid.device == pc.device):
            prof.host_sync(pc.device)
        lup = laptop_up.to(pc.dtype)
        swap = (torch.dot(up, lup) < torch.abs(torch.dot(right, lup))) & lv
        up, right = (torch.where(swap, lup, up),
                     torch.where(swap, orthonormal_right(lup, up), right))

    # degenerate right fallback
    degen = torch.linalg.norm(right) < 1e-7
    right = torch.where(degen, orthonormal_right(up, draws.fallback_normal), right)
    R_est = assemble_rotation(up, right, pcfg.z_right)

    # --- scale --------------------------------------------------------------
    scale_mean = torch.tensor(pcfg.scale_mean, dtype=pc.dtype, device=pc.device)
    prof.host_sync(pc.device)
    pred_scale = (torch.exp(stages.scale_mean(scale_pred, pair_mask)) * scale_mean
                  * pcfg.scale_multiplier)
    scale_norm = torch.linalg.norm(pred_scale)
    RT = torch.eye(4, dtype=pc.dtype, device=pc.device)
    RT[:3, :3] = R_est * scale_norm
    RT[:3, 3] = T_est
    return PoseResult(T=T_est, R=R_est, scale=pred_scale, RT=RT,
                      scale_unit=pred_scale / scale_norm, up=up, right=right,
                      n_filtered=pair_mask.sum(), grid_max=grid_max)


@torch.no_grad()
def estimate_pose(point_encoder, ppf_encoder, pc, pc_normal, n_valid, sphere_pts,
                  pcfg: PoseConfig, nbr_idx=None, draws: Optional[PoseDraws] = None,
                  generator: Optional[torch.Generator] = None, laptop_up=None,
                  laptop_up_valid=None, up_gate=None) -> PoseResult:
    """Single-instance 9D pose.  pc/pc_normal: [N, 3] padded, valid points
    compacted to the front; ``n_valid`` real points.  Draws come from
    ``draws`` when given, else from ``generator``.  ``laptop_up`` [3]
    (with ``laptop_up_valid``, default True) is the laptop plane override;
    ``up_gate`` as in :func:`decode_pose`."""
    if draws is None:
        draws = PoseDraws.sample(pcfg, generator, pc.device)
    point_idxs, preds = pair_predictions(point_encoder, ppf_encoder, pc, pc_normal, n_valid,
                                         pcfg, draws.pair_u, nbr_idx)
    return vote_pose(pc, pc_normal, point_idxs, preds, n_valid, sphere_pts, pcfg, draws,
                     laptop_up, laptop_up_valid, up_gate)


@torch.no_grad()
def estimate_pose_batch(point_encoder, ppf_encoder, pcs, pc_normals, n_valids, sphere_pts,
                        pcfg: PoseConfig, draws, nbr_idxs) -> PoseResult:
    """:func:`estimate_pose` of each instance of ``pcs`` [B, N, 3] on its own
    ``draws[i]`` and ``nbr_idxs[i]``, one after another, as the JAX
    ``lax.map`` runs them (cppf_tpu/pipeline/pose.py:804-839); the fields
    come back stacked [B, ...]."""
    rows = [estimate_pose(point_encoder, ppf_encoder, pcs[i], pc_normals[i], n_valids[i],
                          sphere_pts, pcfg, nbr_idx=nbr_idxs[i], draws=d)
            for i, d in enumerate(draws)]
    return PoseResult(*(torch.stack(f) for f in zip(*rows)))
