"""Similarity-transform estimation, Umeyama and RANSAC (numpy copy of
cppf_tpu/eval/alignment.py): the legacy NOCS solver, RANSAC over 5-point
Umeyama fits with automatic thresholds.  No path of the port calls it;
CPPF's own inference votes.  The RANSAC draws come from ``np.random``, as
in the JAX package, so one ``np.random.seed`` gives both the same fits.
"""
from __future__ import annotations

import itertools

import numpy as np

from cppf_tpu_torch.core.geometry import backproject


def umeyama(source: np.ndarray, target: np.ndarray):
    """Closed-form similarity transform source→target (Umeyama 1991).

    source/target: [N, 3] corresponding points.
    Returns (scales [3] uniform, rotation [3,3] — applied as row-vector
    convention ``x @ (s·R)``, translation [3], out_transform [4,4] acting on
    column vectors).  Conventions follow the reference implementation.
    """
    src = np.asarray(source, np.float64)
    tgt = np.asarray(target, np.float64)
    n = src.shape[0]
    mu_s = src.mean(0)
    mu_t = tgt.mean(0)
    cs = src - mu_s
    ct = tgt - mu_t
    cov = ct.T @ cs / n
    if np.isnan(cov).any():
        raise RuntimeError("NaNs in input")
    U, D, Vh = np.linalg.svd(cov, full_matrices=True)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        D[-1] = -D[-1]
        U[:, -1] = -U[:, -1]
    rotation = (U @ Vh).T
    var_s = src.var(0).sum()
    scale = D.sum() / var_s
    scales = np.full(3, scale)
    translation = mu_t - mu_s @ (scale * rotation)
    out = np.eye(4)
    out[:3, :3] = np.diag(scales) @ rotation
    out[:3, 3] = translation
    return scales, rotation, translation, out


def _residual(transform, src_h, tgt_h, thresh):
    diff = tgt_h - transform @ src_h
    per_pt = np.linalg.norm(diff[:3], axis=0)
    inliers = np.where(per_pt < thresh)[0]
    return np.linalg.norm(per_pt), len(inliers) / src_h.shape[1], inliers


def estimate_similarity_transform(source: np.ndarray, target: np.ndarray,
                                  max_iterations: int = 100, verbose: bool = False):
    """RANSAC-robust Umeyama (reference utils/aligning.py:13-44 semantics).

    Returns (scales, rotation, translation, out_transform) or four Nones when
    the inlier ratio stays below 0.1.
    """
    src_h = np.vstack([source.T, np.ones(source.shape[0])])
    tgt_h = np.vstack([target.T, np.ones(target.shape[0])])

    t_norm = np.mean(np.linalg.norm(target, axis=1))
    s_norm = np.mean(np.linalg.norm(source, axis=1))
    pass_t = max(t_norm / s_norm, s_norm / t_norm)
    stop_t = pass_t / 100.0

    best_res = np.inf
    best_ratio = 0.0
    best_inliers = np.arange(source.shape[0])
    for _ in range(max_iterations):
        pick = np.random.randint(source.shape[0], size=5)
        try:
            _, _, _, transform = umeyama(source[pick], target[pick])
        except np.linalg.LinAlgError:
            continue
        res, ratio, inliers = _residual(transform, src_h, tgt_h, pass_t)
        if res < best_res:
            best_res, best_ratio, best_inliers = res, ratio, inliers
        if best_res < stop_t:
            break

    if best_ratio < 0.1:
        if verbose:
            print(f"[ WARN ] low inlier ratio: {best_ratio}")
        return None, None, None, None
    return umeyama(source[best_inliers], target[best_inliers])


def estimate_restricted_affine_transform(source: np.ndarray, target: np.ndarray,
                                         verbose: bool = False):
    """Affine fit decomposed into rotation + per-axis scales
    (reference utils/aligning.py:46-95): least-squares affine, SVD split,
    then the scale permutation with the lowest residual."""
    src_h = np.hstack([source, np.ones((source.shape[0], 1))])
    affine, *_ = np.linalg.lstsq(src_h, target, rcond=None)
    affine = affine.T  # [3,4] acting on column vectors
    translation = affine[:3, 3]
    nu_scale_rot = affine[:3, :3]
    _, scales_sorted, _ = np.linalg.svd(nu_scale_rot, full_matrices=True)

    best = (np.inf, None, None, np.identity(4))
    for cand in itertools.permutations(scales_sorted):
        cand = np.asarray(cand)
        rotation = (np.diag(1.0 / cand) @ nu_scale_rot).T
        transform = np.identity(4)
        transform[:3, :3] = np.diag(cand) @ rotation
        transform[:3, 3] = translation
        fitted = source @ (np.diag(cand) @ rotation).T + translation
        residual = np.linalg.norm(np.linalg.norm(target - fitted, axis=0))
        if residual < best[0]:
            best = (residual, cand, rotation, transform)
    _, scales, rotation, transform = best
    if verbose:
        print("scales:", scales)
    return scales, rotation, translation, transform


def align_nocs(class_ids, masks, coords, depth, intrinsics, synset_names,
               image_path="", if_norm=False, with_scale=True, verbose=False):
    """Legacy NOCS alignment (reference utils/util.py:634-705): per instance,
    RANSAC-Umeyama fit NOCS-map coordinates to backprojected depth points.
    Retained for capability parity; CPPF's own voting inference never calls it.
    """
    num = len(class_ids)
    RTs = np.zeros((num, 4, 4))
    bbox_scales = np.ones((num, 3))
    errors = ""
    for i in range(num):
        mask = masks[:, :, i]
        coord = coords[:, :, i, :]
        abs_coord = np.abs(coord[mask == 1] - 0.5)
        bbox_scales[i] = 2 * np.amax(abs_coord, axis=0)
        pts, idxs = backproject(depth, intrinsics, mask)
        coord_pts = coord[idxs[0], idxs[1], :] - 0.5
        if if_norm:
            s = np.linalg.norm(bbox_scales[i])
            bbox_scales[i] /= s
            coord_pts /= s
        try:
            scales, rotation, translation, _ = estimate_similarity_transform(coord_pts, pts)
            aligned = np.zeros((4, 4), np.float32)
            if with_scale:
                aligned[:3, :3] = np.diag(scales) / 1000 @ rotation.T
            else:
                aligned[:3, :3] = rotation.T
            aligned[:3, 3] = translation / 1000
            aligned[3, 3] = 1
        except Exception as e:  # degenerate fit → identity (reference behaviour)
            errors += f"[ Error ] aligning instance {synset_names[class_ids[i]]} in {image_path}: {e}\n"
            aligned = np.identity(4, np.float32)
        z180 = np.diag([-1.0, -1.0, 1.0, 1.0])
        RTs[i] = z180 @ aligned
    return RTs, bbox_scales, errors
