"""Proposal-contrast validation of the zero-shot regression model
(counterpart of cppf_tpu/eval/contrast_val.py).

Selecting the zero-shot checkpoint by its training loss optimises the wrong
thing: the demo frame's proposals fell from 612 to 0 over epochs 60 to 200
as the model sharpened on clean renders (the JAX package's round-2
post-mortem).  The trainer instead scores a fixed synthetic scene (two
instances of the category, a box and a cylinder as clutter, a support slab,
with depth noise) every ``contrast_val_every`` epochs through the zero-shot
heatmap and the proposal extractor, and keeps ``params_zs`` on the best
score.

The scene draws from ``np.random.default_rng(seed)`` in the JAX package's
order, through the port's own renderer and primitives, so its depth is the
JAX package's to the bit.  The score runs :func:`zero_shot_heatmap` (on
``cuda`` unless told otherwise: one ``dense_hist_pairs`` launch a 2^20-pair
chunk) and scores the heatmap on the host with scipy and numpy.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from cppf_tpu_torch.core.geometry import rotx
from cppf_tpu_torch.data import native
from cppf_tpu_torch.data.shapenet import TRAIN_INTRINSICS, apply_depth_noise
from cppf_tpu_torch.data.synthetic import make_box, make_cylinder, random_primitive
from cppf_tpu_torch.eval.zero_shot import (boundary_contrast, extract_proposals_host,
                                           zero_shot_heatmap)


def make_val_scene(category: str = "bowl", seed: int = 12345,
                   noise: float = 1.0) -> Tuple[np.ndarray, List[np.ndarray]]:
    """A deterministic cluttered depth frame in demo format (mm uint16).

    Two posed instances of ``category`` (drawn from the compositional family)
    plus a box and a cylinder of comparable size as out-of-category clutter,
    standing on a support slab — the structures whose votes must stay
    diffuse.  Returns (depth_mm, gt_centers) with float32 centers in the
    zero-shot cloud frame (x, y as placed, z = +depth).
    """
    rng = np.random.default_rng(seed)
    K = TRAIN_INTRINSICS
    depth = np.zeros((480, 640), np.float32)

    def splat(verts, faces):
        nonlocal depth
        d = native.rasterize_depth(verts.astype(np.float32), faces,
                                   K[0, 0], K[1, 1], K[0, 2], K[1, 2], 640, 480)
        depth = np.where((depth == 0) | ((d > 0) & (d < depth)), d, depth)

    # support slab under everything (the table plane of the demo frame)
    slab = make_box((1.2, 0.02, 0.9))
    R_slab = rotx(np.deg2rad(30))[:3, :3]
    splat(slab.vertices @ R_slab.T + np.float32([0, -0.12, -0.85]), slab.faces)

    gt_centers = []
    # comparable depth and size, so that both peaks clear the notebook's
    # 0.7·max continuation rule when the model is sharp
    placements = [np.float32([-0.14, -0.02, -0.72]), np.float32([0.13, 0.0, -0.76])]
    for c in placements:
        mesh = random_primitive(category, rng)
        v = mesh.vertices
        diag = np.linalg.norm(v.max(0) - v.min(0))
        v = (v - (v.min(0) + v.max(0)) / 2) / diag * rng.uniform(0.2, 0.24)
        yaw = rng.uniform(0, 2 * np.pi)
        Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                       [-np.sin(yaw), 0, np.cos(yaw)]], np.float32)
        splat(v @ (rotx(np.deg2rad(20))[:3, :3] @ Ry).T + c, mesh.faces)
        gt_centers.append(np.array([c[0], c[1], -c[2]]))

    # out-of-category clutter: a box and a lying cylinder
    box = make_box((0.12, 0.09, 0.07))
    splat(box.vertices @ rotx(np.deg2rad(15))[:3, :3].T + np.float32([-0.02, -0.06, -0.95]),
          box.faces)
    cyl = make_cylinder(0.035, 0.16)
    Rz = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    splat(cyl.vertices @ Rz.T + np.float32([0.3, -0.08, -0.65]), cyl.faces)

    if noise > 0:
        depth = apply_depth_noise(depth, rng, noise)
    return (depth * 1000).astype(np.uint16), gt_centers


def contrast_scores(grid: np.ndarray, corner: np.ndarray, res: float, gt_centers,
                    prop_thresh: float = 10.0, hit_tol: float = 0.05):
    """The proposal-contrast score of one heatmap (host scipy and numpy).

    Each object is scored on its own (the notebook's sequential extraction
    couples proposals through its 0.7·max continuation rule, which would
    let one strong peak mask a weaker but clean one):

    - hit i: the boundary contrast at the argmax of the smoothed heatmap
      within ``hit_tol`` of GT center i exceeds ``prop_thresh``;
    - false positives: the proposals the extractor finds once the GT peak
      regions are zeroed: clutter and background peaks that would be junk
      detections on a real frame;
    - score = 100·hits − 5·false + min(mean hit contrast / thresh, 10) (the
      bounded sharpness bonus breaks ties without outvoting a miss).

    Returns (the four numbers as the JAX package names them, the argmax
    voxel [3] near each GT center)."""
    from scipy.ndimage import gaussian_filter

    sm = gaussian_filter(grid, sigma=1)
    grid_fp = grid.copy()
    tol_vox = max(1, int(round(hit_tol / res)))
    hits, hit_diffs, peaks = 0, [], []
    for c in gt_centers:
        loc_c = np.round((c - corner) / res).astype(int)
        lo = np.maximum(loc_c - tol_vox, 0)
        hi = np.minimum(loc_c + tol_vox + 1, np.array(sm.shape))
        sub = sm[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        if sub.size == 0:
            continue
        loc = lo + np.array(np.unravel_index(np.argmax(sub), sub.shape))
        peaks.append(loc)
        diff, lll, rrr = boundary_contrast(sm, loc)
        if diff > prop_thresh:
            hits += 1
            hit_diffs.append(diff)
        grid_fp[lll[0]:rrr[0], lll[1]:rrr[1], lll[2]:rrr[2]] = 0  # suppress GT
    # spurious peaks anywhere else (the real extractor on the remainder)
    false = len(extract_proposals_host(grid_fp, corner, res, thresh=prop_thresh))
    bonus = min(float(np.mean(hit_diffs)) / prop_thresh, 10.0) if hit_diffs else 0.0
    return {
        "zs_score": 100.0 * hits - 5.0 * false + bonus,
        "zs_hits": hits,
        "zs_false": false,
        "zs_mean_contrast": float(np.mean(hit_diffs)) if hit_diffs else 0.0,
    }, peaks


def proposal_contrast_score(
    depth: np.ndarray,
    gt_centers: List[np.ndarray],
    encoders_or_params,
    cfg,
    n_pairs: int = 500000,
    num_rots: int = 36,
    # contrast grows ~linearly with the pairs at a true peak but only ~sqrt
    # in vote noise; at 500k pairs the oracle's weakest object has ~38 and
    # diffuse votes ~2 (measured in the JAX package), so 10 sits between
    prop_thresh: float = 10.0,
    hit_tol: float = 0.05,
    seed: int = 0,
    predict_fn=None,
    device=None,
) -> dict:
    """Score the proposal quality of a regression model on a scene:
    :func:`zero_shot_heatmap` of ``depth`` (``encoders_or_params``: a
    (PointEncoder, PPFEncoder) pair or a params tree; ``predict_fn`` as
    there), then :func:`contrast_scores`.  Runs on ``cuda`` unless
    ``device`` says otherwise.  Returns {zs_score, zs_hits, zs_false,
    zs_mean_contrast}."""
    hm = zero_shot_heatmap(depth, encoders_or_params, cfg, intrinsics=TRAIN_INTRINSICS,
                           n_pairs=n_pairs, num_rots=num_rots, seed=seed,
                           predict_fn=predict_fn, device=device)
    return contrast_scores(hm.grid, hm.corner, cfg.res, gt_centers, prop_thresh, hit_tol)[0]
