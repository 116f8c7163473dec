"""Export the zero-shot weights and the demo frame for the PyTorch port.

Writes two files into ``cppf_tpu_torch/assets/``:

- ``bowl_reg_params_zs.npz``: ``checkpoints/bowl_reg/params_zs`` (the
  proposal-contrast-selected regression state that
  ``tests/test_demo_frame.py`` loads) as flat arrays, one key per leaf of
  the params tree, path parts joined by ``/``.
- ``demo_frame.npz``: ``depth`` (the uint16 millimetre depth of
  ``data/demo/0000_depth.png``, so that the port needs no ``cv2``),
  ``intrinsics`` (``DEMO_INTRINSICS``), ``plane_u`` ([2, 200, 3], the
  RANSAC uniforms ``scene_planes`` draws for its two rounds at seed 0), and
  the JAX CPU ``zero_shot_detect`` result at full width (5 M pairs, 72
  rotations, seed 0): ``jax_T`` [k, 3], ``jax_R`` [k, 3, 3], ``jax_scale``
  [k, 3], ``jax_score`` [k], and ``jax_n_pairs``, the pairs left after the
  degenerate-pair filter.

With ``--contrast_val`` it writes ``contrast_val_bowl.npz`` instead: the
proposal-contrast validation scene of ``cppf_tpu.eval.contrast_val``
(``make_val_scene("bowl")``: ``depth``, uint16 millimetres, and
``gt_centers`` [2, 3]) and JAX's CPU ``proposal_contrast_score`` of
``checkpoints/bowl_reg/params_zs`` on it with the trainer's arguments
(500 000 pairs, 36 rotations, threshold 10, seed 0) under the bowl_reg
snapshot: ``jax_zs_score``, ``jax_zs_hits``, ``jax_zs_false``,
``jax_zs_mean_contrast``, ``jax_peaks`` [2, 3] (the argmax of the smoothed
heatmap within 5 cm of each GT center, the voxel the score reads) and the
heatmap's ``jax_corner`` and ``jax_dims``.

Usage (needs JAX and cv2; runs on the CPU, a few minutes):
    python scripts/export_torch_zero_shot_assets.py [--contrast_val]
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
ASSETS = os.path.join(ROOT, "cppf_tpu_torch", "assets")
CKPT = os.path.join(ROOT, "checkpoints", "bowl_reg")
DEPTH = os.path.join(ROOT, "data", "demo", "0000_depth.png")


def export_contrast_val():
    """contrast_val_bowl.npz: the val scene and JAX's score of params_zs."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from scipy.ndimage import gaussian_filter

    import cppf_tpu.eval.zero_shot as zs
    from cppf_tpu.config import load_config
    from cppf_tpu.eval.contrast_val import make_val_scene, proposal_contrast_score
    from cppf_tpu.train.checkpoints import load_params

    params = load_params(CKPT, "params_zs")
    cfg = load_config("bowl", snapshot=os.path.join(CKPT, "config.yaml"))
    cfg.cls_bins = False
    depth, centers = make_val_scene("bowl")
    heatmaps = []
    heatmap = zs.zero_shot_heatmap

    def recording_heatmap(*args, **kw):
        heatmaps.append(heatmap(*args, **kw))
        return heatmaps[-1]

    zs.zero_shot_heatmap = recording_heatmap
    t0 = time.perf_counter()
    score = proposal_contrast_score(depth, centers, params, cfg)
    print(f"JAX proposal_contrast_score: {score} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # the voxel the score reads at each GT center (contrast_val.py:122-130)
    hm = heatmaps[0]
    sm = gaussian_filter(hm.grid, sigma=1)
    tol = max(1, int(round(0.05 / cfg.res)))
    peaks = []
    for c in centers:
        loc_c = np.round((c - hm.corner) / cfg.res).astype(int)
        lo = np.maximum(loc_c - tol, 0)
        hi = np.minimum(loc_c + tol + 1, np.array(sm.shape))
        sub = sm[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        peaks.append(lo + np.array(np.unravel_index(np.argmax(sub), sub.shape)))
    print(f"peaks {peaks}, heatmap {hm.dims} at {hm.corner}", flush=True)
    np.savez_compressed(
        os.path.join(ASSETS, "contrast_val_bowl.npz"), depth=depth,
        gt_centers=np.stack(centers), jax_zs_score=np.float64(score["zs_score"]),
        jax_zs_hits=np.int64(score["zs_hits"]), jax_zs_false=np.int64(score["zs_false"]),
        jax_zs_mean_contrast=np.float64(score["zs_mean_contrast"]),
        jax_peaks=np.stack(peaks).astype(np.int64), jax_corner=np.asarray(hm.corner),
        jax_dims=np.asarray(hm.dims))
    print("wrote contrast_val_bowl.npz", flush=True)


def main():
    if "--contrast_val" in sys.argv[1:]:
        return export_contrast_val()
    import cv2
    import jax

    jax.config.update("jax_platforms", "cpu")
    from export_torch_assets import flatten_tree

    from cppf_tpu.config import load_config
    from cppf_tpu.eval.zero_shot import DEMO_INTRINSICS, detect_from_heatmap, zero_shot_heatmap
    from cppf_tpu.train.checkpoints import load_params

    os.makedirs(ASSETS, exist_ok=True)
    params = load_params(CKPT, "params_zs")
    flat = flatten_tree(params)
    np.savez(os.path.join(ASSETS, "bowl_reg_params_zs.npz"), **flat)
    print(f"wrote {len(flat)} arrays to bowl_reg_params_zs.npz", flush=True)

    cfg = load_config("bowl", snapshot=os.path.join(CKPT, "config.yaml"))
    cfg.cls_bins = False
    depth = cv2.imread(DEPTH, -1)
    t0 = time.perf_counter()
    # zero_shot_detect, in its two halves so the pair count can be kept
    hm = zero_shot_heatmap(depth, params, cfg)
    dets = detect_from_heatmap(hm, cfg)
    print(f"JAX zero_shot_detect: {len(dets)} detections in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for d in dets:
        print(f"  T {np.round(d.T, 4)} scale {np.round(d.scale, 4)} score {d.score:.1f}")
    plane_u = np.stack([np.asarray(jax.random.uniform(jax.random.PRNGKey(k), (200, 3)))
                        for k in range(2)])
    np.savez_compressed(
        os.path.join(ASSETS, "demo_frame.npz"), depth=depth.astype(np.uint16),
        intrinsics=DEMO_INTRINSICS, plane_u=plane_u.astype(np.float32),
        jax_T=np.array([d.T for d in dets], np.float64).reshape(-1, 3),
        jax_R=np.array([d.R for d in dets], np.float64).reshape(-1, 3, 3),
        jax_scale=np.array([d.scale for d in dets], np.float64).reshape(-1, 3),
        jax_score=np.array([d.score for d in dets], np.float64),
        jax_n_pairs=np.int64(len(hm.point_idxs)))
    print("wrote demo_frame.npz", flush=True)


if __name__ == "__main__":
    main()
