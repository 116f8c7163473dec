"""GT-oracle probe of the SUN RGB-D categories on rendered partial views
(counterpart of scripts/probe_sun_oracle.py).

Tells pipeline faults from model quality: the pair predictions come from
the ground-truth pose (``data/synthetic.oracle_pair_predictions``), so any
pose error is the voting half's own (``pipeline/pose.vote_pose``).  Sweeps
the knobs of the SUN partial-view gap: ``--num_rots`` / ``--adaptive`` (the
circle's sampling density at SUN distances) and ``--filter_coplanar``
(plane-dominated views split the center vote across the plane).

The views, the pairs and the draws are the JAX script's for ``--seed``:
the renders and the pair indices from one ``default_rng(seed)`` stream,
and for each accepted view the preprocess jitter and the vote draws of the
keys ``k1``, ``k2`` that JAX splits from ``PRNGKey(seed)``
(``core/threefry.py``).  Runs on ``cuda`` unless ``--device cpu``.

Usage:
    python -m cppf_tpu_torch.scripts.probe_sun_oracle --categories table bed \\
        --num_rots 512 --adaptive --filter_coplanar [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from cppf_tpu_torch.config import load_config
from cppf_tpu_torch.core import threefry
from cppf_tpu_torch.core.geometry import backproject
from cppf_tpu_torch.data import native
from cppf_tpu_torch.data.synthetic import (mesh_bounds, observation_pose,
                                           oracle_pair_predictions, random_primitive)
from cppf_tpu_torch.device import pin_float32, resolve_device
from cppf_tpu_torch.eval.nocs_inference import REAL275_INTRINSICS
from cppf_tpu_torch.pipeline.pose import PoseConfig, PoseDraws, vote_pose
from cppf_tpu_torch.pipeline.preprocess import preprocess_cloud


def probe(category: str, n_poses: int, n_pairs: int, num_rots: int, adaptive: bool,
          filter_coplanar: bool, seed: int = 0, device=None, poses: list | None = None):
    """Median T and up errors of ``n_poses`` oracle-voted views; ``poses``,
    when given, receives (T, up, R, T_true) of each."""
    dev = resolve_device(device)
    pin_float32()
    cfg = load_config(category)
    cfg.num_rots = num_rots
    cfg.adaptive_voting = adaptive
    cfg.filter_coplanar = filter_coplanar
    pcfg = PoseConfig.from_config(cfg, n_pairs=n_pairs)
    sphere = torch.from_numpy(pcfg.sphere_points()).to(dev)
    rng = np.random.default_rng(seed)
    key = threefry.key(seed)
    K = REAL275_INTRINSICS

    t_errs, up_errs = [], []
    attempts = 0
    while len(t_errs) < n_poses and attempts < n_poses * 3:
        attempts += 1
        mesh = random_primitive(category, rng)
        lo, hi = mesh_bounds(mesh)
        diag = float(np.linalg.norm(hi - lo))
        scale = float(rng.uniform(*cfg.scale_range))
        R, T = observation_pose(rng, is_nocs=False)
        v_canon = (mesh.vertices - (lo + hi) / 2) / diag * scale
        v_render = (v_canon @ R.T + T) * np.float32([1, -1, -1])
        depth = native.rasterize_depth(v_render, mesh.faces, K[0, 0], K[1, 1], K[0, 2],
                                       K[1, 2], 640, 480)
        mask = depth > 0
        if mask.sum() < 300:
            continue
        pc_raw, _ = backproject(depth, K, mask)
        pc_raw[:, 0] = -pc_raw[:, 0]
        pc_raw[:, 1] = -pc_raw[:, 1]
        n_max = cfg.npoint_max
        if len(pc_raw) > n_max:  # stride subsample (spatially even)
            pc_raw = pc_raw[np.linspace(0, len(pc_raw) - 1, n_max).astype(int)]
        pad = np.zeros((n_max, 3), np.float32)
        pad[: len(pc_raw)] = pc_raw

        key, k1, k2 = threefry.split(key, 3)
        draws = PoseDraws.from_jax_vote_key(pcfg, k2, dev, pre_key=k1, n_raw=n_max)
        pre = preprocess_cloud(torch.from_numpy(pad).to(dev), len(pc_raw), cfg.res,
                               npoint_pad=cfg.npoint_pad, knn=cfg.knn, noise=draws.jitter)
        n = int(pre.n_valid)
        bound = (hi - lo) / diag * scale
        idxs = rng.integers(0, n, size=(n_pairs, 2)).astype(np.int32)
        preds = oracle_pair_predictions(pre.pc.cpu().numpy(), pre.normals.cpu().numpy(), idxs,
                                        T, R, bound.astype(np.float32), 1.0, cfg)
        out = vote_pose(pre.pc, pre.normals, torch.from_numpy(idxs).to(dev),
                        torch.from_numpy(preds).to(dev), pre.n_valid, sphere, pcfg, draws)
        T_est, up = out.T.cpu().numpy(), out.up.cpu().numpy()
        if poses is not None:
            poses.append((T_est, up, R, T))
        t_errs.append(float(np.linalg.norm(T_est - T)))
        up_errs.append(float(np.degrees(np.arccos(np.clip(float(up @ R[:, 1]), -1, 1)))))
        print(f"  pose {len(t_errs)}: T err {t_errs[-1]*1000:7.1f} mm   "
              f"up err {up_errs[-1]:5.1f} deg", flush=True)
    return {
        "t_err_mm_median": round(float(np.median(t_errs)) * 1000, 1),
        "up_err_deg_median": round(float(np.median(up_errs)), 1),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--categories", nargs="*", default=["table"])
    ap.add_argument("--n_poses", type=int, default=6)
    ap.add_argument("--n_pairs", type=int, default=20000)
    ap.add_argument("--num_rots", type=int, default=72)
    ap.add_argument("--adaptive", action="store_true")
    ap.add_argument("--filter_coplanar", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; never falls back to the CPU)")
    args = ap.parse_args(argv)
    results = {}
    for c in args.categories:
        r = probe(c, args.n_poses, args.n_pairs, args.num_rots, args.adaptive,
                  args.filter_coplanar, args.seed, args.device)
        results[c] = r
        print(f"{c}: rots={args.num_rots} adaptive={args.adaptive} "
              f"coplanar_filter={args.filter_coplanar} -> {r}", flush=True)
    return results


if __name__ == "__main__":
    main()
