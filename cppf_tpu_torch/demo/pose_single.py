"""Single-instance 9D pose of one synthetic object (counterpart of
demo/pose_single.py).

Two modes:

- oracle (default): ground-truth pair predictions
  (``data/synthetic.oracle_pair_predictions``) drive the voting half
  (``pipeline/pose.vote_pose``): the pipeline's geometry without a network;
- ``--ckpt DIR``: the network of a category's served weights (as the
  runner serves them: ``DIR/params_best.npz``, for the repo's
  ``checkpoints/<cat>`` its exported assets, or the reference's
  ``DIR/{point,ppf}_encoder_epochbest.pth``) runs the whole
  ``estimate_pose``.

The draws are the JAX demo's for ``--seed``: the preprocess jitter of
``PRNGKey(seed)`` and the pose draws of ``PRNGKey(seed + 1)``
(``core/threefry.py``).  Runs on ``cuda`` unless ``--device cpu``.

Usage:
    python -m cppf_tpu_torch.demo.pose_single [--category bottle] [--ckpt DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from cppf_tpu_torch.config import load_config
from cppf_tpu_torch.core import threefry
from cppf_tpu_torch.data.shapenet import FLIP2NOCS, NOCS_CATEGORIES
from cppf_tpu_torch.data.synthetic import (PRIMITIVES, mesh_bounds, observation_pose,
                                           oracle_pair_predictions, sample_surface)
from cppf_tpu_torch.device import pin_float32, resolve_device
from cppf_tpu_torch.pipeline.pose import PoseConfig, PoseDraws, estimate_pose, vote_pose
from cppf_tpu_torch.pipeline.preprocess import preprocess_cloud
from cppf_tpu_torch.utils.prof import sync

N_POINTS = 6000
N_RAW_PAD = 8192
NPOINT_PAD = 4096


def demo_weights(ckpt: str, category: str) -> dict:
    """The params tree of ``ckpt`` when it is an ``.npz`` file, else the
    weights a runner serves from the directory
    (``eval/nocs_inference.served_weights``)."""
    from cppf_tpu_torch.eval.nocs_inference import served_weights
    from cppf_tpu_torch.models.convert import load_npz_params

    if os.path.isfile(ckpt):
        return load_npz_params(ckpt)
    return served_weights(category, ckpt)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--category", default="bottle")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir (served as the runner serves it) or an .npz of "
                         "weights")
    ap.add_argument("--n_pairs", type=int, default=100000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; never falls back to the CPU)")
    return ap


def main(argv=None) -> dict:
    """Poses the object and prints the errors; returns the pose
    (``"out"``), the GT (``"R_true"``, ``"T_true"``, ``"bound"``), the
    preprocessed cloud (``"pre"``), in oracle mode the pairs and
    predictions (``"idxs"``, ``"preds"``), and the synchronised seconds."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    pin_float32()
    cfg = load_config(args.category)
    rng = np.random.default_rng(args.seed)

    mesh = PRIMITIVES.get(args.category, PRIMITIVES["bottle"])()
    is_nocs = args.category in NOCS_CATEGORIES
    R_true, T_true = observation_pose(rng, is_nocs=is_nocs)
    lo, hi = mesh_bounds(mesh)
    # the canonical object of the training data: box-centred, unit
    # diagonal, scaled into the category's range, flip2nocs'd
    diag = float(np.linalg.norm(hi - lo))
    scale = float(np.mean(cfg.scale_range))
    pc_canon = (sample_surface(mesh, N_POINTS, rng) - (lo + hi) / 2) / diag * scale
    if is_nocs:
        pc_canon = pc_canon @ FLIP2NOCS.T
    pc_cam = (pc_canon @ R_true.T + T_true).astype(np.float32)
    bound = (hi - lo) / diag * scale
    bound[[0, 2]] = bound[[2, 0]]

    pcfg = PoseConfig.from_config(cfg, n_pairs=args.n_pairs)
    pre_key, pose_key = threefry.key(args.seed), threefry.key(args.seed + 1)
    draws = (PoseDraws.from_jax_keys(pcfg, pre_key, pose_key, device, n_raw=N_RAW_PAD)
             if args.ckpt else PoseDraws.from_jax_vote_key(pcfg, pose_key, device,
                                                           pre_key=pre_key, n_raw=N_RAW_PAD))
    pad = np.zeros((N_RAW_PAD, 3), np.float32)
    pad[:N_POINTS] = pc_cam
    pre = preprocess_cloud(torch.from_numpy(pad).to(device), N_POINTS, cfg.res,
                           npoint_pad=NPOINT_PAD, knn=cfg.knn, noise=draws.jitter)
    n = int(pre.n_valid)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"category={args.category}  points={n}  device={name}")
    sphere = torch.from_numpy(pcfg.sphere_points()).to(device)

    result = dict(R_true=R_true, T_true=T_true, bound=bound, pre=pre)
    if args.ckpt:
        from cppf_tpu_torch.models.convert import load_encoders

        encoders = load_encoders(demo_weights(args.ckpt, args.category), cfg.out_dim, device)
        sync(device)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = estimate_pose(*encoders, pre.pc, pre.normals, pre.n_valid, sphere, pcfg,
                                draws=draws)
        sync(device)
    else:
        idxs = rng.integers(0, n, size=(args.n_pairs, 2)).astype(np.int32)
        preds = oracle_pair_predictions(pre.pc.cpu().numpy(), pre.normals.cpu().numpy(), idxs,
                                        T_true, R_true, bound, 1.0, cfg)
        result.update(idxs=idxs, preds=preds)
        sync(device)
        t0 = time.perf_counter()
        out = vote_pose(pre.pc, pre.normals, torch.from_numpy(idxs).to(device),
                        torch.from_numpy(preds).to(device), pre.n_valid, sphere, pcfg, draws)
        sync(device)
    dt = time.perf_counter() - t0

    T = out.T.cpu().numpy()
    up_true = R_true @ np.array([0, 1.0, 0])
    cos_up = float(out.up.cpu().numpy() @ up_true)
    if cfg.up_sym:
        cos_up = abs(cos_up)
    print(f"T_est   = {T}   (err {np.linalg.norm(T - T_true) * 1000:.1f} mm)")
    print(f"R_est   =\n{out.R.cpu().numpy()}")
    print(f"up-axis error = {np.degrees(np.arccos(np.clip(cos_up, -1, 1))):.2f} deg")
    print(f"scale   = {out.scale.cpu().numpy()}   (true NOCS extent {bound})")
    print(f"pairs surviving backvote: {int(out.n_filtered)}/{args.n_pairs}")
    print(f"wall time, synchronised (incl. first-call costs on a first run): {dt:.2f}s")
    result.update(out=out, seconds=dt)
    return result


if __name__ == "__main__":
    main()
