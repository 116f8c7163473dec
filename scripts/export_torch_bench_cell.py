"""Export JAX's estimates on bench.py's main cell for the PyTorch port.

Runs the JAX package's own functions on the CPU exactly as ``bench.py``
calls them (bench.py:218-305): ``PRIMITIVES["bottle"]`` sampled at 8000
points from ``default_rng(0)``, offset by (0.1, -0.05, 0.7) and padded to
8192 rows; ``preprocess_cloud`` on ``PRNGKey(0)`` at ``npoint_pad`` 4096
and ``knn = cfg.knn``; ``PoseConfig.from_config(cfg, n_pairs=100000)``; the
encoders of ``checkpoints/bottle/params_best``; and writes
``cppf_tpu_torch/assets/bench_cell.npz`` with, for each pose,

- ``<mode>_<i>_{T,R,scale,up,n_filtered,grid_max}``: ``estimate_pose`` on
  ``PRNGKey(10 + i)``, i = 0..3, for ``mode`` ``nearest`` (the bench's
  fast mode) and ``trilinear``;
- ``batch_<i>_...``: row i of the first B = 4 dispatch of the bench's
  batch, ``estimate_pose_batch`` on ``split(PRNGKey(200), 4)`` over
  ``preprocess_cloud_batch`` on ``split(PRNGKey(3), 8)[:4]``, nearest
  splat, as one compiled program;
- ``<pose>_voxel`` (int32 [3]): the voxel of T in the pose's grid frame,
  ``<pose>_grid_peak``: the largest cell of the pose's ``ppf_vote`` grid
  (the dense grid, built apart from the pose from its own pair
  predictions and translation decode), ``<pose>_voxel_value``: that grid's
  cell at the voxel, ``<pose>_n_ties``: how many cells equal the largest
  one, and ``<pose>_ties`` [min(n_ties, 64), 3]: the first of them in C
  order.

Usage (needs JAX; runs on the CPU, ~2 min):
    python scripts/export_torch_bench_cell.py
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "cppf_tpu_torch", "assets")
N_PAIRS = 100000
N_KEYS = 4
B = 4
MAX_TIES = 64


def bench_cloud():
    """bench.py:222-225: the padded cloud [8192, 3] and its 8000 real rows."""
    from cppf_tpu.data.synthetic import PRIMITIVES, sample_surface

    rng = np.random.default_rng(0)
    pc_cam = sample_surface(PRIMITIVES["bottle"](), 8000, rng) + np.float32([0.1, -0.05, 0.7])
    pad = np.zeros((8192, 3), np.float32)
    pad[:8000] = pc_cam
    return pad, 8000


def center_grid(key, params, pc, normals, n_valid, nbr_idx, pcfg):
    """The dense ``ppf_vote`` grid of ``estimate_pose(key, ...)``'s center
    vote: its own pair predictions and translation decode
    (cppf_tpu/pipeline/pose.py:798-799, :533-547, :553-561), and the grid
    frame's corner."""
    import jax
    import jax.numpy as jnp

    from cppf_tpu.ops.voting import ppf_vote
    from cppf_tpu.pipeline.pose import pair_predictions

    rng_pairs, rng_vote = jax.random.split(key)
    point_idxs, preds = pair_predictions(rng_pairs, params["point"], params["ppf"], pc,
                                         normals, n_valid, pcfg, nbr_idx)
    rng_tr = jax.random.split(rng_vote, 4)[0]
    rng_tr0, rng_tr1 = jax.random.split(rng_tr)
    nb = pcfg.tr_num_bins
    tr_logits = preds[:, : 2 * nb].reshape(-1, 2, nb)
    v0, v1 = pcfg.vote_range
    idx0 = jax.random.categorical(rng_tr0, tr_logits[:, 0], axis=-1)
    idx1 = jax.random.categorical(rng_tr1, tr_logits[:, 1], axis=-1)
    preds_tr = jnp.stack([idx0.astype(pc.dtype) / (nb - 1) * 2 * v0 - v0,
                          idx1.astype(pc.dtype) / (nb - 1) * v1], -1)
    valid = (jnp.arange(pc.shape[0]) < n_valid)[:, None]
    corner = jnp.min(jnp.where(valid, pc, 1e9), 0)
    top = jnp.max(jnp.where(valid, pc, -1e9), 0)
    dims = jnp.minimum(((top - corner) / pcfg.res).astype(jnp.int32) + 1,
                       jnp.array(pcfg.grid_shape, jnp.int32))
    grid = ppf_vote(pc, preds_tr, jnp.ones((pc.shape[0],), pc.dtype), point_idxs, corner,
                    pcfg.res, dims, pcfg.grid_shape, n_rots=pcfg.num_rots,
                    adaptive=pcfg.adaptive_voting, splat=pcfg.splat)
    return np.asarray(grid), np.asarray(corner)


def store(out, name, res, grid, corner, pcfg):
    """One pose's fields, its voxel and its grid's ties under ``name``."""
    for f in ("T", "R", "scale", "up", "n_filtered", "grid_max"):
        out[f"{name}_{f}"] = np.asarray(getattr(res, f))
    T = np.asarray(res.T)
    voxel = np.rint((T - corner) / np.float32(pcfg.res)).astype(np.int32)
    peak = grid.max()
    ties = np.argwhere(grid == peak).astype(np.int32)
    out[f"{name}_voxel"] = voxel
    out[f"{name}_grid_peak"] = np.float32(peak)
    out[f"{name}_voxel_value"] = np.float32(grid[tuple(voxel)])
    out[f"{name}_n_ties"] = np.int32(len(ties))
    out[f"{name}_ties"] = ties[:MAX_TIES]
    print(f"{name}: T {T.tolist()} voxel {voxel.tolist()} value {grid[tuple(voxel)]} "
          f"(grid peak {peak}, {len(ties)} cells at it; grid_max {float(res.grid_max)}), "
          f"up {np.asarray(res.up).tolist()}, survivors {int(res.n_filtered)}", flush=True)


def main():
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    from cppf_tpu.config import load_config
    from cppf_tpu.pipeline.pose import PoseConfig, estimate_pose, estimate_pose_batch
    from cppf_tpu.pipeline.preprocess import preprocess_cloud, preprocess_cloud_batch
    from cppf_tpu.train.checkpoints import load_params

    t0 = time.perf_counter()
    cfg = load_config("bottle")
    pad, n_raw = bench_cloud()
    pre = preprocess_cloud(jax.random.PRNGKey(0), jnp.array(pad), n_raw, cfg.res,
                           npoint_pad=4096, knn=cfg.knn)
    pcfg = PoseConfig.from_config(cfg, n_pairs=N_PAIRS)
    params = load_params(os.path.join(ROOT, "checkpoints", "bottle"), name="params_best")
    sphere = jnp.array(pcfg.sphere_points())
    modes = {"nearest": PoseConfig(**{**pcfg.__dict__, "splat": "nearest"}),
             "trilinear": pcfg}
    out = {"n_valid": np.int32(pre.n_valid)}
    for mode, mcfg in modes.items():
        for i in range(N_KEYS):
            key = jax.random.PRNGKey(10 + i)
            res = estimate_pose(key, params["point"], params["ppf"], pre.pc, pre.normals,
                                pre.n_valid, sphere, mcfg, nbr_idx=pre.nbr_idx)
            grid, corner = center_grid(key, params, pre.pc, pre.normals, pre.n_valid,
                                       pre.nbr_idx, mcfg)
            store(out, f"{mode}_{i}", res, grid, corner, mcfg)

    # the bench's batch: bench.py:286-305, its first dispatch
    pads_b = jnp.broadcast_to(jnp.array(pad), (B, *pad.shape))
    keys = jax.random.split(jax.random.PRNGKey(3), 2 * B)
    pre_b = preprocess_cloud_batch(keys[:B], pads_b, jnp.full((B,), n_raw, jnp.int32),
                                   cfg.res, npoint_pad=4096, knn=cfg.knn)
    ks = jax.random.split(jax.random.PRNGKey(200), B)
    fast = modes["nearest"]
    res_b = estimate_pose_batch(ks, params["point"], params["ppf"], pre_b.pc, pre_b.normals,
                                pre_b.n_valid, sphere, fast, nbr_idxs=pre_b.nbr_idx)
    out["batch_n_valid"] = np.asarray(pre_b.n_valid)
    for i in range(B):
        row = type(res_b)(*(f[i] for f in res_b))
        grid, corner = center_grid(ks[i], params, pre_b.pc[i], pre_b.normals[i],
                                   pre_b.n_valid[i], pre_b.nbr_idx[i], fast)
        store(out, f"batch_{i}", row, grid, corner, fast)
    path = os.path.join(ASSETS, "bench_cell.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {len(out)} arrays to {path} ({os.path.getsize(path)} bytes) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
