"""Export a category's weights and test views for the PyTorch port.

Writes two files into ``cppf_tpu_torch/assets/``:

- ``<cat>_params_best.npz``: ``checkpoints/<cat>/params_best`` as flat
  arrays, one key per leaf of the params tree, path parts joined by ``/``
  (``point/params/spconv0/kernel/lin0/kernel`` ...).  The port reads only
  this file, so it needs no orbax.
- ``<cat>_views.npz``: ``--n_views`` depth-rendered views, built as
  ``scripts/eval_checkpoints.py`` builds them (native rasterizer →
  ``backproject`` → x/y sign fix, NOCS categories through ``FLIP2NOCS``,
  seed ``--seed``).  Per view ``i``: ``pc_i`` (the cloud, stride-subsampled
  to ``npoint_max`` with ``np.linspace`` as both runners do, so that they
  see the identical input), ``R_i``/``T_i`` (GT pose), ``bound_i`` (GT NOCS
  extent, the scale target) and the JAX ``CategoryRunner.estimate`` result
  on the CPU with the same per-view key schedule: ``jax_T_i``, ``jax_up_i``,
  ``jax_scale_i``, and ``jax_right_i`` where the category regresses its
  right axis; ``jax_key_i`` (uint32 [2]) is the key of that run, from which
  ``PoseDraws.from_jax_key`` remakes its draws in torch.  For laptop also
  ``laptop_up_i`` (GT up oriented toward the camera, the plane override's
  stand-in) and the JAX estimate with that override: ``jax_ov_T_i``,
  ``jax_ov_up_i``, ``jax_ov_right_i``, ``jax_ov_scale_i``.

Usage (needs JAX; runs on the CPU):
    python scripts/export_torch_assets.py [--category bowl] [--n_views 4] [--seed 0]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
ASSETS = os.path.join(ROOT, "cppf_tpu_torch", "assets")


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dict of arrays → {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def _store(views, prefix, i, out, right: bool):
    keys = ("T", "up", "scale") + (("right",) if right else ())
    for k in keys:
        views[f"{prefix}{k}_{i}"] = np.asarray(getattr(out, k), np.float32)


def render_views(category: str, n_views: int, seed: int, runner):
    """Depth-rendered views of ``category`` and the JAX pipeline's estimate
    of each."""
    import jax

    from cppf_tpu.core.geometry import backproject
    from cppf_tpu.data import native
    from cppf_tpu.data.shapenet import FLIP2NOCS, NOCS_CATEGORIES
    from cppf_tpu.data.synthetic import mesh_bounds, observation_pose, random_primitive
    from cppf_tpu.eval.nocs_inference import REAL275_INTRINSICS

    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    K = REAL275_INTRINSICS
    is_nocs = category in NOCS_CATEGORIES
    n_max = runner.cfg.npoint_max
    views = {}
    i = 0
    while i < n_views:
        mesh = random_primitive(category, rng)
        lo, hi = mesh_bounds(mesh)
        diag = float(np.linalg.norm(hi - lo))
        scale = float(rng.uniform(*runner.cfg.scale_range))
        R, T = observation_pose(rng, is_nocs=is_nocs)
        v_canon = (mesh.vertices - (lo + hi) / 2) / diag * scale
        if is_nocs:
            v_canon = v_canon @ FLIP2NOCS.T
        v_render = (v_canon @ R.T + T) * np.float32([1, -1, -1])
        depth = native.rasterize_depth(v_render, mesh.faces, K[0, 0], K[1, 1],
                                       K[0, 2], K[1, 2], 640, 480)
        mask = depth > 0
        if mask.sum() < 300:
            continue
        pc, _ = backproject(depth, K, mask)
        pc[:, 0] = -pc[:, 0]
        pc[:, 1] = -pc[:, 1]
        pc = pc.astype(np.float32)
        if len(pc) > n_max:
            pc = pc[np.linspace(0, len(pc) - 1, n_max).astype(int)]
        key, k1 = jax.random.split(key)
        out, _ = runner.estimate(k1, pc)
        views[f"pc_{i}"] = pc
        views[f"R_{i}"] = R.astype(np.float32)
        views[f"T_{i}"] = T.astype(np.float32)
        views[f"bound_{i}"] = ((hi - lo) / diag * scale).astype(np.float32)
        views[f"jax_key_{i}"] = np.asarray(jax.random.key_data(k1), np.uint32)
        _store(views, "jax_", i, out, runner.cfg.regress_right)
        if category == "laptop":
            lup = (R[:, 1] * (-1.0 if float(R[:, 1] @ T) > 0 else 1.0)).astype(np.float32)
            views[f"laptop_up_{i}"] = lup
            out_ov, _ = runner.estimate(k1, pc, laptop_up=lup)
            _store(views, "jax_ov_", i, out_ov, True)
        t_err = float(np.linalg.norm(np.asarray(out.T) - T))
        up_err = float(np.degrees(np.arccos(np.clip(np.asarray(out.up) @ R[:, 1], -1, 1))))
        print(f"view {i}: {len(pc)} points, JAX T err {t_err * 1000:.1f} mm, "
              f"up err {up_err:.1f} deg", flush=True)
        i += 1
    views["n_views"] = np.int32(n_views)
    return views


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--category", default="bowl")
    ap.add_argument("--n_views", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt_path", default=os.path.join(ROOT, "checkpoints"))
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from cppf_tpu.eval.nocs_inference import CategoryRunner
    from cppf_tpu.train.checkpoints import load_params

    cat = args.category
    os.makedirs(ASSETS, exist_ok=True)
    params = load_params(os.path.join(args.ckpt_path, cat), "params_best")
    flat = flatten_tree(params)
    np.savez(os.path.join(ASSETS, f"{cat}_params_best.npz"), **flat)
    print(f"wrote {len(flat)} arrays to {cat}_params_best.npz", flush=True)

    class Args:
        num_rots = 72
        angle_prec = 1.5
        adaptive_voting = False
        ckpt_name = None

    runner = CategoryRunner(cat, args.ckpt_path, Args)
    views = render_views(cat, args.n_views, args.seed, runner)
    np.savez_compressed(os.path.join(ASSETS, f"{cat}_views.npz"), **views)
    print(f"wrote {args.n_views} views to {cat}_views.npz", flush=True)


if __name__ == "__main__":
    main()
