"""Per-category statistics (counterpart of cppf_tpu/data/stats.py; the
reference's ``gen_stats.py``): over the category's meshes,

- ``scale_range``: the least and largest bounding-box diagonal,
- ``vote_range``: the largest |proj_len| and the largest dist2o over
  sampled pairs,
- ``scale_mean``: the mean of the meshes' largest half extents,

from 2048 surface samples a mesh and 100 000 random pairs, the pair
targets by ``core/targets.py::generate_targets`` in float32, as the JAX
package computes them.  Without ShapeNet under ``--shapenet_root`` the
category's primitive stands in (bottle's where it has none).

Usage:
    python -m cppf_tpu_torch.data.stats --category bowl [--shapenet_root ...]
        [--up_sym] [--right_sym] [--z_right] [--max_meshes N] [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from cppf_tpu_torch.core.targets import generate_targets
from cppf_tpu_torch.data.synthetic import sample_surface
from cppf_tpu_torch.device import resolve_device


def compute_stats(meshes, up_sym=False, right_sym=False, z_right=False, seed=0,
                  n_points=2048, n_pairs=100000, device=None):
    """The three statistics of ``meshes``; the draws come from
    ``np.random.default_rng(seed)`` in the JAX package's order.  The
    targets run on ``cuda`` unless ``device`` says otherwise."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    scale_range = [np.inf, -np.inf]
    vote_range = [0.0, 0.0]
    scale_means = []
    for mesh in meshes:
        pc = sample_surface(mesh, n_points, rng)
        pc = pc - (pc.min(0) + pc.max(0)) / 2
        idxs = rng.integers(0, len(pc), (n_pairs, 2)).astype(np.int32)
        pc_t = torch.as_tensor(pc, dtype=torch.float32, device=dev)
        # the aux targets are not read: zero normals
        tgt = generate_targets(pc_t, torch.zeros_like(pc_t), torch.from_numpy(idxs).to(dev),
                               up_sym, right_sym, z_right)
        tr = tgt.tr.cpu().numpy()
        diag = float(np.linalg.norm(pc.max(0) - pc.min(0)))
        scale_range[0] = min(scale_range[0], diag)
        scale_range[1] = max(scale_range[1], diag)
        vote_range[0] = max(vote_range[0], float(np.abs(tr[:, 0]).max()))
        vote_range[1] = max(vote_range[1], float(tr[:, 1].max()))
        scale_means.append(pc.max(0))
    return {
        "scale_range": scale_range,
        "vote_range": vote_range,
        "scale_mean": np.mean(scale_means, 0).tolist(),
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--category", default="bowl")
    parser.add_argument("--shapenet_root", default="./data/ShapeNetCore.v2")
    parser.add_argument("--up_sym", action="store_true")
    parser.add_argument("--right_sym", action="store_true")
    parser.add_argument("--z_right", action="store_true")
    parser.add_argument("--max_meshes", type=int, default=0)
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from cppf_tpu_torch.config import load_config
    from cppf_tpu_torch.data.mesh import load_obj
    from cppf_tpu_torch.data.shapenet import ShapeNetRenderDataset
    from cppf_tpu_torch.data.synthetic import PRIMITIVES

    cfg = load_config(args.category, overrides={"shapenet_root": args.shapenet_root})
    names = ShapeNetRenderDataset(cfg).model_names
    if names:
        if args.max_meshes:
            names = names[: args.max_meshes]
        meshes = []
        for name in names:
            cls_id, mesh_name = name.split("/")
            path = os.path.join(args.shapenet_root, cls_id, mesh_name, "models",
                                "model_normalized.obj")
            try:
                meshes.append(load_obj(path))
            except (OSError, ValueError) as e:
                print(f"skip {name}: {e}")
    else:
        meshes = [PRIMITIVES.get(args.category, PRIMITIVES["bottle"])()]

    stats = compute_stats(meshes, args.up_sym, args.right_sym, args.z_right,
                          device=args.device)
    print(f"scale_range: {stats['scale_range']}")
    print(f"vote_range: {stats['vote_range']}")
    print(f"scale_mean: {stats['scale_mean']}")
    return stats


if __name__ == "__main__":
    main()
