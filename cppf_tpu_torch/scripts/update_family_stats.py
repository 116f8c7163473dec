"""Recompute the SUN RGB-D categories' statistics from the compositional
families (counterpart of scripts/update_family_stats.py).

The SUN category configs carry ``vote_range`` and ``scale_mean`` computed
from the primitive families; the compositional generators
(``data/compose.py``, drawn through ``data/synthetic.random_primitive``)
change the shape distributions, so the binning ranges must cover the new
families' extremes or the targets clip.  The NOCS categories are left
alone: their statistics are the reference's own constants.

Without ``--dry`` the new values are written into
``<config_root>/category/<cat>.yaml`` (default: the repo's ``configs/``,
which both packages read).

Usage: python -m cppf_tpu_torch.scripts.update_family_stats [--dry] [--config_root DIR]
"""
from __future__ import annotations

import argparse
import os
import re

import numpy as np

from cppf_tpu_torch.config import CONFIG_ROOT, load_config
from cppf_tpu_torch.data.synthetic import random_primitive, sample_surface

SUN = ["table", "chair", "bed", "sofa", "bookshelf", "bathtub"]


def family_stats(category: str, scale_range, n_draws: int = 60, n_pairs: int = 20000,
                 seed: int = 0):
    """(vote_range [2], scale_mean [3]) of ``n_draws`` random shapes of the
    family: the largest pair projection or distance to the center, times
    the largest scale and 1.05, and half the mean unit-diagonal extent
    (x and z swapped, as the dataset swaps them) times the mean scale."""
    rng = np.random.default_rng(seed)
    vmax = 0.0
    bounds = []
    for _ in range(n_draws):
        m = random_primitive(category, rng)
        v = m.vertices
        diag = float(np.linalg.norm(v.max(0) - v.min(0)))
        pts = sample_surface(m, 2048, rng) / diag
        pts = pts - (pts.min(0) + pts.max(0)) / 2
        idxs = rng.integers(0, len(pts), (n_pairs, 2))
        a, b = pts[idxs[:, 0]], pts[idxs[:, 1]]
        d = a - b
        u = d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9)
        proj = np.sum(a * u, -1)
        dist2o = np.linalg.norm(a - proj[:, None] * u, axis=-1)
        vmax = max(vmax, float(np.abs(proj).max()), float(dist2o.max()))
        bounds.append((v.max(0) - v.min(0)) / diag)
    bound_mean = np.stack(bounds).mean(0)
    # the dataset swaps the bound's x and z, so scale_mean lives in that order
    bound_mean[[0, 2]] = bound_mean[[2, 0]]
    smin, smax = float(scale_range[0]), float(scale_range[1])
    vote = vmax * smax * 1.05
    scale_mean = (bound_mean / 2 * (smin + smax) / 2).tolist()
    return [round(vote, 6)] * 2, [round(x, 6) for x in scale_mean]


def main(argv=None) -> dict:
    """Prints each category's new and old values, writes them unless
    ``--dry``; returns {category: (vote_range, scale_mean)}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dry", action="store_true")
    ap.add_argument("--config_root", default=CONFIG_ROOT)
    args = ap.parse_args(argv)
    out = {}
    for cat in SUN:
        cfg = load_config(cat, config_root=args.config_root)
        vote, smean = family_stats(cat, cfg.scale_range)
        out[cat] = (vote, smean)
        path = os.path.join(args.config_root, "category", f"{cat}.yaml")
        with open(path) as f:
            text = f.read()
        text = re.sub(r"vote_range: \[.*?\]", f"vote_range: [{vote[0]}, {vote[1]}]", text)
        text = re.sub(r"scale_mean: \[.*?\]",
                      "scale_mean: [" + ", ".join(str(x) for x in smean) + "]", text)
        print(f"{cat:10s} vote_range={vote[0]:.3f} scale_mean={[round(x, 3) for x in smean]}"
              f" (was {cfg.vote_range[0]:.3f} / {[round(x, 3) for x in cfg.scale_mean]})")
        if not args.dry:
            with open(path, "w") as f:
                f.write(text)
    return out


if __name__ == "__main__":
    main()
