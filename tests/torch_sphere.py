"""The axis vote's sphere count for the tests: instances at the cells'
shapes, and the counts of a ``voting.sphere_pair_params`` block made in
plain PyTorch in the CUDA kernel's operation order
(``cppf_tpu_torch/csrc/sphere_count.cu``).  Imports only numpy, torch and
the port, so the card's tests may use it."""
from __future__ import annotations

import numpy as np
import torch

from cppf_tpu_torch.core.geometry import fibonacci_sphere

N_PAIRS, N_ROTS, N_SPHERE, ANGLE_PREC = 10_000, 72, 480, 1.5  # portbench/configs/*.json


def instance(n_pairs=N_PAIRS, n_sphere=N_SPHERE, seed=0, degenerate=0, device="cpu"):
    """(pc, angles, idxs, sphere, cos_tol): a cloud of 4 096 points, ``n_pairs``
    random pairs (the first ``degenerate`` of them a point with itself),
    angles decoded from 36 bins as ``pipeline/pose.py::_axis_angles``
    decodes them, the Fibonacci sphere and cos 1.5° in float32."""
    rng = np.random.default_rng(seed)
    pc = (rng.normal(size=(4096, 3)) * 0.05).astype(np.float32)
    idxs = rng.integers(0, 4096, (n_pairs, 2)).astype(np.int32)
    idxs[:degenerate, 1] = idxs[:degenerate, 0]
    angles = (rng.integers(0, 36, n_pairs).astype(np.float32) / 35 * np.float32(np.pi))
    sphere = fibonacci_sphere(n_sphere).astype(np.float32)
    cos_tol = float(np.cos(np.deg2rad(np.float32(ANGLE_PREC))))
    return (*(torch.from_numpy(a).to(device) for a in (pc, angles, idxs, sphere)), cos_tol)


def block_counts(pairs, table, sphere, cos_tol, float64_weights: bool = False,
                 chunk: int = 1024):
    """Counts [S] of the block's cone axes: each axis and cosine as the
    kernel makes it, every step a float32 operation of its own, ``chunk``
    pairs at a time; float32 whole-number counts, or with
    ``float64_weights`` column 11 of each hit summed in float64."""
    ca, sa = table[0][None, :], table[1][None, :]
    out = torch.zeros(sphere.shape[0], dtype=torch.float64, device=pairs.device)
    for s in range(0, pairs.shape[0], chunk):
        blk = pairs[s:s + chunk]
        co, t, y = blk[:, 0:3], blk[:, 3:4], blk[:, 4:7]
        deg, sab, w = blk[:, 7:8] != 0, blk[:, 8:11], blk[:, 11]
        comps = [t * (ca * co[:, k, None] + sa * y[:, k, None]) + sab[:, k, None]
                 for k in range(3)]
        norm = torch.sqrt(comps[0] * comps[0] + comps[1] * comps[1] + comps[2] * comps[2]) + 1e-7
        u = [torch.where(deg, 0.0, c / norm).reshape(-1) for c in comps]
        cos = (u[0][:, None] * sphere[None, :, 0] + u[1][:, None] * sphere[None, :, 1]
               + u[2][:, None] * sphere[None, :, 2])
        hits = (cos > cos_tol).to(torch.float64)
        if float64_weights:
            hits = hits * w.to(torch.float64).repeat_interleave(table.shape[1])[:, None]
        out += hits.sum(0)
    return out if float64_weights else out.to(torch.float32)
