"""Point-cloud preprocessing: jitter → voxel downsample → KNN → normals
(counterpart of cppf_tpu/pipeline/preprocess.py)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from cppf_tpu_torch.ops.knn import knn_indices
from cppf_tpu_torch.ops.normals import estimate_normals
from cppf_tpu_torch.ops.quantize import voxel_downsample


class PreprocessedCloud(NamedTuple):
    pc: torch.Tensor          # [M, 3] padded, valid prefix compacted to the front
    normals: torch.Tensor     # [M, 3]
    n_valid: torch.Tensor     # int32 0-d
    valid_mask: torch.Tensor  # [M] bool
    nbr_idx: torch.Tensor     # [M, knn] KNN indices (reused by the encoders)
    raw_idx: torch.Tensor     # [M] index of each kept point in the raw cloud


def preprocess_cloud(
    pc_raw: torch.Tensor,
    n_raw: int,
    res: float,
    npoint_pad: int = 8192,
    knn: int = 60,
    jitter: bool = True,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> PreprocessedCloud:
    """pc_raw: [N_raw, 3] padded with anything beyond ``n_raw``.

    ``noise`` is the standard-normal jitter draw [N_raw, 3] (the JAX code's
    ``jax.random.normal(rng, pc_raw.shape)``); when absent it is drawn from
    ``generator``.  Jitter is ``clip(res/4 · noise, ±res/2)``.
    """
    dev = pc_raw.device
    n = pc_raw.shape[0]
    raw_mask = torch.arange(n, device=dev) < n_raw
    if jitter:
        if noise is None:
            noise = torch.randn(pc_raw.shape, generator=generator, device=dev,
                                dtype=pc_raw.dtype)
        pc_raw = pc_raw + torch.clamp(res / 4 * noise, -res / 2, res / 2)
    pc_masked = torch.where(raw_mask[:, None], pc_raw, 1e6)
    sel, n_unique = voxel_downsample(pc_masked, res, raw_mask)
    n_keep = torch.clamp(n_unique, max=npoint_pad)
    idx = torch.arange(npoint_pad, device=dev)
    valid = idx < n_keep
    take = torch.where(valid, sel[:npoint_pad], 0)
    pc = torch.where(valid[:, None], pc_raw[take.long()], 0.0)
    nbr_idx = knn_indices(pc, knn, valid)
    normals = estimate_normals(pc, knn, valid, nbr_idx=nbr_idx)
    normals = torch.where(valid[:, None], normals, 0.0)
    return PreprocessedCloud(pc, normals, n_keep.to(torch.int32), valid, nbr_idx,
                             take.to(torch.int32))


def preprocess_cloud_batch(pcs_raw: torch.Tensor, n_raws, res: float, noises: torch.Tensor,
                           npoint_pad: int = 8192, knn: int = 60) -> PreprocessedCloud:
    """:func:`preprocess_cloud` of each instance of ``pcs_raw`` [B, N_raw, 3]
    (``n_raws`` [B] real points each, ``noises`` [B, N_raw, 3] their own
    jitter draws), one after another; the fields come back stacked [B, ...]
    (counterpart of cppf_tpu/pipeline/preprocess.py:80-99, a vmap there)."""
    rows = [preprocess_cloud(pcs_raw[i], int(n_raws[i]), res, npoint_pad=npoint_pad, knn=knn,
                             noise=noises[i]) for i in range(pcs_raw.shape[0])]
    return PreprocessedCloud(*(torch.stack(f) for f in zip(*rows)))
