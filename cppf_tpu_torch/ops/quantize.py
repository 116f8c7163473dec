"""Voxel-grid downsampling (counterpart of cppf_tpu/ops/quantize.py)."""
from __future__ import annotations

import numpy as np
import torch

from cppf_tpu_torch.utils import prof


def voxel_downsample_host(points: np.ndarray, res: float, device="cpu") -> np.ndarray:
    """First-occurrence voxel downsample of a host cloud (counterpart of
    cppf_tpu/data/native.py::voxel_downsample_host, C++ in native/voxel.cpp):
    int32 indices of the first point of each occupied voxel, ascending.
    Points are cast to float32 and divided by a float32 ``res``, as the
    native code does; the work runs on ``device``."""
    pc = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(device)
    idx, n = voxel_downsample(pc, res)
    return idx[: int(n)].cpu().numpy()


def voxel_downsample(pc: torch.Tensor, res, valid_mask: torch.Tensor | None = None):
    """Keep the first point of each occupied voxel of edge ``res``.

    pc: [N, 3] (padded); returns (indices [N] int32, n_unique int32 0-d
    tensor).  The first ``n_unique`` entries are the kept original indices in
    ascending order; the rest are 0.  Voxel keys are linearised with
    data-derived strides (exact) in int64, so a padded row never overflows
    into a valid key.
    """
    n = pc.shape[0]
    dev = pc.device
    # res as a 0-d tensor: CUDA divides by a Python scalar through its
    # reciprocal, which can move a point across a voxel face
    v = torch.floor(pc / torch.as_tensor(res, dtype=pc.dtype, device=dev)).to(torch.int64)
    if not (torch.is_tensor(res) and res.device == dev):
        prof.host_sync(dev)  # the upload of res
    if valid_mask is None:
        valid_mask = torch.ones(n, dtype=torch.bool, device=dev)
    big = torch.iinfo(torch.int64).max
    vm = valid_mask[:, None]
    vmin = torch.where(vm, v, big).amin(0)
    vmax = torch.where(vm, v, -big).amax(0)
    c = v - vmin
    span = torch.clamp(vmax - vmin + 1, min=1)
    key = (c[:, 0] * span[1] + c[:, 1]) * span[2] + c[:, 2]
    key = torch.where(valid_mask, key, big)

    order = torch.argsort(key, stable=True)
    key_sorted = key[order]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = key_sorted[1:] != key_sorted[:-1]
    first &= key_sorted != big
    n_unique = first.sum().to(torch.int32)

    sel = torch.where(first, order, big)
    sel = torch.sort(sel).values
    sel = torch.where(torch.arange(n, device=dev) < n_unique, sel, 0)
    return sel.to(torch.int32), n_unique
