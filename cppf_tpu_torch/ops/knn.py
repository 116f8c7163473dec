"""K-nearest neighbours (counterpart of cppf_tpu/ops/knn.py)."""
from __future__ import annotations

import torch


def pairwise_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distances [M, N] between two point sets, in float32 on
    their device: ``|a|² + |b|² − 2 a·b``, clamped at 0 before the root."""
    a, b = a.float(), b.float()
    sq = (a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :] - 2.0 * (a @ b.T)
    return torch.sqrt(torch.clamp(sq, min=0.0))


def _sq_norm(pc: torch.Tensor) -> torch.Tensor:
    """|p|² as XLA fuses it: fma(z, z, fma(y, y, x·x)) in float32,
    emulated in float64, where each float32 product is exact."""
    p = pc.double()
    acc = (p[:, 0] * p[:, 0]).float()
    for k in (1, 2):
        acc = (p[:, k] * p[:, k] + acc.double()).float()
    return acc


def _order_key(vals: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """int64 keys that sort as (value, column): the float32 bits made
    order-preserving, the column index below them."""
    bits = vals.contiguous().view(torch.int32)
    bits = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return (bits.to(torch.int64) << 32) | cols


def _smallest_k(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Column indices of the k smallest entries of each row, ascending,
    ties to the lower index, as ``lax.top_k`` orders them.  A float topk
    finds the set; the rows where it cut through a tie at the k-th value
    are redone with exact keys, and every row is then sorted by its keys."""
    vals, idx = torch.topk(d2, k, dim=-1, largest=False)
    thr = vals[:, -1:]
    cut = (d2 == thr).sum(-1) > (vals == thr).sum(-1)
    if bool(cut.any()):
        cols = torch.arange(d2.shape[1], device=d2.device)
        exact = torch.topk(_order_key(d2[cut], cols), k, dim=-1, largest=False).values
        idx[cut] = exact & 0xFFFFFFFF
        vals = torch.gather(d2, 1, idx)
    return torch.sort(_order_key(vals, idx), dim=-1).values & 0xFFFFFFFF


def knn_indices(pc: torch.Tensor, k: int, valid_mask: torch.Tensor | None = None,
                chunk: int = 1024) -> torch.Tensor:
    """Indices [N, k] of the k nearest points, self included.

    Squared distances by expansion, ``|p|² − 2 p·q + |q|²``, as the JAX code
    computes them, in row blocks of ``chunk`` so the N×N matrix never exists
    whole.  Padding points (``valid_mask`` False) are pushed to +inf.  The
    squared norms are rounded as XLA rounds them (:func:`_sq_norm`); the
    float32 product ``p·q`` rounds as XLA's on the CPU (one fused
    multiply-add chain) and cuBLAS's.  Points ~1 m from the camera sit
    millimetres apart, so an ulp of ``|p|²`` is a large share of a
    neighbour distance and moves the k-th neighbour.  The quantised
    distances tie often at the k-th neighbour; ties go to the lower index,
    as in ``lax.top_k``.
    """
    n = pc.shape[0]
    if valid_mask is None:
        penalty = torch.zeros(n, dtype=pc.dtype, device=pc.device)
    else:
        penalty = torch.where(valid_mask, 0.0, float("inf")).to(pc.dtype)
    sq_all = _sq_norm(pc)
    out = []
    for s in range(0, n, chunk):
        block = pc[s:s + chunk]
        d2 = sq_all[None, :] - 2.0 * (block @ pc.T) + _sq_norm(block)[:, None]
        d2 = d2 + penalty[None, :]
        out.append(_smallest_k(d2, k))
    return torch.cat(out).to(torch.int32)
