"""Soft-binning codec: scalar <-> two-hot probability over bins
(counterpart of cppf_tpu/core/binning.py).

Non-circular bins have centres at i·max_val/(num_bins−1), and a value's
mass is split linearly between the two bins around it.  Circular bins tile
the circle with centres half an interval in, and the mass wraps around.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def real2prob(val: torch.Tensor, max_val: float, num_bins: int,
              circular: bool = False) -> torch.Tensor:
    """Two-hot distribution [..., num_bins] of scalars in [0, max_val]."""
    if not circular:
        interval = max_val / (num_bins - 1)
        t = val / interval
        low = torch.clamp(torch.floor(t).to(torch.int64), 0, num_bins - 2)
        w_low = 1.0 - (t - low)
        w_high = 1.0 - w_low
        return (F.one_hot(low, num_bins).to(val.dtype) * w_low[..., None]
                + F.one_hot(low + 1, num_bins).to(val.dtype) * w_high[..., None])
    interval = max_val / num_bins
    val_new = torch.where(val < interval / 2, val + max_val, val)
    res = real2prob(val_new - interval / 2, max_val, num_bins + 1, circular=False)
    first = res[..., :1] + res[..., -1:]
    return torch.cat([first, res[..., 1:-1]], -1)


def prob2real(prob: torch.Tensor, max_val: float, num_bins: int,
              circular: bool = False) -> torch.Tensor:
    """Expected scalar of a distribution over bins."""
    if not circular:
        centres = torch.arange(num_bins, dtype=prob.dtype, device=prob.device) * (
            max_val / (num_bins - 1))
        return torch.sum(prob * centres, -1)
    interval = max_val / num_bins
    ang = torch.arange(num_bins, dtype=prob.dtype, device=prob.device) * interval + interval / 2
    vec = torch.sum(prob[..., None] * torch.stack([torch.cos(ang), torch.sin(ang)], -1), -2)
    res = torch.atan2(vec[..., 1], vec[..., 0])
    return torch.where(res < 0, res + 2 * math.pi, res)


def decode_bin_sample(gumbel: torch.Tensor, logits: torch.Tensor, max_val: float,
                      lo: float = 0.0) -> torch.Tensor:
    """Multinomial bin decode: the bin of argmax(logits + gumbel) a row
    (``jax.random.categorical`` with its Gumbel noise injected, as
    ``PoseDraws`` injects it), mapped to ``lo + idx/(num_bins−1)·(max_val − lo)``."""
    num_bins = logits.shape[-1]
    idx = torch.argmax(logits + gumbel, -1)
    return lo + idx.to(logits.dtype) / (num_bins - 1) * (max_val - lo)


def decode_bin_argmax(logits: torch.Tensor, max_val: float, lo: float = 0.0) -> torch.Tensor:
    """Deterministic (argmax) variant of :func:`decode_bin_sample`."""
    num_bins = logits.shape[-1]
    idx = torch.argmax(logits, -1)
    return lo + idx.to(logits.dtype) / (num_bins - 1) * (max_val - lo)
