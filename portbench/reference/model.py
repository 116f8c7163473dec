"""The CPPF networks as plain functions of a weight dict: the SPRIN point
encoder and the point-pair head (You et al., CVPR 2022), float32.

Weights are the flax tree flattened to ``point/params/...`` and
``ppf/params/...`` keys (a dense kernel is [in, out]), read from the
benchmark's own frozen copy under ``portbench/weights/``.  LayerNorms take
flax's epsilon, 1e-6.  The neighbourhood mean of the rotation-invariant
features is summed first to last, as XLA reduces it: camera-frame points sit
~1 m out while a neighbourhood spans millimetres, so the order of that sum
shows in ``point - mean`` at 1e-4.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def load_weights(path: str, device) -> Dict[str, torch.Tensor]:
    """The flat weight dict, each dense kernel kept as [out, in] (``.../W``)
    beside its [in, out] original."""
    with np.load(path) as z:
        w = {k: torch.from_numpy(np.asarray(z[k], np.float32)).to(device) for k in z.files}
    for k in [k for k in w if k.endswith("/kernel")]:
        w[k[:-len("kernel")] + "W"] = w[k].T.contiguous()
    return w


def dense(w, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """x·kernel + bias, as one ``linear`` of the [out, in] matrix: the
    product and the bias in the order a ``torch.nn.Linear`` takes them, so
    that a program whose layers are ``nn.Linear`` meets the same logits to
    the bit and the same Gumbel decodes."""
    return F.linear(x, w[prefix + "/W"], w[prefix + "/bias"])


def layer_norm(w, prefix: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), w[prefix + "/scale"], w[prefix + "/bias"], LN_EPS)


def ordered_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over dim -2, summed first to last."""
    s = x[..., 0, :]
    for k in range(1, x.shape[-2]):
        s = s + x[..., k, :]
    return (s / x.shape[-2]).unsqueeze(-2)


def rifeat(points_r: torch.Tensor, points_s: torch.Tensor) -> torch.Tensor:
    """Rotation-invariant 6-tuples [N, K, 6] of each (point, neighbour)."""
    r_mean = ordered_mean(points_r)
    l1, l2, l3 = r_mean - points_r, points_r - points_s, points_s - r_mean
    n1 = torch.linalg.norm(l1, dim=-1, keepdim=True)
    n2 = torch.linalg.norm(l2, dim=-1, keepdim=True)
    n3 = torch.linalg.norm(l3, dim=-1, keepdim=True).expand_as(n2)
    t1 = torch.sum(l1 * l2, -1, keepdim=True) / (n1 * n2 + 1e-7)
    t2 = torch.sum(l2 * l3, -1, keepdim=True) / (n2 * n3 + 1e-7)
    t3 = torch.sum(l3 * l1, -1, keepdim=True) / (n3 * n1 + 1e-7)
    return torch.cat([n1, n2, n3, t1, t2, t3], -1)


def point_features(w, cfg: dict, pc, normals, nbr_idx, valid) -> torch.Tensor:
    """SPRIN features [N, feat_dim + feat_dim // 4] (one layer)."""
    p = "point/params/"
    nbr = nbr_idx.long()
    nbrs = pc[nbr]
    dist = torch.linalg.norm(nbrs - pc[:, None, :], dim=-1, keepdim=True)
    ncos = torch.sum(normals[nbr] * normals[:, None, :], -1, keepdim=True)
    feat_in = torch.cat([dist, ncos], -1)
    h = rifeat(nbrs, pc[:, None, :])
    for i in range(len(cfg["spfcs"])):
        h = torch.relu(layer_norm(w, f"{p}spconv0/kernel/ln{i}",
                                  dense(w, f"{p}spconv0/kernel/lin{i}", h)))
    kern = dense(w, f"{p}spconv0/kernel/lin_out", h)                  # [N, K, rank]
    contracted = torch.einsum("nkr,nki->nri", kern, feat_in)
    feat = layer_norm(w, f"{p}spconv0/norm",
                      dense(w, f"{p}spconv0/outnet", contracted.reshape(pc.shape[0], -1)))
    tran = torch.where(valid[:, None], dense(w, f"{p}aggr0/linear", feat), float("-inf"))
    glob = tran.amax(0, keepdim=True).expand(feat.shape[0], tran.shape[-1])
    return torch.cat([feat, glob], -1)


def pair_head(w, cfg: dict, pc, normals, feat, idx) -> torch.Tensor:
    """Logits [P, out_dim] of the pairs ``idx`` [P, 2]."""
    p = "ppf/params/"
    a, b = idx[:, 0].long(), idx[:, 1].long()
    d = pc[a] - pc[b]
    d_norm = torch.linalg.norm(d, dim=-1)
    d_unit = d / (d_norm[:, None] + 1e-7)
    ppf = torch.stack([torch.sum(normals[a] * d_unit, -1), torch.sum(normals[b] * d_unit, -1),
                       torch.sum(normals[a] * normals[b], -1), d_norm], -1)
    x = torch.cat([feat[a], feat[b], ppf], -1)
    for i in range(len(cfg["ppffcs"]) - 1):
        h = dense(w, f"{p}res{i}/fc2", torch.relu(dense(w, f"{p}res{i}/fc1", x)))
        if f"{p}res{i}/fc0/kernel" in w:
            x = dense(w, f"{p}res{i}/fc0", x)
        x = h + x
    return dense(w, f"{p}final", x)
