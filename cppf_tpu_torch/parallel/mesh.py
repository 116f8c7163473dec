"""Process groups, the (data, pair) mesh and pair-sharded center voting
(counterpart of cppf_tpu/parallel/mesh.py).

One process per rank.  The ranks form a ``data × pair`` mesh, row-major as
JAX's ``Mesh(devices.reshape(shape), ("data", "pair"))``: rank
``d · pair + p`` sits at (d, p).  Instances or training samples split over
``data``; the 100 000-5 M point pairs of an instance split over ``pair``.
The vote grid, the bound projections, the refine windows and the sphere
counts are sums over pairs, so each rank sums its own pairs and one
all-reduce over its ``pair`` group merges them, as JAX's ``psum``.

Collectives run on ``torch.distributed``: NCCL between cards, one rank a
card; gloo for CPU tensors and for several ranks on one card (gloo takes
CUDA tensors through the host).  Nothing falls back: the backend and the
device are named at :func:`init_group`, and a tensor on another device
than the mesh's raises.

Layout of a pair shard (:func:`shard_rows`): ``c = ceil(P / pair)`` rows a
rank, rank p taking rows ``[p·c, (p+1)·c)`` cut at P.  A shard that is only
summed is used as cut (the last may be shorter); one that is all-gathered
is padded to ``c`` rows, as JAX's ``jnp.pad`` pads the pair axis, and the
padding is dropped after the gather.  Every sharded function takes the
rank's own rows of each pair array and everything else whole.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from cppf_tpu_torch.ops.voting import ppf_vote_dense, ppf_vote_peak

DATA_AXIS = "data"
PAIR_AXIS = "pair"
BACKENDS = ("gloo", "nccl")


def _factor(n: int) -> Tuple[int, int]:
    """Split n ranks into (data, pair) as square-ish as possible."""
    best = (1, n)
    for d in range(1, math.isqrt(n) + 1):
        if n % d == 0:
            best = (d, n // d)
    return best


def init_group(backend: str, device, world_size: int, rank: int, init_method: str,
               timeout_s: float = 300.0) -> torch.device:
    """Join the default process group on ``backend`` ("gloo" or "nccl")
    for tensors on ``device`` (a card's index is required: "cuda:0", not
    "cuda"), e.g. ``init_method="file:///tmp/store"`` or
    ``"tcp://localhost:29500"``.  NCCL needs a CUDA device and raises where
    it is missing; a collective that waits longer than ``timeout_s`` fails.
    Returns the device, made current for CUDA."""
    device = torch.device(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{device} requested but torch.cuda.is_available() is False")
        if device.index is None:
            raise ValueError("name the card: cuda:<index>")
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"NCCL carries CUDA tensors only, not {device}")
        if not dist.is_nccl_available():
            raise RuntimeError("NCCL requested but this torch has no NCCL")
    elif not dist.is_gloo_available():
        raise RuntimeError("gloo requested but this torch has no gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s),
                            device_id=device if backend == "nccl" else None)
    return device


@dataclass
class PairMesh:
    """This rank's place in the (data, pair) mesh, its two subgroups, and
    the traffic of its collectives (``traffic``: calls and bytes of each
    kind; an all-reduce counts its tensor, an all-gather what it returns)."""

    rank: int
    shape: Tuple[int, int]    # (data, pair)
    coords: Tuple[int, int]   # this rank's (data, pair) index
    device: torch.device
    pair_group: object
    data_group: object
    traffic: Dict[str, int] = field(default_factory=dict)

    @property
    def data(self) -> int:
        return self.shape[0]

    @property
    def pair(self) -> int:
        return self.shape[1]

    def check(self, *tensors) -> None:
        """Raise unless every tensor lies on the mesh's device."""
        for t in tensors:
            if t is not None and t.device != self.device:
                raise ValueError(f"a tensor on {t.device}; this mesh's ranks hold {self.device}")

    def _count(self, kind: str, t: torch.Tensor) -> None:
        self.traffic[kind + "_calls"] = self.traffic.get(kind + "_calls", 0) + 1
        self.traffic[kind + "_bytes"] = (self.traffic.get(kind + "_bytes", 0)
                                         + t.numel() * t.element_size())

    def reduce(self, t: torch.Tensor, axis: str = PAIR_AXIS) -> torch.Tensor:
        """Sum of ``t`` over the ranks of ``axis``, the same bits on every
        rank (in place when ``t`` is contiguous)."""
        self.check(t)
        out = t.contiguous()
        group = {PAIR_AXIS: self.pair_group, DATA_AXIS: self.data_group}[axis]
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        self._count("all_reduce", out)
        return out

    def gather_rows(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """The ``n`` rows of a pair array from each rank's :func:`shard_rows`
        rows ``t``: each shard padded to ``ceil(n / pair)`` rows, all-gathered
        over the pair group, the padding dropped.  A bool array travels as
        uint8."""
        self.check(t)
        if t.dtype == torch.bool:
            return self.gather_rows(t.to(torch.uint8), n).bool()
        c = -(-n // self.pair)
        padded = torch.zeros((c, *t.shape[1:]), dtype=t.dtype, device=t.device)
        padded[: t.shape[0]] = t
        parts = [torch.empty_like(padded) for _ in range(self.pair)]
        dist.all_gather(parts, padded, group=self.pair_group)
        out = torch.cat(parts)
        self._count("all_gather", out)
        return out[:n]


def make_mesh(world_size: int, shape: Optional[Tuple[int, int]] = None, *,
              device) -> PairMesh:
    """This rank's :class:`PairMesh` over the default group of
    ``world_size`` ranks (:func:`init_group` first), ``shape`` = (data,
    pair) or, by default, :func:`_factor`'s.  Every rank must call it: each
    subgroup is made on every rank, in one order."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_group first")
    if dist.get_world_size() != world_size:
        raise ValueError(f"the group has {dist.get_world_size()} ranks, not {world_size}")
    d, p = shape if shape is not None else _factor(world_size)
    if d * p != world_size:
        raise ValueError(f"mesh {d}x{p} does not hold {world_size} ranks")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        raise ValueError("name the card: cuda:<index>")
    rank = dist.get_rank()
    pair_groups = [dist.new_group(list(range(i * p, (i + 1) * p))) for i in range(d)]
    data_groups = [dist.new_group(list(range(j, world_size, p))) for j in range(p)]
    i, j = divmod(rank, p)
    return PairMesh(rank, (d, p), (i, j), device, pair_groups[i], data_groups[j])


def shard_rows(n: int, mesh: PairMesh) -> slice:
    """This rank's contiguous rows of an ``n``-row pair array."""
    c = -(-n // mesh.pair)
    k = mesh.coords[1]
    return slice(min(k * c, n), min((k + 1) * c, n))


# the fields of a train Batch with a pair axis (dim 1), split over ``pair``
PAIR_FIELDS = ("point_idxs", "tr_prob", "rot_prob", "aux", "aux_weight", "up_rot_weight")


def shard_batch(batch, mesh: PairMesh):
    """This rank's share of a ``train/step.py::Batch``: B split evenly over
    the data axis (``shard_batch_spec``'s ``P(DATA_AXIS)``), and the pair
    axis of each pair field (``PAIR_FIELDS``) split over the pair axis by
    :func:`shard_rows` (``P(DATA_AXIS, PAIR_AXIS)``); the points stay whole
    on every pair rank."""
    b_all = batch.pc.shape[0]
    if b_all % mesh.data:
        raise ValueError(f"a batch of {b_all} does not split over {mesh.data} data ranks")
    b = b_all // mesh.data
    i = mesh.coords[0]
    rows = shard_rows(batch.point_idxs.shape[1], mesh)
    return type(batch)(*(None if t is None else
                         t[i * b:(i + 1) * b, rows] if name in PAIR_FIELDS else
                         t[i * b:(i + 1) * b]
                         for name, t in zip(batch._fields, batch)))


def shard_halfspace(halfspace, rows: slice):
    """This rank's rows of a per-pair half-space gate (a, n_out, gate,
    margin); None stays None."""
    if halfspace is None:
        return None
    a, n_out, gate, margin = halfspace
    return a[rows], n_out[rows], gate[rows], margin


def sharded_ppf_vote(mesh: PairMesh, pc, preds_tr, probs, point_idxs, corner, res, grid_dims,
                     grid_shape: Tuple[int, int, int], n_rots: int = 72, adaptive: bool = False,
                     pair_mask=None, splat: str = "trilinear", halfspace=None) -> torch.Tensor:
    """The dense center-vote grid of every rank's pairs: this rank's
    ``ppf_vote_dense`` (``preds_tr``, ``point_idxs``, ``pair_mask`` and
    the ``halfspace`` rows: its own; on a CUDA tensor ``dense_hist``'s
    kernel, pairs front end, or votes front end under the gate) summed over
    the pair group.  Equal to the one-rank grid up to the order of float
    sums."""
    mesh.check(pc, preds_tr, probs, point_idxs, corner, pair_mask)
    local = ppf_vote_dense(pc, preds_tr, probs, point_idxs, corner, res, grid_dims, grid_shape,
                           n_rots=n_rots, adaptive=adaptive, pair_mask=pair_mask, splat=splat,
                           halfspace=halfspace)
    return mesh.reduce(local)


def sharded_ppf_vote_peak(mesh: PairMesh, pc, preds_tr, probs, point_idxs, corner, res,
                          grid_dims, grid_shape: Tuple[int, int, int], n_rots: int = 72,
                          adaptive: bool = False, pair_mask=None, splat: str = "trilinear",
                          max_rounds: int = 0, halfspace=None):
    """Branch-and-bound peak of the grid of every rank's pairs: this rank's
    ``ppf_vote_peak`` (its rows, and its rows of ``halfspace``; through the
    kernels on a CUDA tensor) with each bound projection and each refine
    window summed over the pair group (its ``reduce_fn``).  Every rank then
    holds the same sums and runs the same refine loop.  Returns (idx [3]
    int32, peak), the same on every rank; the peak voxel is the one-rank
    peak's up to the order of float sums."""
    mesh.check(pc, preds_tr, probs, point_idxs, corner, pair_mask)
    return ppf_vote_peak(pc, preds_tr, probs, point_idxs, corner, res, grid_dims, grid_shape,
                         n_rots=n_rots, adaptive=adaptive, pair_mask=pair_mask, splat=splat,
                         max_rounds=max_rounds, reduce_fn=mesh.reduce, halfspace=halfspace)
