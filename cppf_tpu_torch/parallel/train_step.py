"""The sharded train step: the torch form of the step that
``__graft_entry__.py::dryrun_multichip`` compiles over the JAX mesh, the
batch over ``data`` and each sample's pairs over ``pair``.

Each rank runs ``train/step.py::loss_fn`` on its share of the batch
(``mesh.shard_batch``: its samples, and of each its rows of the pairs).
Every rank of a ``pair`` group runs KNN and the point encoder on the whole
cloud and the PPF head on its rows.  Each loss term is the rank's
numerator over the denominators of every rank's pairs, which one no-grad
all-reduce over the ``pair`` group gives before the backward pass (the pair
counts and weight sums, ``losses.pair_denominators``): the terms of a pair
group then sum to the term of the whole sample, and so do their gradients,
the point encoder's included.  The gradients are summed over the ``pair``
group, then over the ``data`` group, and divided by the data rank count;
Adam takes the same step on every rank.  With as many samples on every
data rank, that is the gradient of the mean over the whole batch, which the
one-device step differentiates.  Ranks start from the same weights because
``init_train_state`` draws them from ``cfg.seed``.  A (W, 1) mesh takes
none of the pair collectives: its step is the data-parallel step alone.
"""
from __future__ import annotations

from typing import Dict

import torch

from cppf_tpu_torch.parallel.mesh import DATA_AXIS, PAIR_AXIS, PairMesh
from cppf_tpu_torch.train.losses import pair_denominators
from cppf_tpu_torch.train.step import Batch, TrainState, TrainStatics, loss_fn


def _group_mean(mesh: PairMesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the pair group (when it has several ranks), then
    over the data group, divided by the data rank count."""
    if mesh.pair > 1:
        t = mesh.reduce(t, axis=PAIR_AXIS)
    t = mesh.reduce(t, axis=DATA_AXIS)
    t /= mesh.data
    return t


def data_parallel_train_step(state: TrainState, batch: Batch, statics: TrainStatics,
                             mesh: PairMesh) -> Dict[str, torch.Tensor]:
    """One Adam step in place on every rank from ``batch``, this rank's
    share (``shard_batch`` of the global batch, on the mesh's device).
    Returns the loss components of the whole batch (detached), the same on
    every rank."""
    mesh.check(*(t for t in batch if t is not None))
    denoms = None
    if mesh.pair > 1:
        denoms = mesh.reduce(pair_denominators(batch.point_idxs, batch.aux_weight,
                                               batch.up_rot_weight), axis=PAIR_AXIS)
    state.opt.zero_grad(set_to_none=True)
    loss, comps = loss_fn(state, batch, statics, denoms)
    loss.backward()
    params = [p for g in state.opt.param_groups for p in g["params"]]
    flat = _group_mean(mesh, torch.cat([p.grad.reshape(-1) for p in params]))
    for p, g in zip(params, torch.split(flat, [p.numel() for p in params])):
        p.grad = g.view_as(p)
    state.opt.step()
    state.step += 1
    names = sorted(comps)
    means = _group_mean(mesh, torch.stack([comps[k].detach() for k in names]))
    return dict(zip(names, means))
