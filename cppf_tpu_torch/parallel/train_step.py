"""The data-parallel train step: the torch form of the step that
``__graft_entry__.py::dryrun_multichip`` compiles over the JAX mesh.

Each rank of the ``data`` axis runs ``train/step.py::loss_fn`` on its own
samples of the batch (``mesh.shard_batch``), its gradients are summed over
the ``data`` group in one all-reduce and divided by the rank count, and
Adam takes the same step on every rank.  With as many samples on every
rank, the average of the ranks' per-sample means is the mean over the
whole batch, which is what the one-device step differentiates.  Ranks start
from the same weights because ``init_train_state`` draws them from
``cfg.seed``.  Splitting a sample's pairs over ``pair`` ranks in training
is not ported.
"""
from __future__ import annotations

from typing import Dict

import torch

from cppf_tpu_torch.parallel.mesh import DATA_AXIS, PairMesh
from cppf_tpu_torch.train.step import Batch, TrainState, TrainStatics, loss_fn


def data_parallel_train_step(state: TrainState, batch: Batch, statics: TrainStatics,
                             mesh: PairMesh) -> Dict[str, torch.Tensor]:
    """One Adam step in place on every rank from ``batch``, this rank's
    samples (``shard_batch`` of the global batch, on the mesh's device).
    Returns the loss components averaged over the data ranks (detached)."""
    if mesh.pair > 1:
        raise NotImplementedError("pair-sharded training is not ported: use a mesh of "
                                  f"shape ({mesh.data * mesh.pair}, 1)")
    mesh.check(*(t for t in batch if t is not None))
    state.opt.zero_grad(set_to_none=True)
    loss, comps = loss_fn(state, batch, statics)
    loss.backward()
    params = [p for g in state.opt.param_groups for p in g["params"]]
    flat = mesh.reduce(torch.cat([p.grad.reshape(-1) for p in params]), axis=DATA_AXIS)
    flat /= mesh.data
    for p, g in zip(params, torch.split(flat, [p.numel() for p in params])):
        p.grad = g.view_as(p)
    state.opt.step()
    state.step += 1
    names = sorted(comps)
    means = mesh.reduce(torch.stack([comps[k].detach() for k in names]), axis=DATA_AXIS)
    means /= mesh.data
    return dict(zip(names, means))
