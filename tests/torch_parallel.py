"""Work of the gloo ranks of the port's parallel tests
(``tests/test_torch_parallel.py``), which start them with
``cppf_tpu_torch.parallel.launch.run_ranks(fn, "gloo", ["cpu"] * W, job,
...)``; each rank calls ``fn(rank, W, device, job)``.  This module imports
only torch and the port, so a rank starts without JAX.
"""
import os

import numpy as np
import torch

from cppf_tpu_torch.ops.voting import ppf_vote_peak
from cppf_tpu_torch.parallel import input_pipeline
from cppf_tpu_torch.parallel.mesh import (make_mesh, shard_batch, shard_rows, sharded_ppf_vote,
                                          sharded_ppf_vote_peak)


# ---- work of the ranks -------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.array(a))


def vote_and_peak(mesh, vote):
    """sharded_ppf_vote and sharded_ppf_vote_peak of the rank's rows of the
    ``vote`` problem (pc, preds_tr, probs, idxs, corner, res, dims, grid
    shape, rotations)."""
    pc, preds_tr, probs, idxs, corner = (_t(vote[k]) for k in
                                         ("pc", "preds_tr", "probs", "idxs", "corner"))
    rows = shard_rows(idxs.shape[0], mesh)
    args = (pc, preds_tr[rows], probs, idxs[rows], corner, vote["res"], _t(vote["dims"]),
            vote["grid_shape"])
    grid = sharded_ppf_vote(mesh, *args, n_rots=vote["n_rots"])
    reduced = []

    def reduce_fn(t):
        out = mesh.reduce(t)
        reduced.append(out.clone())
        return out

    peak = ppf_vote_peak(*args, n_rots=vote["n_rots"], reduce_fn=reduce_fn)
    peak_api = sharded_ppf_vote_peak(mesh, *args, n_rots=vote["n_rots"])
    return dict(grid=grid, peak=peak, peak_api=peak_api, reduced=reduced)


def encoders(j):
    """A pose job's encoders: its ``params`` (a JAX params tree), else its
    category's committed weights."""
    from cppf_tpu_torch.models.convert import ASSETS, load_encoders, load_npz_params

    params = j.get("params")
    if params is None:
        params = load_npz_params(os.path.join(ASSETS, f"{j['category']}_params_best.npz"))
    return load_encoders(params, j["out_dim"], "cpu")


def poses(mesh, jobs):
    """sharded_estimate_pose of each pose job, with the traffic of each."""
    from cppf_tpu_torch.parallel.pose import sharded_estimate_pose

    out = {}
    for name, j in jobs.items():
        point, ppf = encoders(j)
        mesh.traffic.clear()
        res = sharded_estimate_pose(mesh, point, ppf, _t(j["pc"]), _t(j["normals"]),
                                    _t(j["n_valid"]), _t(j["sphere"]), j["pcfg"], j["draws"],
                                    nbr_idx=_t(j["nbr_idx"]))
        out[name] = dict(result=res._asdict(), traffic=dict(mesh.traffic))
    return out


def train_step(mesh, job):
    """One data_parallel_train_step of the rank's share of the batch
    (samples over data, pairs over pair) from JAX's init, with the
    step's collective traffic; the flax-style init's weights."""
    from cppf_tpu_torch.parallel.train_step import data_parallel_train_step
    from cppf_tpu_torch.train import step

    cfg, batch = job["cfg"], job["batch"]
    statics = step.TrainStatics.from_config(cfg)
    fresh = step.init_train_state(cfg, "cpu")
    state = step.init_train_state(cfg, "cpu", params=job["params"])
    mesh.traffic.clear()
    comps = data_parallel_train_step(state, shard_batch(batch, mesh), statics, mesh)
    params = state.opt.param_groups[0]["params"]
    return dict(comps=comps, grads=[p.grad.clone() for p in params],
                weights=[p.detach().clone() for p in params], traffic=dict(mesh.traffic),
                init=[p.detach().clone() for p in fresh.opt.param_groups[0]["params"]])


def gated_vote(mesh, vote):
    """sharded_ppf_vote and sharded_ppf_vote_peak of the rank's rows of the
    ``vote`` problem under its half-space gate (``vote["halfspace"]``:
    every pair's rows)."""
    from cppf_tpu_torch.parallel.mesh import shard_halfspace

    pc, preds_tr, probs, idxs, corner = (_t(vote[k]) for k in
                                         ("pc", "preds_tr", "probs", "idxs", "corner"))
    rows = shard_rows(idxs.shape[0], mesh)
    a, n_out, gate, margin = vote["halfspace"]
    hs = shard_halfspace((_t(a), _t(n_out), _t(gate), torch.tensor(margin)), rows)
    args = (pc, preds_tr[rows], probs, idxs[rows], corner, vote["res"], _t(vote["dims"]),
            vote["grid_shape"])
    return dict(grid=sharded_ppf_vote(mesh, *args, n_rots=vote["n_rots"], halfspace=hs),
                peak=sharded_ppf_vote_peak(mesh, *args, n_rots=vote["n_rots"], halfspace=hs))


def parallel_checks(rank, world_size, device, job):
    """Everything ``test_torch_parallel.py`` asks of one gloo group: the
    vote, the peak (plain and under a half-space gate) and the poses on a
    (1, W) mesh; the train step on each mesh shape of ``job["meshes"]``;
    and what must raise."""
    from cppf_tpu_torch.parallel.pose import sharded_estimate_pose

    torch.set_num_threads(1)
    pair_mesh = make_mesh(world_size, shape=(1, world_size), device=device)
    out = dict(vote=vote_and_peak(pair_mesh, job["vote"]),
               gated=gated_vote(pair_mesh, job["vote"]), poses=poses(pair_mesh, job["poses"]))
    out["train"] = {}
    for shape in job["meshes"]:
        mesh = pair_mesh if shape == (1, world_size) else make_mesh(world_size, shape=shape,
                                                                    device=device)
        out["train"][shape] = train_step(mesh, job["train"])
    raised = {}
    try:
        sharded_estimate_pose(pair_mesh, None, None, torch.zeros((4, 3), device="meta"), None,
                              4, None, None, job["poses"]["bowl"]["draws"])
        raised["other_device"] = None
    except ValueError as e:
        raised["other_device"] = type(e).__name__
    out["raised"] = raised
    return out


class _Models:
    model_names = [f"model_{i:02d}" for i in range(11)]
    rng = None


def shard_dataset_draws(rank, world_size, device, job):
    """The round-robin model list and first draws of shard_dataset with no
    explicit process index or count (tests/test_multihost.py's worker)."""
    ds = input_pipeline.shard_dataset(_Models(), seed=7)
    return dict(names=ds.model_names, draws=ds.rng.integers(0, 1_000_000, size=4).tolist(),
                hosts=input_pipeline.host_shard(list(range(5))),
                global_batch=input_pipeline.global_batch_size(3))
