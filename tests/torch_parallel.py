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


def poses(mesh, jobs):
    """sharded_estimate_pose of each pose job, with the traffic of each."""
    from cppf_tpu_torch.models.convert import ASSETS, load_encoders, load_npz_params
    from cppf_tpu_torch.parallel.pose import sharded_estimate_pose

    out = {}
    for name, j in jobs.items():
        point, ppf = load_encoders(
            load_npz_params(os.path.join(ASSETS, f"{j['category']}_params_best.npz")),
            j["out_dim"], "cpu")
        mesh.traffic.clear()
        res = sharded_estimate_pose(mesh, point, ppf, _t(j["pc"]), _t(j["normals"]),
                                    _t(j["n_valid"]), _t(j["sphere"]), j["pcfg"], j["draws"],
                                    nbr_idx=_t(j["nbr_idx"]))
        out[name] = dict(result=res._asdict(), traffic=dict(mesh.traffic))
    return out


def train_step(mesh, job):
    """One data_parallel_train_step of the rank's samples from JAX's init;
    the flax-style init's weights; what a pair axis raises."""
    from cppf_tpu_torch.parallel.train_step import data_parallel_train_step
    from cppf_tpu_torch.train import step

    cfg, batch = job["cfg"], job["batch"]
    statics = step.TrainStatics.from_config(cfg)
    fresh = step.init_train_state(cfg, "cpu")
    state = step.init_train_state(cfg, "cpu", params=job["params"])
    comps = data_parallel_train_step(state, shard_batch(batch, mesh), statics, mesh)
    params = state.opt.param_groups[0]["params"]
    return dict(comps=comps, grads=[p.grad.clone() for p in params],
                weights=[p.detach().clone() for p in params],
                init=[p.detach().clone() for p in fresh.opt.param_groups[0]["params"]])


def parallel_checks(rank, world_size, device, job):
    """Everything ``test_torch_parallel.py`` asks of one gloo group: the
    vote and the peak and the poses on a (1, W) mesh, the data-parallel
    step on a (W, 1) mesh, and what must raise."""
    from cppf_tpu_torch.parallel.pose import sharded_estimate_pose
    from cppf_tpu_torch.parallel.train_step import data_parallel_train_step

    torch.set_num_threads(1)
    pair_mesh = make_mesh(world_size, shape=(1, world_size), device=device)
    out = dict(vote=vote_and_peak(pair_mesh, job["vote"]), poses=poses(pair_mesh, job["poses"]))
    if "train" in job:
        data_mesh = make_mesh(world_size, shape=(world_size, 1), device=device)
        out["train"] = train_step(data_mesh, job["train"])
    raised = {}
    v = job["vote"]
    for what, call in (
            ("halfspace", lambda: sharded_ppf_vote_peak(
                pair_mesh, _t(v["pc"]), _t(v["preds_tr"]), _t(v["probs"]), _t(v["idxs"]),
                _t(v["corner"]), v["res"], _t(v["dims"]), v["grid_shape"],
                halfspace=(None, None, None, 0.0))),
            ("pair_axis_training", lambda: data_parallel_train_step(None, None, None, pair_mesh)),
            ("other_device", lambda: sharded_estimate_pose(
                pair_mesh, None, None, torch.zeros((4, 3), device="meta"), None, 4, None, None,
                job["poses"]["bowl"]["draws"]))):
        try:
            call()
            raised[what] = None
        except (NotImplementedError, ValueError) as e:
            raised[what] = type(e).__name__
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
