"""Entry points of the port (counterpart of ``__graft_entry__.py``).

- :func:`entry` → ``(fn, example_args)``: the single-instance 9D pose
  (SPRIN features → PPF head → center and axis votes → R/T/S) on bowl at a
  small static size; ``fn(*example_args)`` runs it.
- :func:`dryrun_multichip`: ``n`` ranks in a (data, pair) mesh run one
  sharded training step (the batch over ``data``, each sample's pairs over
  ``pair``), then the pair-sharded pose, on tiny shapes.

Both run on the card unless asked for the CPU.  The random numbers are
JAX's (``core/threefry.py``): the same cloud jitter and pose draws as
``__graft_entry__.py``'s from the same keys; the weights are drawn with
``train/step.py::flax_init_`` from a seeded ``torch.Generator`` (JAX's
come from ``jax.random``, which a test hands over instead).

Usage:
    python -m cppf_tpu_torch.entry [--device cpu]
    python -m cppf_tpu_torch.entry multichip 4 [--device cpu] [--backend gloo]
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from cppf_tpu_torch.config import load_config
from cppf_tpu_torch.core import threefry
from cppf_tpu_torch.data.synthetic import PRIMITIVES, sample_surface
from cppf_tpu_torch.device import pin_float32, resolve_device
from cppf_tpu_torch.models.convert import make_encoders
from cppf_tpu_torch.pipeline.pose import PoseConfig, PoseDraws, estimate_pose
from cppf_tpu_torch.pipeline.preprocess import preprocess_cloud
from cppf_tpu_torch.train.step import flax_init_

ENTRY_POINTS = 3000     # bowl surface samples, padded to ENTRY_PAD rows
ENTRY_PAD = 3072
ENTRY_NPOINT = 2048     # the preprocessed cloud's static size
ENTRY_PAIRS = 8192
ENTRY_SUBSAMPLE = 2048
ENTRY_OFFSET = (0.1, -0.05, 0.7)
ENTRY_WEIGHT_SEED = 1   # the torch.Generator of the random weights
# JAX's keys of __graft_entry__.py: the preprocess jitter, the pose draws
ENTRY_PRE_KEY, ENTRY_POSE_KEY = 0, 3

DRYRUN_POINTS = 128
DRYRUN_PAIRS = 64       # a pair rank's pairs of a sample
DRYRUN_POSE_KEY = 5


def entry_config(cfg=None) -> PoseConfig:
    """bowl's PoseConfig at 8192 pairs and 2048 subsampled axis votes."""
    cfg = cfg if cfg is not None else load_config("bowl")
    return dataclasses.replace(PoseConfig.from_config(cfg, n_pairs=ENTRY_PAIRS),
                               rot_subsample=ENTRY_SUBSAMPLE)


def entry(device=None):
    """``(fn, example_args)``: ``fn(draws, point_encoder, ppf_encoder, pc,
    normals, n_valid, sphere)`` is ``estimate_pose`` at :func:`entry_config`
    (KNN included); ``example_args`` hold bowl's primitive, 3000 surface
    samples offset to ``ENTRY_OFFSET``, preprocessed to 2048 points with
    JAX's jitter of key 0, the pose draws of JAX's key 3, and random
    weights from a seeded generator, all on ``device`` (the card by
    default)."""
    dev = resolve_device(device)
    pin_float32()
    cfg = load_config("bowl")
    pcfg = entry_config(cfg)
    rng = np.random.default_rng(0)
    pc_cam = (sample_surface(PRIMITIVES["bowl"](), ENTRY_POINTS, rng)
              + np.float32(ENTRY_OFFSET)).astype(np.float32)
    pad = np.zeros((ENTRY_PAD, 3), np.float32)
    pad[:ENTRY_POINTS] = pc_cam
    draws = PoseDraws.from_jax_keys(pcfg, threefry.key(ENTRY_PRE_KEY),
                                    threefry.key(ENTRY_POSE_KEY), dev, ENTRY_PAD)
    with torch.no_grad():
        pre = preprocess_cloud(torch.from_numpy(pad).to(dev), ENTRY_POINTS, cfg.res,
                               npoint_pad=ENTRY_NPOINT, knn=cfg.knn, noise=draws.jitter)
    point, ppf = make_encoders(cfg.out_dim)
    gen = torch.Generator().manual_seed(ENTRY_WEIGHT_SEED)
    flax_init_(point, gen)
    flax_init_(ppf, gen)
    point, ppf = point.to(dev).eval(), ppf.to(dev).eval()
    sphere = torch.from_numpy(pcfg.sphere_points()).to(dev)

    def fn(draws, point_encoder, ppf_encoder, pc, normals, n_valid, sph):
        return estimate_pose(point_encoder, ppf_encoder, pc, normals, n_valid, sph, pcfg,
                             draws=draws)

    return fn, (draws, point, ppf, pre.pc, pre.normals, pre.n_valid, sphere)


# ---- the multi-rank dry run --------------------------------------------------

def dryrun_config():
    """mug (regress_right: every loss term) at knn 8."""
    cfg = load_config("mug")
    cfg.knn = 8
    return cfg


def dryrun_batch(cfg, data: int, pair: int):
    """The dry run's global batch, drawn as ``__graft_entry__.py`` draws it
    (``default_rng(0)``): B = max(2, data) samples of 128 random points,
    64·pair pairs each, soft bin targets, aux bits and weights."""
    from cppf_tpu_torch.train.step import Batch

    b, n, p = max(2, data), DRYRUN_POINTS, DRYRUN_PAIRS * pair
    rng = np.random.default_rng(0)
    nb, nr = cfg.tr_num_bins, cfg.rot_num_bins

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    def norm(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    return Batch(pc=f32(rng.normal(size=(b, n, 3))) * 0.1,
                 normals=f32(norm(rng.normal(size=(b, n, 3)))),
                 n_valid=torch.full((b,), n, dtype=torch.int32),
                 point_idxs=torch.from_numpy(rng.integers(0, n, (b, p, 2)).astype(np.int32)),
                 tr_prob=f32(rng.dirichlet(np.ones(nb), (b, p, 2))),
                 rot_prob=f32(rng.dirichlet(np.ones(nr), (b, p, 2))),
                 aux=f32(rng.integers(0, 2, (b, p, 2))),
                 scale_target=f32(rng.normal(size=(b, 3))),
                 aux_weight=f32(rng.uniform(size=(b, p, 2))))


def dryrun_pose_config(cfg, pair: int) -> PoseConfig:
    """The dry run's pose: 64·pair pairs, 32·pair axis votes, 8 rotations,
    ``center_mode`` hier, 2 refine rounds, a 32³ grid."""
    return dataclasses.replace(PoseConfig.from_config(cfg, n_pairs=DRYRUN_PAIRS * pair),
                               rot_subsample=32 * pair, num_rots=8, center_mode="hier",
                               peak_rounds=2, grid_shape=(32, 32, 32))


def _dryrun_rank(rank, world_size, device, job):
    """One rank of :func:`dryrun_multichip`: the sharded train step from the
    seeded init (or ``job["params"]``, a JAX params tree), then the
    pair-sharded pose of sample 0 with the stepped weights."""
    from cppf_tpu_torch.parallel.mesh import _factor, make_mesh, shard_batch
    from cppf_tpu_torch.parallel.pose import sharded_estimate_pose
    from cppf_tpu_torch.parallel.train_step import data_parallel_train_step
    from cppf_tpu_torch.train import step

    pin_float32()
    if device.type == "cpu":
        torch.set_num_threads(1)
    mesh = make_mesh(world_size, shape=_factor(world_size), device=device)
    cfg = job["cfg"]
    statics = step.TrainStatics.from_config(cfg)
    state = step.init_train_state(cfg, device, params=job.get("params"))
    local = shard_batch(job["batch"].to(device), mesh)
    comps = data_parallel_train_step(state, local, statics, mesh)
    params = state.opt.param_groups[0]["params"]
    out = dict(mesh=mesh.shape, comps={k: v.cpu() for k, v in comps.items()},
               grads=[p.grad.cpu() for p in params], weights=[p.detach().cpu() for p in params],
               traffic=dict(mesh.traffic))
    state.point.eval()
    state.ppf.eval()
    pcfg = job["pcfg"]
    batch = job["batch"]
    draws = PoseDraws.from_jax_keys(pcfg, threefry.key(0), threefry.key(DRYRUN_POSE_KEY), device,
                                    1)
    pose = sharded_estimate_pose(mesh, state.point, state.ppf, batch.pc[0].to(device),
                                 batch.normals[0].to(device),
                                 torch.tensor(DRYRUN_POINTS, device=device),
                                 torch.from_numpy(pcfg.sphere_points()).to(device), pcfg, draws)
    out["pose"] = {k: v.cpu() for k, v in pose._asdict().items()}
    return out


def dryrun_multichip(n_devices: int, backend: Optional[str] = None,
                     devices: Optional[Sequence[str]] = None, params=None,
                     timeout_s: float = 600.0) -> list:
    """One sharded train step and one pair-sharded pose over ``n_devices``
    ranks (``parallel/launch.py::run_ranks``) in a ``_factor(n)`` (data,
    pair) mesh, as ``__graft_entry__.dryrun_multichip`` runs them over a
    JAX mesh: mug at knn 8, B = max(2, data) samples of 128 points, 64·pair
    pairs a sample; then ``sharded_estimate_pose`` of sample 0.  Ranks go
    on ``devices`` (default: the cards in turn, ``cuda:r % count``), over
    ``backend`` (default NCCL when every rank has a card of its own, else
    gloo).  ``params`` (a JAX params tree) replaces the seeded init.
    Raises unless the loss and the pose are finite; returns every rank's
    result (mesh shape, loss components, gradients, weights after the step,
    collective traffic, the pose)."""
    from cppf_tpu_torch.parallel.launch import run_ranks
    from cppf_tpu_torch.parallel.mesh import _factor

    if devices is None:
        resolve_device(None)
        count = torch.cuda.device_count()
        devices = [f"cuda:{r % count}" for r in range(n_devices)]
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices for {n_devices} ranks")
    if backend is None:
        backend = "nccl" if len(set(devices)) == n_devices and "cpu" not in devices else "gloo"
    data, pair = _factor(n_devices)
    cfg = dryrun_config()
    job = dict(cfg=cfg, batch=dryrun_batch(cfg, data, pair), pcfg=dryrun_pose_config(cfg, pair),
               params=params)
    with tempfile.TemporaryDirectory() as work:
        ranks = run_ranks(_dryrun_rank, backend, list(devices), job, work, timeout_s)
    r0 = ranks[0]
    loss = float(r0["comps"]["loss"])
    if not np.isfinite(loss):
        raise RuntimeError("non-finite loss in the multichip dry run")
    if not all(bool(torch.isfinite(r["pose"]["RT"]).all()) for r in ranks):
        raise RuntimeError("non-finite pose in the multichip dry run")
    b, p = job["batch"].point_idxs.shape[:2]
    print(f"dryrun_multichip OK (train): mesh=({data} data x {pair} pair), {backend} on "
          f"{devices[0]}, B={b}, P={p}, loss={loss:.4f}")
    print(f"dryrun_multichip OK (inference): sharded estimate_pose "
          f"T={[round(v, 3) for v in r0['pose']['T'].tolist()]}, "
          f"n_filtered={int(r0['pose']['n_filtered'])}")
    return ranks


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="The port's entry points")
    ap.add_argument("what", nargs="?", default="entry", choices=("entry", "multichip"))
    ap.add_argument("n", nargs="?", type=int, default=8, help="ranks of the dry run")
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    if args.what == "multichip":
        devices = None if args.device is None else [args.device] * args.n
        dryrun_multichip(args.n, backend=args.backend, devices=devices)
        return
    fn, example_args = entry(args.device)
    out = fn(*example_args)
    print("entry OK:", {k: tuple(getattr(out, k).shape) for k in ("T", "R", "scale")})


if __name__ == "__main__":
    main()
