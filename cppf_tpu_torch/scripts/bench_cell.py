"""The main cell of the JAX package's ``bench.py`` (bench.py:218-305) in the
port: the poses it times, on the draws it times them with.  It times
nothing: it gives a benchmark the cell's path, and the tests and
``chip_smoke.py`` (phase 21) hold its poses to JAX's.

- The cloud: ``PRIMITIVES["bottle"]`` sampled at 8000 points from
  ``default_rng(0)``, offset by (0.1, -0.05, 0.7), padded to 8192 rows
  (:func:`bench_cloud`), preprocessed at ``npoint_pad`` 4096 and bottle's
  ``knn`` with the jitter of ``PRNGKey(0)``.
- The poses: bottle's repo config (``load_config("bottle")``), 100 000
  pairs, the encoders of ``checkpoints/bottle/params_best`` (orbax), on the
  draws of ``PRNGKey(10 + i)`` (``bench.py``'s ``dispatch(i, ...)``), with
  nearest splat (the bench's "fast" mode) or trilinear splat (its "parity"
  mode): :func:`pose_cell`.
- The batch: ``preprocess_cloud_batch`` of 4 copies of the cloud on the
  keys ``split(PRNGKey(3), 8)[:4]``, then ``estimate_pose_batch`` of
  dispatch ``i`` on ``split(PRNGKey(200 + i), 4)``, nearest splat:
  :func:`pose_batch`.  JAX's ``estimate_pose_batch`` is a ``lax.map`` of
  ``estimate_pose`` over the rows (cppf_tpu/pipeline/pose.py:805-839), so
  row r poses on key r as a single pose would.

Usage:
    python -m cppf_tpu_torch.scripts.bench_cell [--device cpu] [--n_pairs 100000]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from cppf_tpu_torch.config import REPO_ROOT, load_config
from cppf_tpu_torch.core import threefry
from cppf_tpu_torch.data.synthetic import PRIMITIVES, sample_surface
from cppf_tpu_torch.device import pin_float32, resolve_device
from cppf_tpu_torch.models.convert import load_encoders
from cppf_tpu_torch.pipeline.pose import (PoseConfig, PoseDraws, PoseResult, decode_translation,
                                          estimate_pose, estimate_pose_batch, grid_frame,
                                          pair_predictions)
from cppf_tpu_torch.pipeline.preprocess import (PreprocessedCloud, preprocess_cloud,
                                                preprocess_cloud_batch)
from cppf_tpu_torch.train.checkpoints import load_params

CATEGORY = "bottle"
N_RAW = 8000
N_RAW_PAD = 8192
OFFSET = (0.1, -0.05, 0.7)
NPOINT_PAD = 4096
N_PAIRS = 100000
MODES = ("nearest", "trilinear")
# bench.py's keys: the cloud's jitter, dispatch i's pose, the batch's
PRE_SEED = 0
POSE_SEED = 10
BATCH = 4
BATCH_PRE_SEED = 3
BATCH_SEED = 200
KEYS = tuple(threefry.key(POSE_SEED + i) for i in range(4))


class BenchInputs(NamedTuple):
    pre: PreprocessedCloud  # the cloud, preprocessed as bench.py's ``pre``
    encoders: tuple         # (point encoder, PPF encoder)
    pcfg: PoseConfig        # bottle's, at ``n_pairs``; trilinear splat, as from_config gives
    sphere: torch.Tensor    # [480, 3] the axis vote's sphere
    device: torch.device


def bench_cloud():
    """bench.py:222-225: (the padded cloud [8192, 3] float32, its 8000 real
    rows)."""
    rng = np.random.default_rng(0)
    pc_cam = sample_surface(PRIMITIVES[CATEGORY](), N_RAW, rng) + np.float32(OFFSET)
    pad = np.zeros((N_RAW_PAD, 3), np.float32)
    pad[:N_RAW] = pc_cam
    return pad, N_RAW


def _jitter(keys, device) -> List[torch.Tensor]:
    """``jax.random.normal(key, (8192, 3))`` of each key: the jitter of
    ``preprocess_cloud`` on that key."""
    return threefry.draw_many([("normal", k, (N_RAW_PAD, 3)) for k in keys], device)


def bench_inputs(device=None, n_pairs: int = N_PAIRS) -> BenchInputs:
    """The preprocessed cloud, the encoders, ``pcfg`` and the sphere of the
    cell on ``device`` (``cuda`` unless told otherwise; raises without a
    card)."""
    device = resolve_device(device)
    pin_float32()
    cfg = load_config(CATEGORY)
    pad, n_raw = bench_cloud()
    (noise,) = _jitter([threefry.key(PRE_SEED)], device)
    pre = preprocess_cloud(torch.from_numpy(pad).to(device), n_raw, cfg.res,
                           npoint_pad=NPOINT_PAD, knn=cfg.knn, noise=noise)
    params = load_params(os.path.join(REPO_ROOT, "checkpoints", CATEGORY), "params_best")
    encoders = load_encoders(params, cfg.out_dim, device)
    pcfg = PoseConfig.from_config(cfg, n_pairs=n_pairs)
    sphere = torch.from_numpy(pcfg.sphere_points()).to(device)
    return BenchInputs(pre, encoders, pcfg, sphere, device)


def mode_config(inputs: BenchInputs, mode: str) -> PoseConfig:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return dataclasses.replace(inputs.pcfg, splat=mode)


def pose_draws(pcfg: PoseConfig, key, device) -> PoseDraws:
    """The draws ``estimate_pose(key, ...)`` consumes (no jitter: the cloud
    is preprocessed apart)."""
    return PoseDraws.from_jax_keys(pcfg, None, key, device, n_raw=0)


def pose_cell(mode: str, keys: Sequence = KEYS, device=None,
              inputs: Optional[BenchInputs] = None) -> List[PoseResult]:
    """``estimate_pose`` of the cell's cloud on the draws of each JAX key of
    ``keys`` (two uint32 words; bench.py's ``dispatch(i)`` is
    ``threefry.key(10 + i)``) with ``mode`` splat.  ``inputs`` default to
    :func:`bench_inputs` on ``device``."""
    inputs = inputs or bench_inputs(device)
    pcfg = mode_config(inputs, mode)
    pre, (point, ppf) = inputs.pre, inputs.encoders
    return [estimate_pose(point, ppf, pre.pc, pre.normals, pre.n_valid, inputs.sphere, pcfg,
                          nbr_idx=pre.nbr_idx, draws=pose_draws(pcfg, k, inputs.device))
            for k in keys]


def batch_cloud(device) -> PreprocessedCloud:
    """bench.py:290-295: 4 copies of the cloud, row r preprocessed on key r
    of ``split(PRNGKey(3), 8)``."""
    cfg = load_config(CATEGORY)
    pad, n_raw = bench_cloud()
    keys = threefry.split(threefry.key(BATCH_PRE_SEED), 2 * BATCH)[:BATCH]
    pads = torch.from_numpy(np.broadcast_to(pad, (BATCH, *pad.shape)).copy()).to(device)
    return preprocess_cloud_batch(pads, [n_raw] * BATCH, cfg.res,
                                  torch.stack(_jitter(keys, device)), npoint_pad=NPOINT_PAD,
                                  knn=cfg.knn)


def pose_batch(i: int, device=None, inputs: Optional[BenchInputs] = None,
               pre_b: Optional[PreprocessedCloud] = None) -> PoseResult:
    """bench.py's ``dispatch_b(i)``: ``estimate_pose_batch`` of the batch's
    rows on ``split(PRNGKey(200 + i), 4)``, nearest splat; the fields
    stacked [4, ...].  ``pre_b`` defaults to :func:`batch_cloud`."""
    inputs = inputs or bench_inputs(device)
    pre_b = pre_b if pre_b is not None else batch_cloud(inputs.device)
    pcfg = mode_config(inputs, "nearest")
    keys = threefry.split(threefry.key(BATCH_SEED + i), BATCH)
    draws = [pose_draws(pcfg, k, inputs.device) for k in keys]
    point, ppf = inputs.encoders
    return estimate_pose_batch(point, ppf, pre_b.pc, pre_b.normals, pre_b.n_valid,
                               inputs.sphere, pcfg, draws, pre_b.nbr_idx)


@torch.no_grad()
def center_grid(inputs: BenchInputs, mode: str, key, pre: Optional[PreprocessedCloud] = None):
    """The dense center-vote grid of the pose on ``key`` (its pair
    predictions and translation decode, summed by ``ppf_vote_dense``), as
    the JAX ``ppf_vote`` grid that ``scripts/export_torch_bench_cell.py``
    reads the ties from: (grid [gx, gy, gz], corner [3]).  Not on the
    pose's path: it says whether a peak is a tie."""
    from cppf_tpu_torch.ops.voting import ppf_vote_dense

    pcfg = mode_config(inputs, mode)
    pre = pre if pre is not None else inputs.pre
    draws = pose_draws(pcfg, key, inputs.device)
    point, ppf = inputs.encoders
    point_idxs, preds = pair_predictions(point, ppf, pre.pc, pre.normals, pre.n_valid, pcfg,
                                         draws.pair_u, pre.nbr_idx)
    preds_tr = decode_translation(preds, draws.tr_gumbel, pcfg)
    valid = torch.arange(pre.pc.shape[0], device=pre.pc.device) < pre.n_valid
    corner, dims = grid_frame(pre.pc, valid, pcfg)
    res = torch.tensor(pcfg.res, dtype=pre.pc.dtype, device=pre.pc.device)
    grid = ppf_vote_dense(pre.pc, preds_tr, torch.ones_like(pre.pc[:, 0]), point_idxs, corner,
                          res, dims, pcfg.grid_shape, n_rots=pcfg.num_rots,
                          adaptive=pcfg.adaptive_voting, splat=pcfg.splat)
    return grid, corner


def describe(out: PoseResult) -> str:
    return (f"T {np.round(out.T.cpu().numpy(), 6).tolist()} up "
            f"{np.round(out.up.cpu().numpy(), 6).tolist()} scale "
            f"{np.round(out.scale.cpu().numpy(), 6).tolist()} survivors {int(out.n_filtered)} "
            f"peak {float(out.grid_max):g}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--n_pairs", type=int, default=N_PAIRS)
    return ap


def main(argv=None):
    """Poses the cell's 4 keys in both splat modes and the batch's first
    dispatch; prints each pose and returns them
    ({mode: [PoseResult]}, the batch's PoseResult)."""
    args = build_parser().parse_args(argv)
    inputs = bench_inputs(args.device, args.n_pairs)
    print(f"bench cell on {inputs.device}: {CATEGORY}, {int(inputs.pre.n_valid)} of "
          f"{NPOINT_PAD} points, {inputs.pcfg.n_pairs} pairs, grid {inputs.pcfg.grid_shape}",
          flush=True)
    poses = {}
    for mode in MODES:
        poses[mode] = pose_cell(mode, KEYS, inputs=inputs)
        for i, out in enumerate(poses[mode]):
            print(f"{mode} splat, PRNGKey({POSE_SEED + i}): {describe(out)}", flush=True)
    batch = pose_batch(0, inputs=inputs)
    for r in range(BATCH):
        row = PoseResult(*(f[r] for f in batch))
        print(f"batch of {BATCH}, nearest splat, split(PRNGKey({BATCH_SEED}), {BATCH})[{r}]: "
              f"{describe(row)}", flush=True)
    return poses, batch


if __name__ == "__main__":
    main()
