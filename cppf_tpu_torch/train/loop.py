"""Training entry point (counterpart of cppf_tpu/train/loop.py).

The host renders raw canonical clouds (``data/shapenet.py``: the native
rasterizer, one sample after another); :func:`build_batch` makes the rest
on the device — jitter, voxels, normals with random signs, pairs, targets,
soft bins — and :func:`~cppf_tpu_torch.train.step.train_step` takes one
Adam step.  Checkpoints: every 20 epochs, the last and the best-loss
states, and ``params_best`` chosen by decode validation when it is on
(``decode_val_every``, the classification head), else by the loss.  The
regression head (``cls_bins: false``, the zero-shot model) with
``contrast_val_every`` > 0 is scored every that many epochs on the
proposal-contrast scene (``eval/contrast_val.py``), each score appended to
``zs_metrics.jsonl``, and ``params_zs`` written on a new best.  A run
resumes from its last state.

The random draws follow the JAX trainer's key schedule
(``fold_in(PRNGKey(seed + 1), start_epoch)``, one split a step, one a
decode validation; ``core/threefry.py``), so a run of the port meets the
draws of the JAX run with the same config.  The contrast validation draws
from its own ``np.random.default_rng(0)``, never from that key.

Usage:
    python -m cppf_tpu_torch.train.loop category=bowl [max_epoch=200] [epoch_len=200] \\
        [out_dir=checkpoints_torch/bowl] [resume=true] [device=cpu] [key=value ...]

It runs on ``cuda`` unless ``device=cpu``, and raises without a card.
``CategoryRunner(category, ckpt_path=<parent of out_dir>)`` serves what it
trains.
"""
from __future__ import annotations

import json
import logging
import math
import os
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from cppf_tpu_torch.config import REPO_ROOT, Config, load_config, parse_cli_overrides
from cppf_tpu_torch.core import threefry
from cppf_tpu_torch.core.targets import (base_membership, generate_targets, radial_asymmetry,
                                         sample_pair_idxs, scale_target, soft_bin_targets)
from cppf_tpu_torch.data.shapenet import ShapeNetRenderDataset
from cppf_tpu_torch.device import pin_float32, resolve_device
from cppf_tpu_torch.parallel.input_pipeline import shard_dataset
from cppf_tpu_torch.pipeline.preprocess import preprocess_cloud
from cppf_tpu_torch.train import checkpoints
from cppf_tpu_torch.train.step import Batch, TrainStatics, init_train_state, train_step
from cppf_tpu_torch.utils.meters import AverageMeter

log = logging.getLogger("cppf_tpu_torch.train")

# where a run writes by default: <DEFAULT_ROOT>/<category> (gitignored)
DEFAULT_ROOT = os.path.join(REPO_ROOT, "checkpoints_torch")


class BatchDraws(NamedTuple):
    """Every random number :func:`build_batch` consumes, a row a sample."""

    jitter: torch.Tensor  # [B, npoint_max, 3] standard normals of the preprocess jitter
    pair_u: torch.Tensor  # [B, train_pairs, 2] pair-sampling uniforms
    keep_sign: torch.Tensor  # [B, npoint_pad, 1] bool: a normal keeps its sign, else flips

    @classmethod
    def sample(cls, generator: torch.Generator, batch_size: int, cfg: Config,
               device) -> "BatchDraws":
        def rand(*shape):
            return torch.rand(shape, generator=generator, device=device)

        return cls(torch.randn((batch_size, cfg.npoint_max, 3), generator=generator,
                               device=device),
                   rand(batch_size, cfg.train_pairs, 2),
                   rand(batch_size, cfg.npoint_pad, 1) < 0.5)

    @classmethod
    def from_jax_key(cls, key, batch_size: int, cfg: Config, device) -> "BatchDraws":
        """The draws of the JAX ``build_batch`` on ``key``: ``split(key, B)``,
        each row's key split into preprocess / pairs / sign keys; the sign
        is ``bernoulli(0.5)``.  One pass of the hash for all of them."""
        requests = []
        for k in threefry.split((int(key[0]), int(key[1])), batch_size):
            pre, pairs, sign = threefry.split(k, 3)
            requests += [("normal", pre, (cfg.npoint_max, 3)),
                         ("uniform", pairs, (cfg.train_pairs, 2)),
                         ("bernoulli", sign, (cfg.npoint_pad, 1))]
        draws = threefry.draw_many(requests, device)
        return cls(*(torch.stack(draws[i::3]) for i in range(3)))


def build_batch(cfg: Config, draws: BatchDraws, samples, npoint_pad: int, device) -> Batch:
    """A device Batch from host RenderedSamples: each cloud padded to
    ``npoint_max`` (cut beyond), then, a sample after another,
    ``preprocess_cloud`` on its jitter, normals with random signs, pairs,
    targets, soft bins (``cls_bins``) or raw targets, the optional aux and
    up-angle weights."""
    if cfg.up_rot_base and not cfg.aux_weighted:
        raise ValueError("up_rot_base requires aux_weighted")
    n_raw_pad = cfg.npoint_max
    pcs = np.zeros((len(samples), n_raw_pad, 3), np.float32)
    n_raws = []
    for i, s in enumerate(samples):
        pc = s.pc[:n_raw_pad]
        pcs[i, :len(pc)] = pc
        n_raws.append(len(pc))
    pcs = torch.from_numpy(pcs).to(device)
    bounds = torch.from_numpy(np.stack([s.bound for s in samples]).astype(np.float32)).to(device)
    scales = torch.tensor([s.scale for s in samples], dtype=torch.float32, device=device)
    rows = []
    for i in range(len(samples)):
        pre = preprocess_cloud(pcs[i], n_raws[i], cfg.res, npoint_pad=npoint_pad, knn=cfg.knn,
                               noise=draws.jitter[i])
        normals = pre.normals * torch.where(draws.keep_sign[i], 1.0, -1.0)
        idxs = sample_pair_idxs(draws.pair_u[i], pre.n_valid)
        asym = radial_asymmetry(pre.pc, pre.n_valid) if cfg.aux_asym else None
        base = base_membership(pre.pc, pre.n_valid) if cfg.up_rot_base else None
        tgt = generate_targets(pre.pc, normals, idxs, cfg.up_sym, cfg.right_sym, cfg.z_right,
                               asym=asym, base=base)
        st = scale_target(bounds[i], scales[i], cfg.scale_mean)
        if cfg.cls_bins:
            tr_t, rot_t = soft_bin_targets(tgt, cfg.vote_range, cfg.tr_num_bins,
                                           cfg.rot_num_bins)
        else:
            tr_t, rot_t = tgt.tr, tgt.rot
        rows.append((pre.pc, normals, pre.n_valid, idxs, tr_t, rot_t, tgt.rot_aux, st,
                     tgt.aux_weight if cfg.aux_weighted else None, tgt.up_rot_weight))
    return Batch(*(None if f[0] is None else torch.stack(f) for f in zip(*rows)))


def loop_step(cfg: Config, ds, rng, state, statics: TrainStatics, device, mark=None):
    """One step of the epoch loop: the host renders a batch of samples, the
    next split of ``rng`` draws the batch's randoms, :func:`build_batch`
    makes it on the device and :func:`train_step` takes one Adam step.
    ``mark(part)``, when given, is called after each part ("render",
    "draws", "prep", "step"): the timing hook of ``chip_smoke.py``.
    Returns (the advanced rng, the step's loss components, the batch)."""
    samples = [ds.sample() for _ in range(cfg.batch_size)]
    if mark:
        mark("render")
    rng, rb = threefry.split(rng)
    draws = BatchDraws.from_jax_key(rb, cfg.batch_size, cfg, device)
    if mark:
        mark("draws")
    batch = build_batch(cfg, draws, samples, cfg.npoint_pad, device)
    if mark:
        mark("prep")
    comps = train_step(state, batch, statics)
    if mark:
        mark("step")
    return rng, comps, batch


def _read_jsonl(path: str, key: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        values = [json.loads(line).get(key) for line in f if line.strip()]
    return [v for v in values if v is not None]


def train(cfg: Config, out_dir: Optional[str] = None, epoch_len: Optional[int] = None,
          dataset=None, resume: bool = False, device=None,
          init_params: Optional[dict] = None) -> dict:
    """The epoch loop.  ``init_params`` (a JAX params tree) replaces the
    flax-style init; ``device`` defaults to ``cuda``.  Writes
    ``metrics.jsonl`` (an epoch's mean components), ``decode_metrics.jsonl``,
    ``zs_metrics.jsonl``, the train states, ``params_best.npz`` and
    ``params_zs.npz`` with ``config.yaml`` under ``out_dir``.  TF32 stays off (``pin_float32``): it trains in float32.
    Returns {"state", "best_loss", "history"}."""
    device = resolve_device(device)
    pin_float32()
    out_dir = out_dir or os.path.join(DEFAULT_ROOT, cfg.category)
    os.makedirs(out_dir, exist_ok=True)
    cfg.save(os.path.join(out_dir, "config.yaml"))

    ds = dataset or ShapeNetRenderDataset(cfg, seed=cfg.seed)
    if dataset is None:
        # this process's share of the models and its own generator, reseeded
        # from 0 as the JAX trainer's (cppf_tpu/train/loop.py:126-132)
        shard_dataset(ds)
    if epoch_len is not None:
        ds.epoch_len = epoch_len
    steps = max(1, len(ds) // cfg.batch_size)
    statics = TrainStatics.from_config(cfg)
    state = init_train_state(cfg, device, params=init_params)
    start_epoch = 0
    metrics_path = os.path.join(out_dir, "metrics.jsonl")
    resume_name = next((n for n in ("last", "best")
                        if os.path.exists(checkpoints.state_path(out_dir, n))), None)
    if resume and resume_name:
        checkpoints.load_train_state(out_dir, state, name=resume_name)
        start_epoch = state.step // steps
        log.info("resumed from %s at step %d (epoch %d)", out_dir, state.step, start_epoch)
    elif resume and os.path.exists(os.path.join(out_dir, "params_best.npz")):
        # weights only, a fresh optimizer; the epoch count from the log
        checkpoints.load_params_into(out_dir, state)
        epochs = _read_jsonl(metrics_path, "epoch")
        start_epoch = max(epochs) + 1 if epochs else 0
        log.info("warm-started from %s/params_best.npz (epoch %d)", out_dir, start_epoch)

    rng = threefry.fold_in(threefry.key(cfg.seed + 1), start_epoch)
    best_loss = math.inf
    best_dv = math.inf
    decode_val = None
    if cfg.decode_val_every > 0 and cfg.cls_bins:
        from cppf_tpu_torch.train.decode_val import DecodeValidator

        decode_val = DecodeValidator(cfg, device)
        best_dv = min(_read_jsonl(os.path.join(out_dir, "decode_metrics.jsonl"), "dv_score"),
                      default=math.inf)
    val_scene = None
    best_zs = -math.inf
    zs_path = os.path.join(out_dir, "zs_metrics.jsonl")
    if cfg.contrast_val_every > 0 and not cfg.cls_bins:
        from cppf_tpu_torch.eval.contrast_val import make_val_scene

        val_scene = make_val_scene(cfg.category)
        # the standing best of an earlier run in this directory
        best_zs = max(_read_jsonl(zs_path, "zs_score"), default=-math.inf)
    if start_epoch > 0:
        # the best loss so far, so that the first epoch after a resume
        # cannot replace params_best with a worse state
        best_loss = min(_read_jsonl(metrics_path, "loss"), default=math.inf)
    history = []
    for epoch in range(start_epoch, cfg.max_epoch):
        t0 = time.time()
        # the components stay on the device until the epoch's end: reading
        # them every step would wait for the device before the next render
        step_comps = []
        for _ in range(steps):
            rng, comps, _ = loop_step(cfg, ds, rng, state, statics, device)
            step_comps.append(comps)
        meters: dict = {}
        for comps in step_comps:
            for k, v in sorted(comps.items()):
                meters.setdefault(k, AverageMeter()).update(float(v))
        avg = {k: m.avg for k, m in meters.items()}
        history.append(avg)
        with open(metrics_path, "a") as f:
            f.write(json.dumps({"epoch": epoch, "wall_s": round(time.time() - t0, 2), **avg})
                    + "\n")
        log.info("epoch %d  %s  (%.1fs)", epoch,
                 "  ".join(f"{k}={v:.4f}" for k, v in avg.items()), time.time() - t0)
        if epoch % 20 == 0:
            checkpoints.save_train_state(out_dir, state, name=f"epoch{epoch}")
        checkpoints.save_train_state(out_dir, state, name="last")
        if avg["loss"] < best_loss:
            best_loss = avg["loss"]
            checkpoints.save_train_state(out_dir, state, name="best")
            if decode_val is None:
                checkpoints.save_params(out_dir, state, cfg)
        if decode_val is not None and ((epoch + 1) % cfg.decode_val_every == 0
                                       or epoch == cfg.max_epoch - 1):
            rng, kdv = threefry.split(rng)
            dv = decode_val(state.point, state.ppf, kdv)
            dv["epoch"] = epoch
            with open(os.path.join(out_dir, "decode_metrics.jsonl"), "a") as f:
                f.write(json.dumps(dv) + "\n")
            log.info("decode val epoch %d: %s", epoch,
                     "  ".join(f"{k}={v}" for k, v in sorted(dv.items()) if k != "epoch"))
            if dv["dv_score"] < best_dv:
                best_dv = dv["dv_score"]
                checkpoints.save_params(out_dir, state, cfg)
                checkpoints.save_train_state(out_dir, state, name="best_decode")
        if val_scene is not None and (epoch + 1) % cfg.contrast_val_every == 0:
            from cppf_tpu_torch.eval.contrast_val import proposal_contrast_score

            zs = proposal_contrast_score(val_scene[0], val_scene[1], (state.point, state.ppf),
                                         cfg, device=device)
            zs["epoch"] = epoch
            with open(zs_path, "a") as f:
                f.write(json.dumps(zs) + "\n")
            log.info("contrast val epoch %d: score=%.1f hits=%d false=%d", epoch, zs["zs_score"],
                     zs["zs_hits"], zs["zs_false"])
            if zs["zs_score"] > best_zs:
                best_zs = zs["zs_score"]
                checkpoints.save_params(out_dir, state, cfg, name="params_zs")
    return {"state": state, "best_loss": best_loss, "history": history}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s][%(name)s] %(message)s",
                        force=True)
    argv = argv if argv is not None else sys.argv[1:]
    overrides = parse_cli_overrides(argv)
    category = overrides.pop("category", "bowl")
    out_dir = overrides.pop("out_dir", None)
    epoch_len = overrides.pop("epoch_len", None)
    resume = bool(overrides.pop("resume", False))
    device = resolve_device(overrides.pop("device", None))
    cfg = load_config(category, overrides)
    log.info("training category=%s res=%g bins=(%d,%d) pairs=%d on %s", cfg.category, cfg.res,
             cfg.tr_num_bins, cfg.rot_num_bins, cfg.train_pairs, device)
    return train(cfg, out_dir=out_dir, epoch_len=epoch_len, resume=resume, device=device)


if __name__ == "__main__":
    main()
