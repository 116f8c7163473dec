"""Checkpoints of training (counterpart of cppf_tpu/train/checkpoints.py).

A train state (both encoders' state_dicts, the Adam state, the step) is one
``torch.save`` file ``<out_dir>/<name>.pt``, under the names the trainer
uses: ``epoch<n>``, ``last``, ``best``, ``best_decode``.  The weights that
inference serves go to ``<out_dir>/params_best.npz`` in the flat flax
layout (``models/convert.py``), beside the config snapshot
``config.yaml``, so that ``CategoryRunner(category, ckpt_path=<parent of
out_dir>)`` serves them when ``out_dir`` is named by the category; the
zero-shot model's proposal-contrast selection goes beside them as
``params_zs.npz``, which ``python -m cppf_tpu_torch.eval.zero_shot --ckpt
<out_dir>`` serves first.
"""
from __future__ import annotations

import os

import torch

from cppf_tpu_torch.config import Config
from cppf_tpu_torch.models.convert import load_npz_params, params_to_state_dicts, save_npz_params
from cppf_tpu_torch.train.step import TrainState


def state_path(ckpt_dir: str, name: str) -> str:
    return os.path.join(ckpt_dir, f"{name}.pt")


def save_train_state(ckpt_dir: str, state: TrainState, name: str) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = state_path(ckpt_dir, name)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"point": state.point.state_dict(), "ppf": state.ppf.state_dict(),
                "opt": state.opt.state_dict(), "step": state.step}, tmp)
    os.replace(tmp, path)


def load_train_state(ckpt_dir: str, state: TrainState, name: str) -> TrainState:
    """Load ``<name>.pt`` into ``state`` (its modules and optimizer, on
    their device) and return it."""
    device = next(state.point.parameters()).device
    saved = torch.load(state_path(ckpt_dir, name), map_location=device, weights_only=True)
    state.point.load_state_dict(saved["point"], strict=True)
    state.ppf.load_state_dict(saved["ppf"], strict=True)
    state.opt.load_state_dict(saved["opt"])
    state.step = int(saved["step"])
    return state


def save_params(ckpt_dir: str, state: TrainState, cfg: Config, name: str = "params_best") -> str:
    """Write the weights as ``<name>.npz`` and the config snapshot
    ``config.yaml``; returns the weights' path."""
    path = os.path.join(ckpt_dir, f"{name}.npz")
    save_npz_params(path, state.point, state.ppf)
    cfg.save(os.path.join(ckpt_dir, "config.yaml"))
    return path


def load_params_into(ckpt_dir: str, state: TrainState, name: str = "params_best") -> TrainState:
    """Load ``<name>.npz`` into the encoders of ``state`` (a warm start:
    the optimizer and step stay as they are)."""
    point_sd, ppf_sd = params_to_state_dicts(load_npz_params(os.path.join(ckpt_dir,
                                                                          f"{name}.npz")))
    state.point.load_state_dict(point_sd, strict=True)
    state.ppf.load_state_dict(ppf_sd, strict=True)
    return state

