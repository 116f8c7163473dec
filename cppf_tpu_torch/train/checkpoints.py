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

Every loader of served weights goes through :func:`maybe_load_any`, in the
JAX package's order: the orbax checkpoint directory ``<name>/`` that the
JAX package writes (``train/orbax.py`` reads it without JAX: the repo's
``checkpoints/<cat>/params_best``, ``bowl_reg/params_zs``,
``laptop_aux/params_best`` and the ``best_decode`` train states), then the
port's ``<name>.npz``, then the reference CPPF's own checkpoints: a
directory that holds ``point_encoder_epoch<name>.pth`` +
``ppf_encoder_epoch<name>.pth`` (the upstream release's layout, ``<name>``
= ``best``).  The port writes no orbax checkpoint, and a JAX train state's
optax ``opt_state`` is not resumed into the port's Adam: only its
``params`` are served.
"""
from __future__ import annotations

import logging
import os
import zipfile
from typing import Optional, Tuple

import torch

from cppf_tpu_torch.config import Config
from cppf_tpu_torch.models.convert import (load_npz_params, load_torch_state_dict,
                                           params_to_state_dicts, point_encoder_from_torch,
                                           ppf_encoder_from_torch, save_npz_params)
from cppf_tpu_torch.train.orbax import restore_numpy
from cppf_tpu_torch.train.step import TrainState

log = logging.getLogger("cppf_tpu_torch.checkpoints")


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
    point_sd, ppf_sd = params_to_state_dicts(load_params(ckpt_dir, name))
    state.point.load_state_dict(point_sd, strict=True)
    state.ppf.load_state_dict(ppf_sd, strict=True)
    return state


def load_params(ckpt_dir: str, name: str = "best") -> dict:
    """The params tree of ``name`` under ``ckpt_dir``: the ``["params"]``
    of the orbax checkpoint ``<ckpt_dir>/<name>/`` when that is a
    directory (as the JAX package's ``load_params`` takes it), else
    ``<ckpt_dir>/<name>.npz``."""
    orbax_dir = os.path.join(ckpt_dir, name)
    if os.path.isdir(orbax_dir):
        return restore_numpy(orbax_dir)["params"]
    return load_npz_params(os.path.join(ckpt_dir, f"{name}.npz"))


def reference_pair(ckpt_dir: str, name: str) -> Tuple[str, str]:
    """The reference's checkpoint pair of ``name`` under ``ckpt_dir``."""
    return (os.path.join(ckpt_dir, f"point_encoder_epoch{name}.pth"),
            os.path.join(ckpt_dir, f"ppf_encoder_epoch{name}.pth"))


def load_reference_pth(point_pth: str, ppf_pth: str) -> dict:
    """A reference checkpoint pair (reference nocs/inference.py:87-88 loads
    these files) as the params tree ``{"point": ..., "ppf": ...}``."""
    return {"point": point_encoder_from_torch(load_torch_state_dict(point_pth)),
            "ppf": ppf_encoder_from_torch(load_torch_state_dict(ppf_pth))}


def maybe_load_any(ckpt_dir: str, name: str = "best") -> Optional[dict]:
    """The params tree of ``name`` under ``ckpt_dir``: the orbax directory
    ``<name>/``, else ``<name>.npz``, else the reference pair
    ``point_encoder_epoch<name>.pth`` + ``ppf_encoder_epoch<name>.pth``,
    else None (half a pair is no pair).  An orbax directory or an ``.npz``
    that does not read is logged and counts as missing, as the JAX
    package's unreadable orbax directory does, so that a driver over many
    categories skips it; a pair that does not map onto the encoders
    raises."""
    orbax_dir = os.path.join(ckpt_dir, name)
    if os.path.isdir(orbax_dir):
        try:
            return restore_numpy(orbax_dir)["params"]
        except (OSError, ValueError, KeyError, TypeError) as e:  # partial save, corrupt
            log.warning("unreadable checkpoint %s (%s: %s): treating it as missing", orbax_dir,
                        type(e).__name__, e)
    npz = os.path.join(ckpt_dir, f"{name}.npz")
    if os.path.isfile(npz):
        try:
            return load_npz_params(npz)
        except (OSError, EOFError, ValueError, zipfile.BadZipFile) as e:  # truncated, foreign
            log.warning("unreadable checkpoint %s (%s: %s): treating it as missing", npz,
                        type(e).__name__, e)
    point_pth, ppf_pth = reference_pair(ckpt_dir, name)
    if os.path.isfile(point_pth) and os.path.isfile(ppf_pth):
        return load_reference_pth(point_pth, ppf_pth)
    return None
