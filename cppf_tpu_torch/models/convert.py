"""Carry the flax weights across to the torch modules: the two encoders
and the laptop segmenter.

Mapping, leaf by leaf (module paths keep the flax names):
    Dense.kernel [in, out]   → Linear.weight [out, in] (transposed)
    Dense.bias               → Linear.bias
    LayerNorm.scale / .bias  → LayerNorm.weight / .bias
    Conv.kernel [kh, kw, in, out] (HWIO) → Conv2d.weight [out, in, kh, kw]
    Conv.bias                → Conv2d.bias
    InstanceNorm.scale / .bias / .mean / .var → weight / bias / mean / var

The weights travel as a flat ``.npz`` (``scripts/export_torch_assets.py``
writes it from the orbax checkpoint, :func:`save_npz_params` from the torch
modules): one key per leaf, path parts joined by ``/``, e.g.
``point/params/spconv0/kernel/lin0/kernel``.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from cppf_tpu_torch.models.encoders import PointEncoder, PPFEncoder
from cppf_tpu_torch.models.segmenter import FCNResNet50

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _flatten(tree: dict, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """One flax module tree ({"params": ...}) → a torch state_dict."""
    sd = {}
    for path, arr in _flatten(params["params"]).items():
        *mod, leaf = path
        if leaf == "kernel":
            arr = arr.T
        sd[".".join(mod + [_LEAF[leaf]])] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return sd


def params_to_state_dicts(params: dict):
    """JAX params tree ``{"point": {"params": ...}, "ppf": {"params": ...}}``
    (as ``cppf_tpu.train.checkpoints.load_params`` returns it, nested numpy)
    → (PointEncoder state_dict, PPFEncoder state_dict)."""
    return _state_dict(params["point"]), _state_dict(params["ppf"])


def modules_to_flat_params(point: nn.Module, ppf: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_to_state_dicts`, flattened: the two
    encoders' weights as the flat flax layout {``"point/params/.../kernel"``:
    array}, Linear weights transposed to [in, out], LayerNorm weights as
    ``scale``."""
    flat = {}
    for top, module in (("point", point), ("ppf", ppf)):
        for name, m in module.named_modules():
            prefix = "/".join([top, "params", *name.split(".")])
            if isinstance(m, nn.Linear):
                leaves = {"kernel": m.weight.T, "bias": m.bias}
            elif isinstance(m, nn.LayerNorm):
                leaves = {"scale": m.weight, "bias": m.bias}
            else:
                continue
            for leaf, t in leaves.items():
                flat[f"{prefix}/{leaf}"] = np.ascontiguousarray(
                    t.detach().cpu().numpy(), np.float32)
    return flat


def _save_flat(path: str, flat: Dict[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def save_npz_params(path: str, point: nn.Module, ppf: nn.Module) -> None:
    """Write both encoders' weights as the flat ``.npz`` that
    :func:`load_npz_params` reads."""
    _save_flat(path, modules_to_flat_params(point, ppf))


_SEG_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "mean",
             "var": "var"}


def segmenter_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """The segmenter's flax tree ``{"params": ...}`` (nested numpy) → the
    state_dict of ``models/segmenter.py::FCNResNet50``: conv kernels HWIO →
    OIHW, norm ``scale`` → ``weight``; each array keeps its dtype."""
    sd = {}
    for path, arr in _flatten(params["params"]).items():
        *mod, leaf = path
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1)
        sd[".".join(mod + [_SEG_LEAF[leaf]])] = torch.from_numpy(np.array(arr))
    return sd


def segmenter_flat_params(model: FCNResNet50) -> Dict[str, np.ndarray]:
    """The inverse of :func:`segmenter_state_dict`, flattened:
    {``"params/layer1_0/conv1/kernel"``: array, ...}."""
    flat = {}
    for name, t in model.state_dict().items():
        *mod, leaf = name.split(".")
        arr = t.detach().cpu().numpy()
        if leaf == "weight" and arr.ndim == 4:
            leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
        elif leaf == "weight":
            leaf = "scale"
        flat["/".join(["params", *mod, leaf])] = np.ascontiguousarray(arr, np.float32)
    return flat


def save_segmenter_npz(path: str, model: FCNResNet50) -> None:
    """Write the segmenter's weights as the flat ``.npz`` that
    ``SegmenterRunner`` and :func:`load_npz_params` read."""
    _save_flat(path, segmenter_flat_params(model))


def load_npz_params(path: str) -> dict:
    """Read the flat ``.npz`` back into the nested params tree."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parts, leaf = key.split("/")
            node = tree
            for p in parts:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def make_encoders(out_dim: int) -> Tuple[PointEncoder, PPFEncoder]:
    """Both encoders with the reference hyper-parameters (cppf_tpu
    pipeline/pose.py::make_models), torch's default init."""
    return (PointEncoder(spfcs=(32, 64, 32, 32), out_dim=32, num_layers=1),
            PPFEncoder(ppffcs=(84, 32, 32, 16), out_dim=out_dim))


def load_encoders(params: dict, out_dim: int, device) -> Tuple[PointEncoder, PPFEncoder]:
    """:func:`make_encoders` with the weights of ``params`` loaded with
    ``strict=True``, in eval mode on ``device``."""
    point, ppf = make_encoders(out_dim)
    point_sd, ppf_sd = params_to_state_dicts(params)
    point.load_state_dict(point_sd, strict=True)
    ppf.load_state_dict(ppf_sd, strict=True)
    return point.to(device).eval(), ppf.to(device).eval()
