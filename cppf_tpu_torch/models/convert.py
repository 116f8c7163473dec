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

The reference CPPF's own checkpoints are bare ``.pth`` state_dicts
(``point_encoder_epochbest.pth`` / ``ppf_encoder_epochbest.pth``, reference
nocs/inference.py:87-88; the laptop segmenter a torchvision
``fcn_resnet50`` whose BatchNorms became InstanceNorms with running
statistics, reference train_laptop_aux.py:26-27).  ``*_from_torch`` maps
them onto the flax-layout tree that :func:`load_npz_params` returns, and
``*_to_torch`` back (counterparts of cppf_tpu/models/convert.py, with the
reference module names: ``spconvs.0.kernel.3`` is ``spconv0.kernel.lin1``,
``res_layers.0.fc0`` is ``res0.fc0``, ``backbone.layer3.0.downsample.1`` is
``layer3_0.down_bn``).  A key of a reference state_dict that the mapping
does not read raises, where the JAX package drops it: a second SPRIN layer
under ``num_layers=1`` would otherwise be served as a truncated network.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, Sequence, Tuple

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


# ---- the reference's .pth state_dicts ---------------------------------------
# (torch leaf, flax leaf) of each kind of module; a kernel is transposed
# between torch's [out, in(, kh, kw)] and flax's [in, out] / HWIO
_DENSE = (("weight", "kernel"), ("bias", "bias"))
_LN = (("weight", "scale"), ("bias", "bias"))
_CONV = (("weight", "kernel"),)
_CONV_BIAS = _CONV + (("bias", "bias"),)
_NORM = (("weight", "scale"), ("bias", "bias"))
_STATS = (("running_mean", "mean"), ("running_var", "var"))

# a module: (torch prefix, flax path, its leaves)
RefModule = Tuple[str, Tuple[str, ...], Tuple[Tuple[str, str], ...]]


def _to_flax(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0))


def _to_ref(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1))


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _point_modules(num_layers: int, n_spfcs: int) -> Iterator[RefModule]:
    """The reference PointEncoder's modules: each SPRIN layer's kernel MLP
    (a Sequential of [Linear, LayerNorm, ReLU] × ``n_spfcs`` and a Linear),
    its output Linear and LayerNorm, and its global-info Linear."""
    for i in range(num_layers):
        for j in range(n_spfcs):
            yield f"spconvs.{i}.kernel.{3 * j}", (f"spconv{i}", "kernel", f"lin{j}"), _DENSE
            yield f"spconvs.{i}.kernel.{3 * j + 1}", (f"spconv{i}", "kernel", f"ln{j}"), _LN
        yield f"spconvs.{i}.kernel.{3 * n_spfcs}", (f"spconv{i}", "kernel", "lin_out"), _DENSE
        yield f"spconvs.{i}.outnet", (f"spconv{i}", "outnet"), _DENSE
        yield f"spconvs.{i}.layer_norm", (f"spconv{i}", "norm"), _LN
        yield f"aggrs.{i}.linear", (f"aggr{i}", "linear"), _DENSE


def _ppf_modules(n_res: int, has_fc0) -> Iterator[RefModule]:
    """The reference PPFEncoder's modules: each residual layer's fc1, fc2
    and, where ``has_fc0(i)`` (its widths differ), the fc0 shortcut; then
    ``final``."""
    for i in range(n_res):
        for fc in ("fc1", "fc2", "fc0"):
            if fc != "fc0" or has_fc0(i):
                yield f"res_layers.{i}.{fc}", (f"res{i}", fc), _DENSE
    yield "final", ("final",), _DENSE


def _fcn_modules(layers: Sequence[int], has_down, stats: bool) -> Iterator[RefModule]:
    """torchvision fcn_resnet50's modules, without its aux classifier: a
    block has a downsample where ``has_down(its torchvision prefix, its
    flax name)``; with ``stats`` each norm also carries running
    statistics."""
    norm = _NORM + _STATS if stats else _NORM
    yield "backbone.conv1", ("stem_conv",), _CONV
    yield "backbone.bn1", ("stem_bn",), norm
    for li, blocks in enumerate(layers):
        for b in range(blocks):
            ref, ours = f"backbone.layer{li + 1}.{b}", f"layer{li + 1}_{b}"
            for n in (1, 2, 3):
                yield f"{ref}.conv{n}", (ours, f"conv{n}"), _CONV
                yield f"{ref}.bn{n}", (ours, f"bn{n}"), norm
            if has_down(ref, ours):
                yield f"{ref}.downsample.0", (ours, "down_conv"), _CONV
                yield f"{ref}.downsample.1", (ours, "down_bn"), norm
    yield "classifier.0", ("head_conv",), _CONV
    yield "classifier.1", ("head_bn",), norm
    yield "classifier.4", ("head_out",), _CONV_BIAS


def _from_torch(sd, modules: Iterator[RefModule], what: str, unused: Tuple[str, ...] = ()) -> dict:
    """A reference state_dict → ``{"params": tree}``; raises ``KeyError``
    on a missing key and ``ValueError`` on a key left unread (but those
    ending in ``unused``)."""
    params: dict = {}
    read = set()
    for prefix, path, leaves in modules:
        node = params
        for part in path:
            node = node.setdefault(part, {})
        for ref_leaf, leaf in leaves:
            key = f"{prefix}.{ref_leaf}"
            if key not in sd:
                raise KeyError(f"{what}: the state_dict has no {key}")
            arr = _numpy(sd[key])
            node[leaf] = _to_flax(arr) if leaf == "kernel" else arr
            read.add(key)
    left = sorted(k for k in sd if k not in read and not k.endswith(unused))
    if left:
        raise ValueError(f"{what}: {len(left)} key(s) the mapping does not read, "
                         f"e.g. {left[:4]}")
    return {"params": params}


def _to_torch(params: dict, modules: Iterator[RefModule]) -> Dict[str, np.ndarray]:
    sd = {}
    for prefix, path, leaves in modules:
        node = params["params"]
        for part in path:
            node = node[part]
        for ref_leaf, leaf in leaves:
            arr = np.asarray(node[leaf])
            sd[f"{prefix}.{ref_leaf}"] = _to_ref(arr) if leaf == "kernel" else np.array(arr)
    return sd


def point_encoder_from_torch(sd, num_layers: int = 1, n_spfcs: int = 4) -> dict:
    """A reference PointEncoder state_dict → the flax-layout tree."""
    return _from_torch(sd, _point_modules(num_layers, n_spfcs), "PointEncoder")


def ppf_encoder_from_torch(sd, n_res: int = 3) -> dict:
    """A reference PPFEncoder state_dict → the flax-layout tree."""
    return _from_torch(sd, _ppf_modules(n_res, lambda i: f"res_layers.{i}.fc0.weight" in sd),
                       "PPFEncoder")


def point_encoder_to_torch(params: dict, num_layers: int = 1,
                           n_spfcs: int = 4) -> Dict[str, np.ndarray]:
    """The flax-layout tree → a reference PointEncoder state_dict (numpy)."""
    return _to_torch(params, _point_modules(num_layers, n_spfcs))


def ppf_encoder_to_torch(params: dict, n_res: int = 3) -> Dict[str, np.ndarray]:
    """The flax-layout tree → a reference PPFEncoder state_dict (numpy)."""
    p = params["params"]
    return _to_torch(params, _ppf_modules(n_res, lambda i: "fc0" in p[f"res{i}"]))


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A bare ``.pth`` state_dict (the reference's checkpoint format) as
    numpy arrays."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _numpy(v) for k, v in sd.items()}


def export_reference_pth(params: dict, point_path: str, ppf_path: str) -> None:
    """Write ``{"point": tree, "ppf": tree}`` as the reference's ``.pth``
    pair."""
    for sd, path in ((point_encoder_to_torch(params["point"]), point_path),
                     (ppf_encoder_to_torch(params["ppf"]), ppf_path)):
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)


def fcn_resnet50_from_torch(sd, layers: Sequence[int] = (3, 4, 6, 3)) -> dict:
    """A torchvision ``fcn_resnet50`` state_dict with its BatchNorms
    converted to InstanceNorms (reference utils/util.py:41-58) → the
    segmenter's flax-layout tree.  The reference's conversion keeps
    ``track_running_stats``, so the norms carry ``running_mean`` /
    ``running_var``, which its eval mode normalises by (reference
    nocs/inference.py:94-95): they come over as ``mean`` / ``var``, which
    ``FCNResNet50(track_stats=True)`` serves.  Each norm's
    ``num_batches_tracked`` counter is read by nothing."""
    stats = "backbone.bn1.running_mean" in sd
    return _from_torch(sd, _fcn_modules(layers, lambda ref, _: f"{ref}.downsample.0.weight" in sd,
                                        stats),
                       "FCNResNet50", unused=(".num_batches_tracked",))


def fcn_resnet50_to_torch(params: dict,
                          layers: Sequence[int] = (3, 4, 6, 3)) -> Dict[str, np.ndarray]:
    """The segmenter's flax-layout tree → torchvision-keyed state_dict
    (numpy), with running statistics where the tree has ``mean``/``var``;
    the inverse of :func:`fcn_resnet50_from_torch`."""
    p = params["params"]
    return _to_torch(params, _fcn_modules(layers, lambda _, ours: "down_conv" in p[ours],
                                          "mean" in p["stem_bn"]))
