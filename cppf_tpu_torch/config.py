"""Configuration: the fields of ``cppf_tpu.config.Config``, and the same
layered YAML loader

    defaults (here)  <  configs/default.yaml  <  configs/category/<cat>.yaml
                     <  overrides (``parse_cli_overrides``)

or, when a training-time snapshot is given, defaults < snapshot < overrides.
Keys the port does not know are ignored, as the JAX loader ignores unknown
keys.  ``Config.save`` writes the snapshot the trainer leaves beside its
checkpoints.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import yaml

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_ROOT = os.path.join(REPO_ROOT, "configs")


@dataclass
class OptConfig:
    lr: float = 1e-3
    weight_decay: float = 1e-4


@dataclass
class Config:
    category: str = "bowl"
    # the training seed: init params, data stream and the per-epoch key
    seed: int = 0
    batch_size: int = 1
    res: float = 5e-3
    max_epoch: int = 200
    npoint_max: int = 10000
    use_normal: bool = True
    regress_right: bool = False
    tr_num_bins: int = 32
    rot_num_bins: int = 36
    up_sym: bool = False
    right_sym: bool = False
    z_right: bool = False
    cls_bins: bool = True
    knn: int = 60
    shapenet_root: str = "./data/ShapeNetCore.v2"
    opt: OptConfig = field(default_factory=OptConfig)
    scale_range: Tuple[float, float] = (0.1851, 0.2381)
    vote_range: Tuple[float, float] = (0.12, 0.12)
    scale_mean: Tuple[float, float, float] = (0.07, 0.03, 0.07)
    # training-side (see cppf_tpu.config.Config): depth-noise strength of the
    # renders (0 = off), |n·axis| weights on the aux-bit BCE, the
    # radial-asymmetry factor on the right bit's weight, a factor on the
    # right-bit BCE in the total, the base-membership weight on the up KL
    depth_noise: float = 0.0
    aux_weighted: bool = True
    aux_asym: bool = False
    right_aux_boost: float = 1.0
    up_rot_base: bool = False
    # validation cadences in epochs (0 = off) and the decode-val pose count
    contrast_val_every: int = 0
    decode_val_every: int = 0
    decode_val_poses: int = 6
    train_pairs: int = 200000
    # inference-side flags (see pipeline/pose.py::PoseConfig)
    sharp_axis_votes: bool = False
    aux_align_weight: bool = False
    asym_right_votes: bool = False
    asym_center_refine: bool = False
    subvoxel_refine: bool = False
    geo_right_sign: bool = False
    geo_right_dir: str = "cross"
    axis_topk: int = 1
    anchor_t: bool = False
    pose_f32: bool | str = "decode"
    infer_pairs: int = 100000
    npoint_pad: int = 8192
    grid_edge: int = 0
    num_rots: int = 72
    angle_prec: float = 1.5
    adaptive_voting: bool = False
    filter_coplanar: bool = False
    coplanar_halfspace: bool = False
    pair_balance: float = 0.0
    pair_sep_power: float = 0.0

    def resolved_grid_edge(self) -> int:
        """Static vote-grid edge: the largest object diagonal plus jitter in
        voxels, rounded up to a multiple of 8 (cppf_tpu/config.py:210-218)."""
        if self.grid_edge:
            return self.grid_edge
        edge = int(self.scale_range[1] / self.res) + 4
        return (edge + 7) // 8 * 8

    @property
    def out_dim(self) -> int:
        """PPF head output width."""
        if self.cls_bins:
            return 2 * self.tr_num_bins + 2 * self.rot_num_bins + 2 + 3
        return 2 + 2 + 2 + 3

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        """Write the resolved config as YAML (the snapshot that inference
        re-reads, as ``cppf_tpu.config.Config.save`` writes it)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)


def _apply(cfg: dict, overrides: dict) -> dict:
    for k, v in overrides.items():
        if k == "defaults":
            continue
        if isinstance(v, dict) and isinstance(cfg.get(k), dict):
            _apply(cfg[k], v)
        else:
            cfg[k] = v
    return cfg


def _read(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def load_config(
    category: Optional[str] = None,
    overrides: Optional[dict] = None,
    config_root: Optional[str] = None,
    snapshot: Optional[str] = None,
) -> Config:
    """Compose a Config; ``snapshot`` takes priority over the layers."""
    root = config_root or CONFIG_ROOT
    base = dataclasses.asdict(Config())
    if snapshot is not None:
        _apply(base, _read(snapshot))
    else:
        default_path = os.path.join(root, "default.yaml")
        if os.path.exists(default_path):
            _apply(base, _read(default_path))
        if category is not None:
            cat_path = os.path.join(root, "category", f"{category}.yaml")
            if os.path.exists(cat_path):
                _apply(base, _read(cat_path))
            else:
                base["category"] = category
    if overrides:
        _apply(base, overrides)
    opt = OptConfig(**base.pop("opt", {}))
    known = {f.name for f in dataclasses.fields(Config)}
    kwargs = {k: v for k, v in base.items() if k in known}
    for key in ("scale_range", "vote_range", "scale_mean"):
        if isinstance(kwargs.get(key), list):
            kwargs[key] = tuple(kwargs[key])
    return Config(**kwargs, opt=opt)


def parse_cli_overrides(args: List[str]) -> dict:
    """``key=value`` overrides (dotted keys nest: ``opt.lr=5e-4``), each
    value read as YAML; a numeric string YAML 1.1 leaves unread ("5e-4")
    becomes a number."""
    out: dict = {}
    for a in args:
        if "=" not in a:
            raise ValueError(f"override must look like key=value, got {a!r}")
        k, v = a.split("=", 1)
        try:
            v = yaml.safe_load(v)
        except yaml.YAMLError:
            pass
        if isinstance(v, str):
            for cast in (int, float):
                try:
                    v = cast(v)
                    break
                except ValueError:
                    pass
        cur = out
        *parents, leaf = k.split(".")
        for p in parents:
            cur = cur.setdefault(p, {})
        cur[leaf] = v
    return out
