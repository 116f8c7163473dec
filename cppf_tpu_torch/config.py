"""Configuration: the fields of ``cppf_tpu.config.Config`` that the port
reads, and the same layered YAML loader

    defaults (here)  <  configs/default.yaml  <  configs/category/<cat>.yaml

or, when a training-time snapshot is given, defaults < snapshot.  Keys the
port does not know are ignored, as the JAX loader ignores unknown keys.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import yaml

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_ROOT = os.path.join(REPO_ROOT, "configs")


@dataclass
class Config:
    category: str = "bowl"
    res: float = 5e-3
    npoint_max: int = 10000
    regress_right: bool = False
    tr_num_bins: int = 32
    rot_num_bins: int = 36
    up_sym: bool = False
    right_sym: bool = False
    z_right: bool = False
    cls_bins: bool = True
    knn: int = 60
    scale_range: Tuple[float, float] = (0.1851, 0.2381)
    vote_range: Tuple[float, float] = (0.12, 0.12)
    scale_mean: Tuple[float, float, float] = (0.07, 0.03, 0.07)
    # inference-side flags (see cppf_tpu.pipeline.pose.PoseConfig); the port
    # raises on those in pipeline/pose.py::UNPORTED_FLAGS unless they are off
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
    known = {f.name for f in dataclasses.fields(Config)}
    kwargs = {k: v for k, v in base.items() if k in known}
    for key in ("scale_range", "vote_range", "scale_mean"):
        if isinstance(kwargs.get(key), list):
            kwargs[key] = tuple(kwargs[key])
    return Config(**kwargs)
