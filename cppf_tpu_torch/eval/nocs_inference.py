"""Per-category pose runner (counterpart of the ``CategoryRunner`` of
cppf_tpu/eval/nocs_inference.py:44-118)."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from cppf_tpu_torch.config import REPO_ROOT, load_config
from cppf_tpu_torch.device import pin_float32, resolve_device
from cppf_tpu_torch.models.convert import ASSETS, load_encoders, load_npz_params
from cppf_tpu_torch.pipeline.pose import PoseConfig, PoseDraws, estimate_pose
from cppf_tpu_torch.pipeline.preprocess import preprocess_cloud

# Inference-only flags overlaid from the repo's category config onto the
# training-time snapshot, as the JAX runner does (nocs_inference.py:76-83).
OVERLAY = ("asym_right_votes", "asym_center_refine", "subvoxel_refine", "geo_right_sign",
           "geo_right_dir", "filter_coplanar", "coplanar_halfspace", "pair_balance",
           "pair_sep_power", "sharp_axis_votes", "aux_align_weight", "axis_topk",
           "pose_f32", "anchor_t")


class CategoryRunner:
    """Config, weights and pipeline for one category.

    ``ckpt`` is the flat ``.npz`` of the params tree (default
    ``assets/<cls>_params_best.npz``, written by
    ``scripts/export_torch_assets.py``).  The config is the training-time
    snapshot ``checkpoints/<cls>/config.yaml`` when present, else the
    layered repo config.  Runs on ``cuda`` unless ``device`` says otherwise.
    """

    def __init__(self, cls_name: str, ckpt: Optional[str] = None, device=None,
                 num_rots: int = 72, angle_prec: float = 1.5, adaptive_voting: bool = False):
        self.device = resolve_device(device)
        pin_float32()
        snap = os.path.join(REPO_ROOT, "checkpoints", cls_name, "config.yaml")
        self.cfg = load_config(cls_name, snapshot=snap if os.path.exists(snap) else None)
        self.cfg.num_rots = num_rots
        self.cfg.angle_prec = angle_prec
        self.cfg.adaptive_voting = adaptive_voting
        repo_cfg = load_config(cls_name)
        for k in OVERLAY:
            setattr(self.cfg, k, getattr(repo_cfg, k))
        if self.cfg.anchor_t:
            raise NotImplementedError("anchor_t is not ported to the torch pipeline")
        self.pcfg = PoseConfig.from_config(self.cfg, scale_multiplier=2.0)
        self.sphere = torch.from_numpy(self.pcfg.sphere_points()).to(self.device)
        ckpt = ckpt or os.path.join(ASSETS, f"{cls_name}_params_best.npz")
        self.point_encoder, self.ppf_encoder = load_encoders(
            load_npz_params(ckpt), self.cfg.out_dim, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(0)

    @torch.no_grad()
    def estimate(self, pc_raw: np.ndarray, generator: Optional[torch.Generator] = None,
                 draws: Optional[PoseDraws] = None, laptop_up=None):
        """Pose of one raw cloud [M, 3].  Draws come from ``draws`` (which
        must then carry ``jitter`` [npoint_max, 3]) or from ``generator``
        (default: the runner's own, seeded with 0 at construction).
        ``laptop_up`` [3], the base-plane normal oriented toward the camera,
        turns on the laptop plane override.
        Returns (PoseResult, PreprocessedCloud)."""
        cfg = self.cfg
        n_raw_pad = cfg.npoint_max
        pad = np.zeros((n_raw_pad, 3), np.float32)
        n_raw = min(len(pc_raw), n_raw_pad)
        if len(pc_raw) > n_raw_pad:
            # stride-subsample: a backprojected cloud is in scanline order, so
            # truncation would keep only the top image rows of a large object
            pad[:] = pc_raw[np.linspace(0, len(pc_raw) - 1, n_raw_pad).astype(int)]
        else:
            pad[:n_raw] = pc_raw[:n_raw]
        if draws is None:
            draws = PoseDraws.sample(self.pcfg, generator or self.generator, self.device,
                                     n_raw=n_raw_pad)
        pre = preprocess_cloud(torch.from_numpy(pad).to(self.device), n_raw, cfg.res,
                               npoint_pad=cfg.npoint_pad, knn=cfg.knn, noise=draws.jitter,
                               generator=generator or self.generator)
        if laptop_up is not None:
            laptop_up = torch.as_tensor(np.asarray(laptop_up, np.float32), device=self.device)
        out = estimate_pose(self.point_encoder, self.ppf_encoder, pre.pc, pre.normals,
                            pre.n_valid, self.sphere, self.pcfg, nbr_idx=pre.nbr_idx,
                            draws=draws, laptop_up=laptop_up)
        return out, pre
