"""Decode validation of supervised training (counterpart of
cppf_tpu/train/decode_val.py).

A fixed held-out set of posed primitives is rendered once (seed 777,
disjoint from the training stream and the eval protocols), and every
``cfg.decode_val_every`` epochs the full pose pipeline decodes them with
the current weights: ``preprocess_cloud`` and ``estimate_pose``, whose
center vote on the card launches the peak kernels' pairs front ends.  The
medians of the translation, up, scale (and right) errors make the score
``dv_score`` (lower is better) on which the trainer keeps ``params_best``:
a total loss is blind to decode quality.

The draws follow the JAX validator's key schedule (one split a pose, then
preprocess / pose), remade by ``core/threefry.py``, so that on the same
weights its metrics equal JAX's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cppf_tpu_torch.core import threefry
from cppf_tpu_torch.core.geometry import backproject
from cppf_tpu_torch.data import native
from cppf_tpu_torch.data.shapenet import FLIP2NOCS, NOCS_CATEGORIES
from cppf_tpu_torch.data.synthetic import (mesh_bounds, mesh_sign_cue, observation_pose,
                                           random_primitive)
from cppf_tpu_torch.eval.nocs_inference import REAL275_INTRINSICS, _pad_cloud
from cppf_tpu_torch.pipeline.pose import PoseConfig, PoseDraws, estimate_pose
from cppf_tpu_torch.pipeline.preprocess import preprocess_cloud

# the held-out seed: the training stream and the checkpoint evals use 0
VAL_SEED = 777


class ValPose(NamedTuple):
    pc: np.ndarray        # [N, 3] camera-frame cloud (the NOCS driver's frame)
    R: np.ndarray         # [3, 3] GT rotation of the trained canonical frame
    T: np.ndarray         # [3] GT translation
    bound_norm: float     # |GT per-axis extents|
    scale: float          # GT diagonal scale (m)
    sign_cue: float       # how learnable the right axis's sign is (share of scale)


class DecodeValidator:
    """Renders the held-out poses at construction; ``__call__(point, ppf,
    key)`` decodes them with the given encoders on ``device`` and returns
    the metrics, with the scalar ``dv_score``."""

    def __init__(self, cfg, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.pcfg = PoseConfig.from_config(cfg, n_pairs=cfg.infer_pairs, scale_multiplier=2.0)
        self.sphere = torch.from_numpy(self.pcfg.sphere_points()).to(self.device)
        n_poses = cfg.decode_val_poses
        rng = np.random.default_rng(VAL_SEED)
        K = REAL275_INTRINSICS
        is_nocs = cfg.category in NOCS_CATEGORIES
        self.poses: list[ValPose] = []
        attempts = 0
        while len(self.poses) < n_poses and attempts < n_poses * 4:
            attempts += 1
            mesh = random_primitive(cfg.category, rng)
            lo, hi = mesh_bounds(mesh)
            diag = float(np.linalg.norm(hi - lo))
            scale = float(rng.uniform(*cfg.scale_range))
            R, T = observation_pose(rng, is_nocs=is_nocs)
            v_canon = (mesh.vertices - (lo + hi) / 2) / diag * scale
            if is_nocs:
                v_canon = v_canon @ FLIP2NOCS.T
            v_render = (v_canon @ R.T + T) * np.float32([1, -1, -1])
            depth = native.rasterize_depth(v_render, mesh.faces, K[0, 0], K[1, 1], K[0, 2],
                                           K[1, 2], 640, 480)
            mask = depth > 0
            if mask.sum() < 300:
                continue
            pc, _ = backproject(depth, K, mask)
            pc[:, 0] = -pc[:, 0]
            pc[:, 1] = -pc[:, 1]
            bound = (hi - lo) / diag * scale
            cue = mesh_sign_cue(v_canon, mesh.faces, 1, scale) if cfg.regress_right else 0.0
            self.poses.append(ValPose(pc.astype(np.float32), R, T.astype(np.float32),
                                      float(np.linalg.norm(bound)), scale, cue))
        if not self.poses:
            raise RuntimeError(f"decode-val: no renderable draws for {cfg.category}")

    def estimate(self, point, ppf, key, pc_raw: np.ndarray, laptop_up=None):
        """One pose on the draws of ``key`` (split into preprocess and pose
        keys), the cloud stride-subsampled to ``npoint_max``."""
        cfg = self.cfg
        pad, n_raw = _pad_cloud(pc_raw, cfg.npoint_max)
        r1, r2 = threefry.split(key)
        draws = PoseDraws.from_jax_keys(self.pcfg, r1, r2, self.device, n_raw=cfg.npoint_max)
        pre = preprocess_cloud(torch.from_numpy(pad).to(self.device), n_raw, cfg.res,
                               npoint_pad=cfg.npoint_pad, knn=cfg.knn, noise=draws.jitter)
        if laptop_up is not None:
            laptop_up = torch.as_tensor(laptop_up, dtype=torch.float32, device=self.device)
        return estimate_pose(point, ppf, pre.pc, pre.normals, pre.n_valid, self.sphere,
                             self.pcfg, nbr_idx=pre.nbr_idx, draws=draws, laptop_up=laptop_up)

    @torch.no_grad()
    def __call__(self, point, ppf, key) -> dict:
        cfg = self.cfg
        t_pct, up_deg, s_pct = [], [], []
        right_line, right_cued, ov_up = [], [], []
        for vp in self.poses:
            key, k1 = threefry.split(key)
            out = self.estimate(point, ppf, k1, vp.pc)
            T_est, up, scale, right = (v.cpu().numpy() for v in
                                       (out.T, out.up, out.scale, out.right))
            t_pct.append(float(np.linalg.norm(T_est - vp.T)) / vp.scale * 100)
            up_deg.append(float(np.degrees(np.arccos(np.clip(np.dot(up, vp.R[:, 1]), -1, 1)))))
            s_pct.append(abs(float(np.linalg.norm(scale)) - vp.bound_norm) / vp.bound_norm * 100)
            if cfg.regress_right:
                right_true = vp.R[:, 2] if cfg.z_right else vp.R[:, 0]
                cr = float(np.clip(np.dot(right, right_true), -1, 1))
                if cfg.right_sym:
                    cr = abs(cr)
                right_line.append(float(np.degrees(np.arccos(abs(cr)))))
                if vp.sign_cue >= 0.02 and not cfg.right_sym:
                    right_cued.append(float(np.degrees(np.arccos(cr))))
            if cfg.category == "laptop":
                # the plane override's path too, on the GT base normal
                # turned toward the camera
                lup = (vp.R[:, 1] * (-1.0 if float(vp.R[:, 1] @ vp.T) > 0
                                     else 1.0)).astype(np.float32)
                out_ov = self.estimate(point, ppf, k1, vp.pc, laptop_up=lup)
                c_ov = float(np.clip(np.dot(out_ov.up.cpu().numpy(), vp.R[:, 1]), -1, 1))
                ov_up.append(float(np.degrees(np.arccos(c_ov))))

        def med(xs):
            return float(np.median(xs))

        m = {"dv_t_pct": round(med(t_pct), 2), "dv_up_deg": round(med(up_deg), 2),
             "dv_scale_pct": round(med(s_pct), 2), "dv_n": len(self.poses)}
        # one score on comparable scales (degrees, percents); up dominates
        score = m["dv_up_deg"] + m["dv_t_pct"] + 0.5 * m["dv_scale_pct"]
        if right_line:
            m["dv_right_line_deg"] = round(med(right_line), 2)
            score += 0.5 * m["dv_right_line_deg"]
        if right_cued:
            m["dv_right_cued_deg"] = round(med(right_cued), 2)
            m["dv_n_cued"] = len(right_cued)
            score += 0.5 * m["dv_right_cued_deg"]
        if ov_up:
            m["dv_override_up_deg"] = round(med(ov_up), 2)
            score += m["dv_override_up_deg"]
        m["dv_score"] = round(score, 2)
        return m
