"""Per-category checkpoint quality eval (counterpart of
scripts/eval_checkpoints.py): render N posed primitives, run the full pose
pipeline, report median translation / up-axis / scale errors.

The views and the draws are the JAX script's for the same ``--seed``: the
primitives come from the same ``default_rng(seed)`` stream, and the pose of
each accepted view (300 pixels or more) runs on the draws of the key JAX
splits from ``PRNGKey(seed)`` for it (``core/threefry.py``,
``CategoryRunner.draws``).  Prints one summary line per category and a
JSON blob.

Usage:
    python -m cppf_tpu_torch.scripts.eval_checkpoints [--categories bowl bottle ...] \\
        [--n_poses 12] [--ckpt_path checkpoints] [--set KEY=VAL ...] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import NamedTuple, Optional

import numpy as np
import yaml

from cppf_tpu_torch.core import threefry
from cppf_tpu_torch.core.geometry import backproject
from cppf_tpu_torch.data import native
from cppf_tpu_torch.data.shapenet import FLIP2NOCS
from cppf_tpu_torch.data.synthetic import (mesh_bounds, mesh_sign_cue, observation_pose,
                                           random_primitive)
from cppf_tpu_torch.eval.nocs_inference import REAL275_INTRINSICS, CategoryRunner
from cppf_tpu_torch.pipeline.pose import PoseConfig

NOCS_CATEGORIES = ["bottle", "bowl", "camera", "can", "laptop", "mug"]
SUN_CATEGORIES = ["table", "chair", "bed", "sofa", "bookshelf", "bathtub"]
MIN_PIXELS = 300


class View(NamedTuple):
    """One accepted rendered view: the camera-frame cloud ``pc`` [M, 3]
    (float32, every pixel), its GT ``R``, ``T``, ``bound`` (the canonical
    extent at its scale), the canonical vertices and faces and the scale
    (for the sign cue), and ``key``, the JAX key its pose runs on."""
    pc: np.ndarray
    R: np.ndarray
    T: np.ndarray
    bound: np.ndarray
    v_canon: np.ndarray
    faces: np.ndarray
    scale: float
    key: tuple


def render_views(category: str, scale_range, n_poses: int, seed: int = 0):
    """The views the JAX script poses, in its order: at most ``3·n_poses``
    renders, a view kept where its mask has ``MIN_PIXELS`` pixels, and a
    key split from ``PRNGKey(seed)`` for each kept view only."""
    K = REAL275_INTRINSICS
    is_nocs = category in NOCS_CATEGORIES
    rng = np.random.default_rng(seed)
    key = threefry.key(seed)
    kept = attempts = 0
    while kept < n_poses and attempts < n_poses * 3:
        attempts += 1
        mesh = random_primitive(category, rng)
        lo, hi = mesh_bounds(mesh)
        diag = float(np.linalg.norm(hi - lo))
        scale = float(rng.uniform(*scale_range))
        # GT pose of the trained canonical frame (flip2nocs'd for the NOCS
        # categories), seen from the training distribution's directions
        R, T = observation_pose(rng, is_nocs=is_nocs)
        v_canon = (mesh.vertices - (lo + hi) / 2) / diag * scale
        if is_nocs:
            v_canon = v_canon @ FLIP2NOCS.T
        v_render = (v_canon @ R.T + T) * np.float32([1, -1, -1])
        depth = native.rasterize_depth(v_render, mesh.faces, K[0, 0], K[1, 1], K[0, 2],
                                       K[1, 2], 640, 480)
        mask = depth > 0
        if mask.sum() < MIN_PIXELS:
            continue
        pc, _ = backproject(depth, K, mask)
        pc[:, 0] = -pc[:, 0]
        pc[:, 1] = -pc[:, 1]
        key, k1 = threefry.split(key)
        kept += 1
        yield View(pc.astype(np.float32), R, T, (hi - lo) / diag * scale, v_canon, mesh.faces,
                   scale, k1)


def load_runner(category: str, ckpt_path: str, ckpt_name: Optional[str] = None, device=None,
                overrides: Optional[dict] = None) -> CategoryRunner:
    """The category's runner at 72 rotations, 1.5° and no adaptive voting:
    ``<ckpt_path>/<cat>/<ckpt_name>.npz`` when ``ckpt_name`` is given, else
    ``CategoryRunner``'s rule.  ``overrides`` set config fields, and the
    PoseConfig is rebuilt from them; a key that only the PoseConfig has
    (``center_mode``) is set on the rebuilt PoseConfig, where the JAX
    script sets it on the config, which ``PoseConfig.from_config`` does
    not read (so that ``--set center_mode=grid`` does nothing there).  An
    unknown key raises ``ValueError``; missing weights raise
    ``FileNotFoundError``."""
    ckpt = None
    if ckpt_name:
        ckpt = os.path.join(ckpt_path, category, f"{ckpt_name}.npz")
        if not os.path.exists(ckpt):
            raise FileNotFoundError(f"no {ckpt_name}.npz for {category} under {ckpt_path}")
    runner = CategoryRunner(category, ckpt=ckpt, device=device, num_rots=72, angle_prec=1.5,
                            adaptive_voting=False, ckpt_path=ckpt_path)
    if overrides:
        # inference-side flags set without touching the category configs
        config_keys = {f.name for f in dataclasses.fields(runner.cfg)}
        pose_keys = {f.name for f in dataclasses.fields(PoseConfig)}
        unknown = sorted(set(overrides) - config_keys - pose_keys)
        if unknown:
            raise ValueError(f"--set {unknown}: neither a config nor a PoseConfig field")
        for k, v in overrides.items():
            if k in config_keys:
                setattr(runner.cfg, k, v)
        runner.pcfg = dataclasses.replace(
            PoseConfig.from_config(runner.cfg, scale_multiplier=2.0),
            **{k: v for k, v in overrides.items() if k not in config_keys})
    return runner


def _deg(c: float) -> float:
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def eval_category(category: str, ckpt_path: str, n_poses: int, seed: int = 0,
                  overrides: Optional[dict] = None, ckpt_name: Optional[str] = None,
                  device=None, poses: Optional[list] = None,
                  runner: Optional[CategoryRunner] = None) -> dict:
    """Median errors of ``n_poses`` rendered single-object views against
    their GT, scored as the JAX script scores them.  ``poses``, when given,
    receives one dict a pose: the view, its key, the estimate and its
    back-vote survivor count (and the laptop's plane-override estimate
    under ``ov_``).  ``runner``, when
    given, is used as it is (:func:`load_runner` builds one from the other
    arguments otherwise)."""
    if runner is None:
        runner = load_runner(category, ckpt_path, ckpt_name, device, overrides)
    cfg = runner.cfg
    t_errs, up_errs, right_errs, s_errs = [], [], [], []
    right_line_errs, t_up_errs, t_perp_errs = [], [], []
    sign_cues = []
    ov_up_errs, ov_t_errs = [], []
    for view in render_views(category, cfg.scale_range, n_poses, seed):
        R, T = view.R, view.T
        draws = runner.draws(view.key)
        out, _ = runner.estimate(view.pc, draws=draws)
        est = {k: getattr(out, k).cpu().numpy() for k in ("T", "up", "right", "scale")}
        record = dict(view=view, n_filtered=int(out.n_filtered), **est)
        if category == "laptop":
            # the driver's plane override, fed GT up oriented toward the
            # camera (the visible-surface rule of its RANSAC normal)
            lup = (R[:, 1] * (-1.0 if float(R[:, 1] @ T) > 0 else 1.0)).astype(np.float32)
            out_ov, _ = runner.estimate(view.pc, draws=draws, laptop_up=lup)
            ov = {k: getattr(out_ov, k).cpu().numpy() for k in ("T", "up", "right", "scale")}
            ov_t_errs.append(float(np.linalg.norm(ov["T"] - T)))
            ov_up_errs.append(_deg(float(np.dot(ov["up"], R[:, 1]))))
            record.update({f"ov_{k}": v for k, v in ov.items()}, laptop_up=lup)
        if poses is not None:
            poses.append(record)

        t_errs.append(float(np.linalg.norm(est["T"] - T)))
        up_true = R[:, 1]
        # the T error along and across the GT up axis: a flat category hides
        # its center under its top plane, so "height wrong" stands apart
        dT = est["T"] - T
        t_up_errs.append(float(abs(np.dot(dT, up_true))))
        t_perp_errs.append(float(np.linalg.norm(dT - np.dot(dT, up_true) * up_true)))
        up_errs.append(_deg(float(np.dot(est["up"], up_true))))
        if cfg.regress_right:
            # canonical right is +x (+z under z_right); right_sym folds the sign
            right_true = R[:, 2] if cfg.z_right else R[:, 0]
            cr = float(np.dot(est["right"], right_true))
            if cfg.right_sym:
                cr = abs(cr)
            right_errs.append(_deg(cr))
            # the axis line's error, sign folded
            right_line_errs.append(float(np.degrees(np.arccos(np.clip(abs(cr), 0, 1)))))
            # up is +y of the trained canonical frame for every category
            sign_cues.append(mesh_sign_cue(view.v_canon, view.faces, 1, view.scale))
        s_errs.append(float(abs(np.linalg.norm(est["scale"]) - np.linalg.norm(view.bound))
                            / np.linalg.norm(view.bound)))
    out = {
        "t_err_mm_median": round(float(np.median(t_errs)) * 1000, 1),
        "up_err_deg_median": round(float(np.median(up_errs)), 1),
        "scale_err_pct_median": round(float(np.median(s_errs)) * 100, 1),
        "n_poses": len(t_errs),
    }
    out["t_err_up_mm_median"] = round(float(np.median(t_up_errs)) * 1000, 1)
    out["t_err_perp_mm_median"] = round(float(np.median(t_perp_errs)) * 1000, 1)
    if right_errs:
        out["right_err_deg_median"] = round(float(np.median(right_errs)), 1)
        out["right_line_deg_median"] = round(float(np.median(right_line_errs)), 1)
        # the signed error on the draws that carry a sign (cue ≥ 2 % of the
        # scale); a symmetric draw can be scored on its line only
        cued = [e for e, c in zip(right_errs, sign_cues) if c >= 0.02]
        out["n_sign_capable"] = len(cued)
        if cued:
            out["right_err_deg_median_signcue"] = round(float(np.median(cued)), 1)
    if ov_up_errs:
        out["override_up_deg_median"] = round(float(np.median(ov_up_errs)), 1)
        out["override_t_err_mm_median"] = round(float(np.median(ov_t_errs)) * 1000, 1)
    return out


def parse_overrides(items) -> dict:
    """``KEY=VAL`` strings, each value read as YAML."""
    overrides = {}
    for kv in items:
        k, _, v = kv.partition("=")
        overrides[k] = yaml.safe_load(v)
    return overrides


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--categories", nargs="*", default=None)
    ap.add_argument("--ckpt_path", default="checkpoints")
    ap.add_argument("--n_poses", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--name", default=None,
                    help="weights to load, <ckpt_path>/<cat>/<name>.npz (default: the "
                         "runner's params_best)")
    ap.add_argument("--set", dest="overrides", nargs="*", default=[], metavar="KEY=VAL",
                    help="inference-flag overrides for A/B runs, e.g. "
                         "--set coplanar_halfspace=true filter_coplanar=false")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; never falls back to the CPU)")
    return ap


def main(argv=None) -> dict:
    """Evaluates each category; prints a line each and the JSON blob, and
    returns {category: summary}."""
    args = build_parser().parse_args(argv)
    overrides = parse_overrides(args.overrides)
    cats = args.categories or [c for c in NOCS_CATEGORIES + SUN_CATEGORIES
                               if os.path.isdir(os.path.join(args.ckpt_path, c))]
    results = {}
    for c in cats:
        try:
            r = eval_category(c, args.ckpt_path, args.n_poses, args.seed,
                              overrides=overrides or None, ckpt_name=args.name,
                              device=args.device)
        except FileNotFoundError as e:
            print(f"{c}: no checkpoint ({e})")
            continue
        results[c] = r
        right = (f"   right err {r['right_err_deg_median']:5.1f} deg"
                 if "right_err_deg_median" in r else "")
        print(f"{c:10s} median T err {r['t_err_mm_median']:7.1f} mm   "
              f"up err {r['up_err_deg_median']:5.1f} deg   "
              f"scale err {r['scale_err_pct_median']:5.1f} %{right}")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
