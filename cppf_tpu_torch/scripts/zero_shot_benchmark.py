"""Zero-shot detection scored by the NOCS mAP protocol (counterpart of
scripts/zero_shot_benchmark.py).

Renders multi-instance synthetic frames (``synthetic_benchmark.make_frames``),
runs ``eval/zero_shot.zero_shot_detect`` on each whole depth frame with no
detection priors, and scores the detections with the NOCS mAP protocol.
Proposals are ranked by their boundary-contrast score, so the AP reflects
both the detection recall and the pose quality.  The zero-shot head is
class-agnostic: every detection is scored against the rendered category's
GT.  Detection takes the dense route on every device (one
``dense_hist_pairs`` launch a 2^20-pair chunk).

Usage:
    python -m cppf_tpu_torch.scripts.zero_shot_benchmark --n_frames 8 --instances 2 \\
        [--clutter 1] [--n_pairs 2000000] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np

from cppf_tpu_torch.config import REPO_ROOT
from cppf_tpu_torch.data.png import read_png
from cppf_tpu_torch.device import resolve_device
from cppf_tpu_torch.scripts import fresh_out_dir
from cppf_tpu_torch.utils.prof import sync


def run_frames(frame_ids, seg_dir, nocs_dir, out_dir, detect_fn):
    """For each frame: detect on the raw depth, merge the detections with
    the generator's GT into eval-format pkls.  ``detect_fn(depth)`` returns
    a list of ``eval.zero_shot.Detection``.  Returns the number of
    detections."""
    os.makedirs(out_dir, exist_ok=True)
    n_det_total = 0
    for f_idx in frame_ids:
        gt_pkl = os.path.join(seg_dir, f"results_real_scene1_{f_idx:04d}.pkl")
        if not os.path.exists(gt_pkl):
            continue
        with open(gt_pkl, "rb") as f:
            gt = pickle.load(f)
        depth = read_png(os.path.join(nocs_dir, "real", "scene_1", f"{f_idx:04d}_depth.png"))
        dets = detect_fn(depth)
        n_det_total += len(dets)
        if dets:
            pred_RTs = np.stack([d.RT for d in dets]).astype(np.float32)
            s_norms = np.array([np.linalg.norm(d.scale) for d in dets], np.float32)
            pred_scales = np.stack([d.scale for d in dets]).astype(np.float32) / s_norms[:, None]
            pred_scores = np.array([d.score for d in dets], np.float32)
        else:
            pred_RTs = np.zeros((0, 4, 4), np.float32)
            pred_scales = np.zeros((0, 3), np.float32)
            pred_scores = np.zeros((0,), np.float32)
        # class-agnostic detections, scored against the rendered category
        cls = gt["gt_class_ids"][0]
        result = {
            "image_path": gt["image_path"],
            "pred_class_ids": np.full(len(dets), cls, np.int32),
            "pred_scores": pred_scores,
            "pred_RTs": pred_RTs,
            "pred_scales": pred_scales,
            "gt_class_ids": gt["gt_class_ids"],
            "gt_RTs": gt["gt_RTs"],
            "gt_scales": gt["gt_scales"],
            "gt_handle_visibility": gt["gt_handle_visibility"],
        }
        with open(os.path.join(out_dir, f"results_real_scene1_{f_idx:04d}.pkl"), "wb") as f:
            pickle.dump(result, f)
    return n_det_total


def load_zero_shot(ckpt: str, category: str = "bowl", names=("params_zs", "params_best")):
    """(config, params) of a regression checkpoint directory: its
    ``config.yaml`` snapshot (else the category's config) with
    ``cls_bins`` off, and the first of ``names`` found there, each as
    ``.npz`` or as the reference ``.pth`` pair (``eval/zero_shot.cli_weights``:
    the repo's ``checkpoints/bowl_reg`` serves its exported ``params_zs``)."""
    from cppf_tpu_torch.config import load_config
    from cppf_tpu_torch.eval.zero_shot import cli_weights

    snap = os.path.join(ckpt, "config.yaml")
    cfg = load_config(category, snapshot=snap if os.path.exists(snap) else None)
    cfg.cls_bins = False
    return cfg, cli_weights(ckpt, names=names)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default=os.path.join(REPO_ROOT, "checkpoints", "bowl_reg"))
    ap.add_argument("--category", default="bowl")
    ap.add_argument("--n_frames", type=int, default=8)
    ap.add_argument("--instances", type=int, default=2)
    ap.add_argument("--clutter", type=int, default=0)
    ap.add_argument("--n_pairs", type=int, default=2_000_000)
    ap.add_argument("--prop_thresh", type=float, default=50.0)
    ap.add_argument("--out_dir", default=None,
                    help="an empty or new directory (default: a new one under TMPDIR)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; never falls back to the CPU)")
    return ap


def main(argv=None):
    """Renders, detects, scores; prints the summary JSON line and returns
    its dict, with the eval's arrays under ``"eval"`` and the detections of
    each frame under ``"detections"``."""
    from cppf_tpu_torch.eval import nocs_eval
    from cppf_tpu_torch.eval.nocs_inference import REAL275_INTRINSICS, SYNSET_NAMES
    from cppf_tpu_torch.eval.zero_shot import zero_shot_detect
    from cppf_tpu_torch.scripts.synthetic_benchmark import POSE_CMS, POSE_DEGS, make_frames

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    args.out_dir = fresh_out_dir(args.out_dir, "zs_bench_")
    print(f"working directory: {args.out_dir}")
    seg_dir, nocs_dir = make_frames(args.out_dir, args.category, args.n_frames, args.seed,
                                    instances=args.instances, clutter=args.clutter)
    cfg, params = load_zero_shot(args.ckpt, args.category)
    detections, seconds = [], []

    def detect(depth):
        sync(device)
        t0 = time.perf_counter()
        dets = zero_shot_detect(depth, params, cfg, intrinsics=REAL275_INTRINSICS,
                                n_pairs=args.n_pairs, prop_thresh=args.prop_thresh,
                                seed=args.seed, device=device)
        sync(device)
        seconds.append(time.perf_counter() - t0)
        detections.append(dets)
        return dets

    pred_dir = os.path.join(args.out_dir, "pred_zs")
    n_det = run_frames(range(args.n_frames), seg_dir, nocs_dir, pred_dir, detect)
    print(f"{n_det} detections over {args.n_frames} frames "
          f"({args.instances} GT instances each)")
    result = nocs_eval.main(["--pred_dir", pred_dir, "--subsample", "1"])
    iou_aps, pose_aps = result[:2]
    cls = SYNSET_NAMES.index(args.category)
    summary = {
        "category": args.category, "n_frames": args.n_frames,
        "instances": args.instances, "clutter": args.clutter,
        "n_detections": n_det,
        "iou_ap_25": round(float(iou_aps[cls, 25]) * 100, 1),
        "iou_ap_50": round(float(iou_aps[cls, 50]) * 100, 1),
        "pose_ap": {
            f"{deg}deg_{cm}cm": round(float(pose_aps[cls, i, j]) * 100, 1)
            for i, deg in enumerate(POSE_DEGS)
            for j, cm in enumerate(POSE_CMS)
        },
        "device": str(device),
        # zero_shot_detect of a frame, synchronised: median and first call
        "s_per_frame": float(np.median(seconds)) if seconds else None,
        "first_s": seconds[0] if seconds else None,
    }
    print("\n=== zero-shot mAP summary ===")
    print(json.dumps(summary))
    return dict(summary, eval=result, detections=detections)


if __name__ == "__main__":
    main()
