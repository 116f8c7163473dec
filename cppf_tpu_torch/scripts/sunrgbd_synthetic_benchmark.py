"""End-to-end synthetic SUN RGB-D benchmark (counterpart of
scripts/sunrgbd_synthetic_benchmark.py): write val-format scans of posed
furniture primitives (``data/sunrgbd_synth.make_scans``), run the scene
driver with a trained checkpoint, score the result with the SUN RGB-D mAP
protocol (NMS at 0.3, IoU gate 0.1, {5..60}° × {5..30} cm).

``--oracle`` writes the GT poses as predictions instead of running the
driver: an exactness check of the data format and the eval (AP 100).

Usage:
    python -m cppf_tpu_torch.scripts.sunrgbd_synthetic_benchmark \\
        --ckpt_path checkpoints --category table --n_scans 10 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np

from cppf_tpu_torch.data.sunrgbd_synth import EX, _roty, make_scans
from cppf_tpu_torch.device import resolve_device
from cppf_tpu_torch.eval.sunrgbd_inference import SCAN_DIR, TYPE2CLASS
from cppf_tpu_torch.scripts import fresh_out_dir
from cppf_tpu_torch.utils.prof import sync

POSE_DEGS = tuple(range(5, 61, 5))
POSE_CMS = tuple(range(5, 31, 5))
SUMMARY_CELLS = tuple((d, c) for d in (15, 30, 60) for c in (10, 30))


def write_oracle_predictions(extra_dir: str, out_dir: str, category: str, class_id: int,
                             scan_names):
    """Predictions equal to the GT, in the frame the driver writes its poses
    in (``EX·rot·EX``-conjugated): ``<out_dir>/results_<category>.pkl``."""
    root = os.path.join(extra_dir, SCAN_DIR)
    poses_pred = {}
    for scan in scan_names:
        rot = np.load(os.path.join(root, scan) + "_rot.npy")
        conj = EX @ rot @ EX
        rows = []
        for bbox in np.load(os.path.join(root, scan) + "_bbox.npy"):
            if int(bbox[7]) != class_id:
                continue
            t_gt = np.array([bbox[0], bbox[2], bbox[1]])
            extents = np.array([bbox[3], bbox[5], bbox[4]])
            R_p = conj @ _roty(-bbox[6])
            T_p = conj @ t_gt
            rows.append([class_id, 1.0, *extents, *R_p.reshape(-1), *T_p])
        poses_pred[scan] = rows
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"results_{category}.pkl"), "wb") as f:
        pickle.dump(poses_pred, f)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt_path", default="checkpoints")
    ap.add_argument("--category", default="table")
    ap.add_argument("--n_scans", type=int, default=10)
    ap.add_argument("--instances", type=int, default=2)
    ap.add_argument("--out_dir", default=None,
                    help="an empty or new directory (default: a new one under TMPDIR)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--oracle", action="store_true",
                    help="write GT as predictions (protocol exactness check)")
    ap.add_argument("--up_prior_deg", type=float, default=30.0,
                    help="forwarded to the driver (0 disables the gravity prior)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; never falls back to the CPU)")
    return ap


def main(argv=None):
    """Writes the scans, runs the driver (or the oracle) and the eval;
    prints the summary and one JSON line.  Returns that line's dict, with
    the eval's arrays under ``"eval"`` and the driver's posed instances
    under ``"posed"``."""
    from cppf_tpu_torch.eval import sunrgbd_eval, sunrgbd_inference

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    class_id = TYPE2CLASS[args.category]
    args.out_dir = fresh_out_dir(args.out_dir, "sunrgbd_synth_")
    print(f"working directory: {args.out_dir}")
    sunrgbd_dir = os.path.join(args.out_dir, "OFFICIAL_SUNRGBD")
    extra_dir = os.path.join(args.out_dir, "extra")
    pred_dir = os.path.join(args.out_dir, "pred")
    scan_names = make_scans(sunrgbd_dir, extra_dir, args.category, class_id, args.n_scans,
                            instances=args.instances, seed=args.seed)
    posed, seconds = [], None
    if args.oracle:
        write_oracle_predictions(extra_dir, pred_dir, args.category, class_id, scan_names)
    else:
        sync(device)
        t0 = time.perf_counter()
        posed = sunrgbd_inference.main([
            "--sunrgbd_dir", sunrgbd_dir, "--sunrgbd_extra_dir", extra_dir,
            "--out_dir", pred_dir, "--ckpt_path", args.ckpt_path,
            "--categories", args.category, "--seed", str(args.seed),
            "--up_prior_deg", str(args.up_prior_deg), "--device", str(device)])
        sync(device)
        seconds = time.perf_counter() - t0
    all_aps = sunrgbd_eval.main([
        "--pred_dir", pred_dir, "--sunrgbd_dir", sunrgbd_dir,
        "--sunrgbd_extra_dir", extra_dir, "--categories", args.category])
    iou_aps, pose_aps = all_aps[args.category][:2]
    print("\n=== SUN RGB-D synthetic benchmark summary ===")
    print(f"category: {args.category}  scans: {args.n_scans}  "
          f"instances/scan: {args.instances}  oracle: {args.oracle}")
    print(f"3D IoU@25: {iou_aps[1, 25] * 100:.1f}   IoU@50: {iou_aps[1, 50] * 100:.1f}")
    aps = {"iou_25": float(iou_aps[1, 25]) * 100, "iou_50": float(iou_aps[1, 50]) * 100}
    for d, c in SUMMARY_CELLS:
        ap = float(pose_aps[1, POSE_DEGS.index(d), POSE_CMS.index(c)]) * 100
        aps[f"{d}deg_{c}cm"] = ap
        print(f"pose AP {d}deg {c}cm: {ap:.1f}")
    summary = {"category": args.category, "scans": len(scan_names), "instances": len(posed),
               "oracle": args.oracle, "aps": aps, "device": str(device),
               # the driver's whole run (runner and weights loaded) over its scans
               "s_per_scan": None if seconds is None else seconds / max(len(scan_names), 1)}
    print(json.dumps(summary))
    return dict(summary, eval=all_aps[args.category], posed=posed)


if __name__ == "__main__":
    main()
