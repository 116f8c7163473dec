"""NOCS REAL275 evaluation CLI (counterpart of cppf_tpu/eval/nocs_eval.py,
itself the reference ``nocs/eval.py``).

Loads every ``--subsample``-th prediction pkl, derives per-instance
up-symmetry flags (bottle/bowl/can always; mug when the handle is hidden),
and runs the full mAP protocol: pose AP at {5,10,15}°x{5,10,15}cm gated at
IoU 0.1 and 3D-IoU AP over 101 thresholds.  Numpy only.

Usage:
    python -m cppf_tpu_torch.eval.nocs_eval --pred_dir ... [--subsample 10]
"""
from __future__ import annotations

import argparse
import glob
import os
import pickle

import numpy as np

from cppf_tpu_torch.eval.metrics import compute_degree_cm_mAP
from cppf_tpu_torch.eval.nocs_inference import SYNSET_NAMES


def load_results(pred_dir: str, subsample: int = 10):
    pkls = sorted(glob.glob(os.path.join(pred_dir, "results_*.pkl")))[::subsample]
    if not pkls:
        raise FileNotFoundError(f"no prediction pkls under {pred_dir}")
    final_results = []
    for p in pkls:
        with open(p, "rb") as f:
            result = pickle.load(f)
        vis = result["gt_handle_visibility"]
        ids = result["gt_class_ids"]
        up_syms = np.zeros_like(vis, dtype=bool)
        for i, (cls_id, v) in enumerate(zip(ids, vis)):
            if v == 0:
                if SYNSET_NAMES[cls_id] != "mug":
                    raise ValueError(f"{p}: a hidden handle on a {SYNSET_NAMES[cls_id]}")
                up_syms[i] = True
            elif SYNSET_NAMES[cls_id] in ("bowl", "bottle", "can"):
                up_syms[i] = True
        result["gt_up_syms"] = up_syms
        final_results.extend(result if isinstance(result, list) else [result])
    return final_results


def main(argv=None):
    parser = argparse.ArgumentParser(description="NOCS REAL275 mAP of result pkls")
    parser.add_argument("--pred_dir", default="data/nocs_prediction")
    parser.add_argument("--subsample", type=int, default=10)
    args = parser.parse_args(argv)

    final_results = load_results(args.pred_dir, args.subsample)
    return compute_degree_cm_mAP(
        final_results, SYNSET_NAMES, args.pred_dir + "_map",
        degree_thresholds=[5, 10, 15],
        shift_thresholds=[5, 10, 15],
        iou_3d_thresholds=np.linspace(0, 1, 101),
        iou_pose_thres=0.1,
        use_matches_for_pose=True,
    )


if __name__ == "__main__":
    main()
