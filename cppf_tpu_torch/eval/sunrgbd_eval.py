"""SUN RGB-D evaluation (numpy copy of cppf_tpu/eval/sunrgbd_eval.py).

Rebuilds the GT boxes in the frame conjugated by ``inv(EX·rot·Rtilt·EX)``,
drops non-finite prediction rows, applies greedy 3D-IoU NMS at 0.3 and runs
the per-category mAP protocol at {5..60}° × {5..30} cm with an IoU gate of
0.1.

Usage:
    python -m cppf_tpu_torch.eval.sunrgbd_eval --pred_dir ... --sunrgbd_dir ... \
        --sunrgbd_extra_dir ... [--full_rot] [--categories ...]
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from cppf_tpu_torch.eval.box3d import Box3D
from cppf_tpu_torch.eval.iou3d import iou_boxes
from cppf_tpu_torch.eval.metrics import compute_degree_cm_mAP
from cppf_tpu_torch.eval.sunrgbd_inference import (EX_MAT, SCAN_DIR, TYPE2CLASS, load_meta,
                                                    scan_names)


def iou_3d_safe(box1: Box3D, box2: Box3D) -> float:
    try:
        return iou_boxes(box1, box2)
    except Exception as e:  # degenerate hulls → 0, like the reference
        print(e)
        return 0.0


def nms(boxes, scores, overlap_threshold: float):
    """Greedy score-descending 3D NMS (reference sunrgbd/eval.py:21-35)."""
    order = np.argsort(scores)
    pick = []
    while order.size != 0:
        last = order.size
        i = order[-1]
        pick.append(i)
        suppress = [last - 1]
        for pos in range(last - 1):
            j = order[pos]
            if iou_3d_safe(boxes[i], boxes[j]) > overlap_threshold:
                suppress.append(pos)
        order = np.delete(order, suppress)
    return pick


def gt_rt_from_bbox(bbox: np.ndarray, rot: np.ndarray, extra_mat: np.ndarray):
    """GT 9D from a SUN RGB-D bbox row (reference sunrgbd/eval.py:87-98)."""
    tx, ty, tz = bbox[0], bbox[2], bbox[1]
    ry = -bbox[6]
    sx, sy, sz = bbox[3], bbox[5], bbox[4]
    rot_gt = np.array(
        [[np.cos(ry), 0, -np.sin(ry)], [0, 1, 0], [np.sin(ry), 0, np.cos(ry)]])
    trans_gt = np.array([tx, ty, tz])
    RT = np.eye(4)
    inv_extra = np.linalg.inv(extra_mat)
    RT[:3, :3] = inv_extra @ EX_MAT @ rot @ EX_MAT @ rot_gt
    RT[:3, 3] = inv_extra @ EX_MAT @ rot @ EX_MAT @ trans_gt
    return RT, np.array([sx, sy, sz])


def main(argv=None):
    """Scores each category's ``results_<type>.pkl``; returns {category:
    (iou_aps, pose_aps, pose_pred_matches, pose_gt_matches)}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--pred_dir", default="data/sunrgbd_prediction")
    parser.add_argument("--sunrgbd_dir", default="data/OFFICIAL_SUNRGBD")
    parser.add_argument("--sunrgbd_extra_dir", default="data/sunrgbd_extra")
    parser.add_argument("--full_rot", action="store_true",
                        help="evaluate full 3D rotation (default: gravity axis only)")
    parser.add_argument("--categories", nargs="*", default=None)
    args = parser.parse_args(argv)

    meta_data = load_meta(args.sunrgbd_dir)
    root_path = os.path.join(args.sunrgbd_extra_dir, SCAN_DIR)

    all_aps = {}
    for typename in args.categories or list(TYPE2CLASS):
        class_id = TYPE2CLASS[typename]
        res_path = os.path.join(args.pred_dir, f"results_{typename}.pkl")
        with open(res_path, "rb") as f:
            poses_pred = pickle.load(f)

        final_results = []
        for scan_name in scan_names(args.sunrgbd_extra_dir, class_id):
            meta = meta_data[int(scan_name) - 1]
            Rtilt = meta["Rtilt"]
            rot = np.load(os.path.join(root_path, scan_name) + "_rot.npy")
            Rtilt = rot @ Rtilt
            extra_mat = EX_MAT @ Rtilt @ EX_MAT

            scene = {k: [] for k in (
                "gt_class_ids", "gt_RTs", "gt_up_syms", "gt_scales",
                "pred_class_ids", "pred_RTs", "pred_scales", "pred_scores", "pred_bboxes")}

            bboxes_gt = np.load(os.path.join(root_path, scan_name) + "_bbox.npy")
            for bbox in bboxes_gt:
                if int(bbox[7]) != class_id:
                    continue
                RT, scales_gt = gt_rt_from_bbox(bbox, rot, extra_mat)
                scene["gt_class_ids"].append(1)
                scene["gt_RTs"].append(RT)
                scene["gt_scales"].append(scales_gt)
                scene["gt_up_syms"].append(False if args.full_rot else True)

            boxes, scores, rot_ests, trans_ests, scale_ests = [], [], [], [], []
            for pred in poses_pred.get(scan_name, []):
                if not np.all(np.isfinite(pred)):
                    continue
                scale_est = np.array(pred[2:5])
                rot_est = np.array(pred[5:14]).reshape(3, 3)
                trans_est = np.array(pred[14:17])
                boxes.append(Box3D.from_transformation(rot_est, trans_est, scale_est))
                scores.append(pred[1])
                rot_ests.append(rot_est)
                trans_ests.append(trans_est)
                scale_ests.append(scale_est)

            inv_extra = np.linalg.inv(extra_mat)
            for i in nms(boxes, np.array(scores), 0.3) if boxes else []:
                RT = np.eye(4)
                RT[:3, :3] = inv_extra @ rot_ests[i]
                RT[:3, 3] = inv_extra @ trans_ests[i]
                scene["pred_class_ids"].append(1)
                scene["pred_RTs"].append(RT)
                scene["pred_scales"].append(scale_ests[i])
                scene["pred_scores"].append(scores[i])
                scene["pred_bboxes"].append(np.ones(4))

            final_results.append({k: np.array(v) for k, v in scene.items()})

        print(f"Typename mAP: {typename}")
        aps = compute_degree_cm_mAP(
            final_results, ["BG", typename], args.pred_dir + "_map",
            iou_3d_thresholds=np.linspace(0, 1, 101),
            degree_thresholds=range(5, 61, 5),
            shift_thresholds=range(5, 31, 5),
            iou_pose_thres=0.1,
            use_matches_for_pose=True,
        )
        all_aps[typename] = aps
    return all_aps


if __name__ == "__main__":
    main()
