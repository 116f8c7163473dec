"""NOCS-protocol mAP evaluation (host NumPy); the port's own copy of
cppf_tpu/eval/metrics.py, held to it by tests/test_torch_nocs_eval.py.

Functional parity target: reference ``utils/util.py:181-255,342-515,709-1008``
(the Mask R-CNN/NOCS-lineage evaluation): 3D-IoU AP over threshold sweeps and
a (degree, cm) pose-AP matrix with matched-pair gating.  This must reproduce
the reference numbers exactly on identical inputs (verified in
tests/test_eval_parity.py), so the quirks are preserved deliberately:

- predictions are score-sorted before IoU matching; matched greedily per
  threshold; class mismatch skipped *after* the IoU-order break;
- pose matching sorts ground truths by (degree + cm) ascending and requires
  both thresholds;
- when ``use_matches_for_pose``, pose candidates are gated on the IoU@0.1
  match set;
- rotation error uses the y-axis angle for up-symmetric classes, trace
  formula otherwise; scales are normalised out of RTs by det-cbrt;
- a trailing 360°/100cm threshold row/col is appended.
"""
from __future__ import annotations

import math
import os
import pickle
from typing import List, Sequence

import numpy as np

from cppf_tpu_torch.eval.box3d import Box3D
from cppf_tpu_torch.eval.iou3d import iou_boxes


# ---------------------------------------------------------------------------
# pairwise pose/IoU errors
# ---------------------------------------------------------------------------

def compute_3d_iou(RT_1, RT_2, scales_1, scales_2, up_sym, class_name_1, class_name_2) -> float:
    """IoU of two posed boxes; up-symmetric classes take the max over 20 y
    rotations (reference utils/util.py:181-216)."""

    def asym(RT_a, RT_b):
        try:
            Ra = RT_a[:3, :3] / np.cbrt(np.linalg.det(RT_a[:3, :3]))
            Rb = RT_b[:3, :3] / np.cbrt(np.linalg.det(RT_b[:3, :3]))
            box_a = Box3D.from_transformation(Ra, RT_a[:3, -1], scales_1)
            box_b = Box3D.from_transformation(Rb, RT_b[:3, -1], scales_2)
            return iou_boxes(box_a, box_b)
        except Exception:
            return 0.0

    if RT_1 is None or RT_2 is None:
        return -1.0

    if class_name_1 == class_name_2 and up_sym:
        best = 0.0
        for i in range(20):
            theta = 2 * math.pi * i / 20.0
            yrot = np.array(
                [
                    [np.cos(theta), 0, np.sin(theta), 0],
                    [0, 1, 0, 0],
                    [-np.sin(theta), 0, np.cos(theta), 0],
                    [0, 0, 0, 1],
                ]
            )
            best = max(best, asym(RT_1 @ yrot, RT_2))
        return best
    return asym(RT_1, RT_2)


def compute_pose_error(RT_1, RT_2, up_sym) -> np.ndarray:
    """(degrees, centimeters) error between two homogeneous transforms
    (reference utils/util.py:219-255)."""
    if RT_1 is None or RT_2 is None:
        return np.array([-1.0, -1.0])
    R1 = RT_1[:3, :3] / np.cbrt(np.linalg.det(RT_1[:3, :3]))
    R2 = RT_2[:3, :3] / np.cbrt(np.linalg.det(RT_2[:3, :3]))
    if up_sym:
        y = np.array([0.0, 1.0, 0.0])
        y1, y2 = R1 @ y, R2 @ y
        theta = np.arccos(y1.dot(y2) / (np.linalg.norm(y1) * np.linalg.norm(y2)))
    else:
        theta = np.arccos(np.clip((np.trace(R1 @ R2.T) - 1) / 2, -1.0, 1.0))
    shift = np.linalg.norm(RT_1[:3, 3] - RT_2[:3, 3]) * 100
    return np.array([theta * 180 / np.pi, shift])


# ---------------------------------------------------------------------------
# matching
# ---------------------------------------------------------------------------

def match_by_iou(gt_class_ids, gt_RTs, gt_scales, gt_up_syms, synset_names,
                 pred_class_ids, pred_scores, pred_RTs, pred_scales,
                 iou_thresholds: Sequence[float], score_threshold: float = 0.0):
    """Greedy per-threshold IoU matching (reference utils/util.py:342-416).

    Returns (gt_matches [T, n_gt], pred_matches [T, n_pred], overlaps,
    score_order): predictions are processed in descending-score order and
    the returned match arrays follow that order.
    """
    num_pred = len(pred_class_ids)
    num_gt = len(gt_class_ids)
    order = np.zeros(0, dtype=int)
    if num_pred:
        order = np.argsort(pred_scores)[::-1]
        pred_class_ids = pred_class_ids[order].copy()
        pred_scores = pred_scores[order].copy()
        pred_scales = pred_scales[order].copy()
        pred_RTs = pred_RTs[order].copy()

    overlaps = np.zeros((num_pred, num_gt), dtype=np.float32)
    for i in range(num_pred):
        for j in range(num_gt):
            overlaps[i, j] = compute_3d_iou(
                pred_RTs[i], gt_RTs[j], pred_scales[i, :], gt_scales[j],
                gt_up_syms[j], synset_names[pred_class_ids[i]], synset_names[gt_class_ids[j]],
            )

    n_thres = len(iou_thresholds)
    pred_matches = -1 * np.ones((n_thres, num_pred))
    gt_matches = -1 * np.ones((n_thres, num_gt))
    for s, thres in enumerate(iou_thresholds):
        for i in range(num_pred):
            by_iou = np.argsort(overlaps[i])[::-1]
            low = np.where(overlaps[i, by_iou] < score_threshold)[0]
            if low.size > 0:
                by_iou = by_iou[: low[0]]
            for j in by_iou:
                if gt_matches[s, j] > -1:
                    continue
                if overlaps[i, j] < thres:
                    break
                if pred_class_ids[i] != gt_class_ids[j]:
                    continue
                if overlaps[i, j] > thres:
                    gt_matches[s, j] = i
                    pred_matches[s, i] = j
                    break
    return gt_matches, pred_matches, overlaps, order


def match_by_pose(overlaps, pred_class_ids, gt_class_ids, degree_thresholds, shift_thresholds):
    """Greedy matching on the (degree, cm) error matrix
    (reference utils/util.py:470-515)."""
    nd, ns = len(degree_thresholds), len(shift_thresholds)
    num_pred, num_gt = len(pred_class_ids), len(gt_class_ids)
    pred_matches = -1 * np.ones((nd, ns, num_pred))
    gt_matches = -1 * np.ones((nd, ns, num_gt))
    if num_pred == 0 or num_gt == 0:
        return gt_matches, pred_matches

    for d, deg_t in enumerate(degree_thresholds):
        for s, shift_t in enumerate(shift_thresholds):
            for i in range(num_pred):
                by_err = np.argsort(overlaps[i].sum(-1))
                for j in by_err:
                    if gt_matches[d, s, j] > -1 or pred_class_ids[i] != gt_class_ids[j]:
                        continue
                    if overlaps[i, j, 0] > deg_t or overlaps[i, j, 1] > shift_t:
                        continue
                    gt_matches[d, s, j] = i
                    pred_matches[d, s, i] = j
                    break
    return gt_matches, pred_matches


def voc_ap(pred_match, pred_scores, gt_match) -> float:
    """VOC-style AP from match vectors (reference utils/util.py:419-444)."""
    assert pred_match.shape[0] == pred_scores.shape[0]
    order = np.argsort(pred_scores)[::-1]
    pred_match = pred_match[order]
    hits = np.cumsum(pred_match > -1)
    precisions = hits / (np.arange(len(pred_match)) + 1)
    recalls = hits.astype(np.float32) / len(gt_match)
    precisions = np.concatenate([[0], precisions, [0]])
    recalls = np.concatenate([[0], recalls, [1]])
    for i in range(len(precisions) - 2, -1, -1):
        precisions[i] = max(precisions[i], precisions[i + 1])
    idx = np.where(recalls[:-1] != recalls[1:])[0] + 1
    return float(np.sum((recalls[idx] - recalls[idx - 1]) * precisions[idx]))


# ---------------------------------------------------------------------------
# the full protocol
# ---------------------------------------------------------------------------

def compute_degree_cm_mAP(final_results: List[dict], synset_names, log_dir,
                          degree_thresholds=(360,), shift_thresholds=(100,),
                          iou_3d_thresholds=(0.1,), iou_pose_thres=0.1,
                          use_matches_for_pose=False, plot: bool = True,
                          verbose: bool = True):
    """NOCS mAP sweep.  Matches reference utils/util.py:709-1008 output:
    returns (iou_3d_aps [C+1, Ti], pose_aps [C+1, Td, Ts], pose_pred_matches,
    pose_gt_matches), writes pkl dumps (+ optional plots) to ``log_dir`` and
    prints the per-class tables."""
    os.makedirs(log_dir, exist_ok=True)
    num_classes = len(synset_names)
    degree_thres_list = list(degree_thresholds) + [360]
    shift_thres_list = list(shift_thresholds) + [100]
    iou_thres_list = list(iou_3d_thresholds)
    nd, ns, ni = len(degree_thres_list), len(shift_thres_list), len(iou_thres_list)

    if use_matches_for_pose:
        assert iou_pose_thres in iou_thres_list

    iou_aps = np.zeros((num_classes + 1, ni))
    iou_pred_matches_all = [np.zeros((ni, 0)) for _ in range(num_classes)]
    iou_pred_scores_all = [np.zeros((ni, 0)) for _ in range(num_classes)]
    iou_gt_matches_all = [np.zeros((ni, 0)) for _ in range(num_classes)]

    pose_aps = np.zeros((num_classes + 1, nd, ns))
    pose_pred_matches_all = [np.zeros((nd, ns, 0)) for _ in range(num_classes)]
    pose_gt_matches_all = [np.zeros((nd, ns, 0)) for _ in range(num_classes)]
    pose_pred_scores_all = [np.zeros((nd, ns, 0)) for _ in range(num_classes)]

    pose_gt_matches = np.full((nd, ns, len(final_results), 20), -1, dtype=int)
    pose_pred_matches = np.full((nd, ns, len(final_results), 20), -1, dtype=int)

    for progress, result in enumerate(final_results):
        gt_class_ids = result["gt_class_ids"].astype(np.int32)
        gt_RTs = np.array(result["gt_RTs"])
        gt_scales = np.array(result["gt_scales"])
        gt_up_syms = result["gt_up_syms"]
        norm_gt = np.stack([np.cbrt(np.linalg.det(rt[:3, :3])) for rt in gt_RTs])
        gt_RTs[:, :3, :3] = gt_RTs[:, :3, :3] / norm_gt[:, None, None]
        gt_scales = gt_scales * norm_gt[:, None]

        pred_class_ids = result["pred_class_ids"]
        pred_scales = result["pred_scales"]
        pred_scores = result["pred_scores"]
        pred_RTs = np.array(result["pred_RTs"])
        if len(pred_RTs) > 0:
            norm_pred = np.stack([np.cbrt(np.linalg.det(rt[:3, :3])) for rt in pred_RTs])
            pred_RTs[:, :3, :3] = pred_RTs[:, :3, :3] / (norm_pred[:, None, None] + 1e-9)
            pred_scales = pred_scales * norm_pred[:, None]

        if len(gt_class_ids) == 0 and len(pred_class_ids) == 0:
            continue

        for cls_id in range(1, num_classes):
            g_sel = gt_class_ids == cls_id if len(gt_class_ids) else np.zeros(0, bool)
            if len(gt_class_ids) > 0:
                gt_idx_map = {i: j for i, j in enumerate(np.where(g_sel)[0])}
            else:
                gt_idx_map = {i: j for i, j in enumerate(range(20))}
            cls_gt_class_ids = gt_class_ids[g_sel] if len(gt_class_ids) else np.zeros(0)
            cls_gt_scales = gt_scales[g_sel] if len(gt_class_ids) else np.zeros((0, 3))
            cls_gt_RTs = gt_RTs[g_sel] if len(gt_class_ids) else np.zeros((0, 4, 4))
            cls_gt_up_syms = gt_up_syms[g_sel] if len(gt_class_ids) else np.ones(0)

            p_sel = pred_class_ids == cls_id if len(pred_class_ids) else np.zeros(0, bool)
            if len(pred_class_ids) > 0:
                pred_idx_map = {i: j for i, j in enumerate(np.where(p_sel)[0])}
            else:
                pred_idx_map = {i: j for i, j in enumerate(range(20))}
            cls_pred_class_ids = pred_class_ids[p_sel] if len(pred_class_ids) else np.zeros(0)
            cls_pred_scores = pred_scores[p_sel] if len(pred_class_ids) else np.zeros(0)
            cls_pred_RTs = pred_RTs[p_sel] if len(pred_class_ids) else np.zeros((0, 4, 4))
            cls_pred_scales = pred_scales[p_sel] if len(pred_class_ids) else np.zeros((0, 3))

            iou_gt_match, iou_pred_match, _, order = match_by_iou(
                cls_gt_class_ids, cls_gt_RTs, cls_gt_scales, cls_gt_up_syms, synset_names,
                cls_pred_class_ids, cls_pred_scores, cls_pred_RTs, cls_pred_scales,
                iou_thres_list,
            )
            if len(order):
                pred_idx_map = {i: pred_idx_map[j] for i, j in enumerate(order)}
                cls_pred_class_ids = cls_pred_class_ids[order]
                cls_pred_RTs = cls_pred_RTs[order]
                cls_pred_scores = cls_pred_scores[order]
                cls_pred_scales = cls_pred_scales[order]

            iou_pred_matches_all[cls_id] = np.concatenate(
                (iou_pred_matches_all[cls_id], iou_pred_match), axis=-1)
            scores_tile = np.tile(cls_pred_scores, (ni, 1))
            iou_pred_scores_all[cls_id] = np.concatenate(
                (iou_pred_scores_all[cls_id], scores_tile), axis=-1)
            iou_gt_matches_all[cls_id] = np.concatenate(
                (iou_gt_matches_all[cls_id], iou_gt_match), axis=-1)

            if use_matches_for_pose:
                t_ind = iou_thres_list.index(iou_pose_thres)
                p_match = iou_pred_match[t_ind, :]
                if len(p_match) > 0:
                    pred_idx_map = {
                        i: pred_idx_map[j] for i, j in enumerate(np.where(p_match > -1)[0])
                    }
                cls_pred_class_ids = cls_pred_class_ids[p_match > -1] if len(p_match) > 0 else np.zeros(0)
                cls_pred_RTs = cls_pred_RTs[p_match > -1] if len(p_match) > 0 else np.zeros((0, 4, 4))
                cls_pred_scores = cls_pred_scores[p_match > -1] if len(p_match) > 0 else np.zeros(0)

                g_match = iou_gt_match[t_ind, :]
                if len(g_match) > 0:
                    gt_idx_map = {
                        i: gt_idx_map[j] for i, j in enumerate(np.where(g_match > -1)[0])
                    }
                cls_gt_class_ids = cls_gt_class_ids[g_match > -1] if len(g_match) > 0 else np.zeros(0)
                cls_gt_RTs = cls_gt_RTs[g_match > -1] if len(g_match) > 0 else np.zeros((0, 4, 4))
                cls_gt_up_syms = cls_gt_up_syms[g_match > -1] if len(g_match) > 0 else np.zeros(0)

            rt_overlaps = np.zeros((len(cls_pred_class_ids), len(cls_gt_class_ids), 2))
            for i in range(len(cls_pred_class_ids)):
                for j in range(len(cls_gt_class_ids)):
                    rt_overlaps[i, j, :] = compute_pose_error(
                        cls_pred_RTs[i], cls_gt_RTs[j], cls_gt_up_syms[j]
                    )

            pose_gt_match, pose_pred_match = match_by_pose(
                rt_overlaps, cls_pred_class_ids, cls_gt_class_ids,
                degree_thres_list, shift_thres_list,
            )
            for i in range(pose_pred_match.shape[2]):
                pose_pred_matches[:, :, progress, pred_idx_map[i]] = np.vectorize(
                    lambda k: gt_idx_map[k] if k != -1 else -1
                )(pose_pred_match[:, :, i])
            for i in range(pose_gt_match.shape[2]):
                pose_gt_matches[:, :, progress, gt_idx_map[i]] = np.vectorize(
                    lambda k: pred_idx_map[k] if k != -1 else -1
                )(pose_gt_match[:, :, i])

            pose_pred_matches_all[cls_id] = np.concatenate(
                (pose_pred_matches_all[cls_id], pose_pred_match), axis=-1)
            scores_tile = np.tile(cls_pred_scores, (nd, ns, 1))
            pose_pred_scores_all[cls_id] = np.concatenate(
                (pose_pred_scores_all[cls_id], scores_tile), axis=-1)
            pose_gt_matches_all[cls_id] = np.concatenate(
                (pose_gt_matches_all[cls_id], pose_gt_match), axis=-1)

    # --- accumulate APs -----------------------------------------------------
    for cls_id in range(1, num_classes):
        for s in range(ni):
            iou_aps[cls_id, s] = voc_ap(
                iou_pred_matches_all[cls_id][s, :],
                iou_pred_scores_all[cls_id][s, :],
                iou_gt_matches_all[cls_id][s, :],
            )
    iou_aps[-1, :] = np.mean(iou_aps[1:-1, :], axis=0)

    for i in range(nd):
        for j in range(ns):
            for cls_id in range(1, num_classes):
                pose_aps[cls_id, i, j] = voc_ap(
                    pose_pred_matches_all[cls_id][i, j, :],
                    pose_pred_scores_all[cls_id][i, j, :],
                    pose_gt_matches_all[cls_id][i, j, :],
                )
            pose_aps[-1, i, j] = np.mean(pose_aps[1:-1, i, j])

    _dump_outputs(log_dir, synset_names, iou_thres_list, iou_aps,
                  degree_thres_list, shift_thres_list, pose_aps,
                  use_matches_for_pose, plot)
    if verbose:
        _print_tables(synset_names, iou_thres_list, iou_aps,
                      degree_thres_list, shift_thres_list, pose_aps)
    return iou_aps, pose_aps, pose_pred_matches, pose_gt_matches


def _dump_outputs(log_dir, synset_names, iou_thres_list, iou_aps,
                  degree_thres_list, shift_thres_list, pose_aps,
                  use_matches_for_pose, plot):
    prefix = "Pose_Only_" if use_matches_for_pose else "Pose_Detection_"
    iou_pkl = os.path.join(
        log_dir, f"IoU_3D_AP_{iou_thres_list[0]}-{iou_thres_list[-1]}.pkl")
    with open(iou_pkl, "wb") as f:
        pickle.dump({"thres_list": iou_thres_list, "aps": iou_aps}, f)
    pose_pkl = os.path.join(
        log_dir,
        prefix + f"AP_{degree_thres_list[0]}-{degree_thres_list[-2]}degree_"
        f"{shift_thres_list[0]}-{shift_thres_list[-2]}cm.pkl")
    with open(pose_pkl, "wb") as f:
        pickle.dump(
            {"degree_thres": degree_thres_list, "shift_thres_list": shift_thres_list,
             "aps": pose_aps}, f)
    if not plot:
        return
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    fig = plt.figure()
    ax = plt.subplot(111)
    plt.ylabel("AP"); plt.ylim((0, 1)); plt.xlabel("3D IoU thresholds")
    for cls_id in range(1, len(synset_names)):
        ax.plot(iou_thres_list, iou_aps[cls_id, :], label=synset_names[cls_id])
    ax.plot(iou_thres_list, iou_aps[-1, :], label="mean")
    ax.legend()
    fig.savefig(os.path.join(
        log_dir, f"IoU_3D_AP_{iou_thres_list[0]}-{iou_thres_list[-1]}.png"))
    plt.close(fig)

    fig = plt.figure()
    plt.ylabel("Rotation thresholds/degree"); plt.xlabel("translation/cm")
    plt.imshow(pose_aps[-1, :-1, :-1][::-1], cmap="jet", interpolation="bilinear",
               extent=[shift_thres_list[0], shift_thres_list[-2],
                       degree_thres_list[0], degree_thres_list[-2]])
    plt.colorbar()
    plt.savefig(os.path.join(
        log_dir,
        prefix + f"mAP_{degree_thres_list[0]}-{degree_thres_list[-2]}degree_"
        f"{shift_thres_list[0]}-{shift_thres_list[-2]}cm.png"))
    plt.close(fig)


def _print_tables(synset_names, iou_thres_list, iou_aps,
                  degree_thres_list, shift_thres_list, pose_aps):
    for cls_id in range(1, len(synset_names)):
        if 0.25 in iou_thres_list:
            print(f"{synset_names[cls_id]} 3D IoU at 25: "
                  f"{iou_aps[cls_id, iou_thres_list.index(0.25)] * 100:.1f}")
        if 0.5 in iou_thres_list:
            print(f"{synset_names[cls_id]} 3D IoU at 50: "
                  f"{iou_aps[cls_id, iou_thres_list.index(0.5)] * 100:.1f}")
    if 0.25 in iou_thres_list:
        print(f"3D IoU at 25: {iou_aps[-1, iou_thres_list.index(0.25)] * 100:.1f}")
    if 0.5 in iou_thres_list:
        print(f"3D IoU at 50: {iou_aps[-1, iou_thres_list.index(0.5)] * 100:.1f}")
    for cls_id in range(1, len(synset_names)):
        for d in degree_thres_list:
            for s in shift_thres_list:
                print(f"{synset_names[cls_id]} {d} degree, {s}cm: "
                      f"{pose_aps[cls_id, degree_thres_list.index(d), shift_thres_list.index(s)] * 100:.1f}")
    for d in degree_thres_list:
        for s in shift_thres_list:
            print(f"{d} degree, {s}cm: "
                  f"{pose_aps[-1, degree_thres_list.index(d), shift_thres_list.index(s)] * 100:.1f}")
