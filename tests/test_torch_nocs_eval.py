"""The port's NOCS evaluation (eval/metrics.py, box3d.py, iou3d.py,
nocs_eval.py: numpy copies) against cppf_tpu's on seeded synthetic result
lists: floats to 1e-12, match indices bit for bit."""
import os
import pickle

import numpy as np
import pytest
import torch

from cppf_tpu.eval import metrics as metrics_j
from cppf_tpu.eval import nocs_eval as nocs_eval_j
from cppf_tpu.eval.box3d import Box3D as Box3DJ
from cppf_tpu.eval.iou3d import iou_boxes as iou_boxes_j
from cppf_tpu_torch.eval import metrics, nocs_eval
from cppf_tpu_torch.eval.box3d import Box3D
from cppf_tpu_torch.eval.iou3d import iou_boxes
from cppf_tpu_torch.eval.nocs_inference import SYNSET_NAMES

torch.set_num_threads(1)


def _rotation(rng):
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def _pose(rng, s_norm):
    RT = np.eye(4)
    RT[:3, :3] = _rotation(rng) * s_norm
    RT[:3, 3] = rng.uniform([-0.3, -0.2, 0.6], [0.3, 0.2, 1.2])
    return RT


def _near(rng, RT, scale, deg, cm):
    """A prediction near ``RT``: rotated by up to ``deg`` about a random
    axis, moved by up to ``cm``, its scale perturbed."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = np.radians(rng.uniform(0, deg))
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    dR = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K
    out = RT.copy()
    out[:3, :3] = dR @ RT[:3, :3] * rng.uniform(0.9, 1.1)
    out[:3, 3] += rng.normal(size=3) * cm / 100 / np.sqrt(3)
    s = scale * rng.uniform(0.85, 1.15, 3)
    return out, s / np.linalg.norm(s)


def _frame(rng, classes, n_fp=1, hidden_handles=False, empty_pred=False):
    """One frame's result dict: a GT instance of each of ``classes``, a
    prediction near each (some far off), ``n_fp`` false positives."""
    gt_RTs, gt_scales, pred_RTs, pred_scales, pred_cls = [], [], [], [], []
    for c in classes:
        s = rng.uniform(0.05, 0.3, 3)
        RT = _pose(rng, np.linalg.norm(s))
        gt_RTs.append(RT)
        gt_scales.append(s / np.linalg.norm(s))
        p, ps = _near(rng, RT, s, *((8, 4) if rng.random() < 0.7 else (60, 30)))
        pred_RTs.append(p), pred_scales.append(ps), pred_cls.append(c)
    for _ in range(n_fp):
        s = rng.uniform(0.05, 0.3, 3)
        pred_RTs.append(_pose(rng, np.linalg.norm(s)))
        pred_scales.append(s / np.linalg.norm(s))
        pred_cls.append(int(rng.integers(1, len(SYNSET_NAMES))))
    n_pred = 0 if empty_pred else len(pred_cls)
    vis = np.ones(len(classes), np.int32)
    if hidden_handles:
        vis[[i for i, c in enumerate(classes) if SYNSET_NAMES[c] == "mug"][::2]] = 0
    return {
        "image_path": "data/real/scene_1/0000",
        "gt_class_ids": np.asarray(classes, np.int32),
        "gt_RTs": np.asarray(gt_RTs, np.float32),
        "gt_scales": np.asarray(gt_scales, np.float32),
        "gt_handle_visibility": vis,
        "pred_class_ids": np.asarray(pred_cls, np.int32)[:n_pred],
        "pred_scores": rng.uniform(0.3, 1.0, len(pred_cls)).astype(np.float32)[:n_pred],
        "pred_RTs": np.asarray(pred_RTs, np.float32).reshape(-1, 4, 4)[:n_pred],
        "pred_scales": np.asarray(pred_scales, np.float32).reshape(-1, 3)[:n_pred],
    }


MUG, BOWL, CAN, BOTTLE = (SYNSET_NAMES.index(c) for c in ("mug", "bowl", "can", "bottle"))
CASES = {
    # every class, a false positive a frame
    "all_classes": lambda rng: [_frame(rng, list(range(1, 7))) for _ in range(3)],
    # the up-symmetric classes and mugs with hidden handles
    "up_sym_and_handles": lambda rng: [
        _frame(rng, [BOWL, BOTTLE, CAN, MUG, MUG, MUG], hidden_handles=True) for _ in range(3)],
    # a frame without predictions between two with them
    "empty_predictions": lambda rng: [_frame(rng, [BOWL, MUG]),
                                      _frame(rng, [CAN, BOTTLE], empty_pred=True),
                                      _frame(rng, [MUG, CAN])],
    # several instances of a class and many false positives
    "crowded": lambda rng: [_frame(rng, [BOWL, BOWL, BOWL, CAN, CAN], n_fp=4) for _ in range(2)],
}


def _write(results, pred_dir):
    os.makedirs(pred_dir)
    for k, r in enumerate(results):
        with open(os.path.join(pred_dir, f"results_real_scene_1_{k:04d}.pkl"), "wb") as f:
            pickle.dump(r, f)


@pytest.mark.parametrize("case", list(CASES))
def test_degree_cm_map_matches_jax(case, tmp_path):
    """``nocs_eval.load_results`` and ``compute_degree_cm_mAP`` of both
    packages on the same pkls, with the CLI's thresholds."""
    pred_dir = str(tmp_path / "pred")
    _write(CASES[case](np.random.default_rng(len(case))), pred_dir)
    res_t = nocs_eval.load_results(pred_dir, subsample=1)
    res_j = nocs_eval_j.load_results(pred_dir, subsample=1)
    for a, b in zip(res_t, res_j):
        np.testing.assert_array_equal(a["gt_up_syms"], b["gt_up_syms"])
    kw = dict(degree_thresholds=[5, 10, 15], shift_thresholds=[5, 10, 15],
              iou_3d_thresholds=np.linspace(0, 1, 101), iou_pose_thres=0.1,
              use_matches_for_pose=True, plot=False, verbose=False)
    out_t = metrics.compute_degree_cm_mAP(res_t, SYNSET_NAMES, str(tmp_path / "t"), **kw)
    out_j = metrics_j.compute_degree_cm_mAP(res_j, SYNSET_NAMES, str(tmp_path / "j"), **kw)
    for got, want in zip(out_t[:2], out_j[:2]):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    for got, want in zip(out_t[2:], out_j[2:]):
        np.testing.assert_array_equal(got, want)
    assert np.nanmax(out_t[0][1:-1]) > 0 and np.nanmax(out_t[1][1:-1]) > 0  # some matches
    for name in os.listdir(tmp_path / "j"):
        with open(tmp_path / "t" / name, "rb") as f_t, open(tmp_path / "j" / name, "rb") as f_j:
            dump_t, dump_j = pickle.load(f_t), pickle.load(f_j)
        np.testing.assert_allclose(dump_t["aps"], dump_j["aps"], rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("up_sym", [False, True])
def test_pairwise_errors_match_jax(seed, up_sym):
    """``compute_3d_iou``, ``compute_pose_error`` and ``iou_boxes`` on
    overlapping and disjoint box pairs."""
    rng = np.random.default_rng(seed)
    for deg, cm in ((5, 2), (30, 8), (90, 40)):
        s1 = rng.uniform(0.05, 0.3, 3)
        RT1 = _pose(rng, np.linalg.norm(s1))
        RT2, s2 = _near(rng, RT1, s1, deg, cm)
        s1 = s1 / np.linalg.norm(s1)
        iou = metrics.compute_3d_iou(RT1, RT2, s1, s2, up_sym, "bowl", "bowl")
        assert abs(iou - metrics_j.compute_3d_iou(RT1, RT2, s1, s2, up_sym, "bowl",
                                                  "bowl")) <= 1e-12
        np.testing.assert_allclose(metrics.compute_pose_error(RT1, RT2, up_sym),
                                   metrics_j.compute_pose_error(RT1, RT2, up_sym),
                                   rtol=0, atol=1e-12)
        R1 = RT1[:3, :3] / np.cbrt(np.linalg.det(RT1[:3, :3]))
        R2 = RT2[:3, :3] / np.cbrt(np.linalg.det(RT2[:3, :3]))
        args = ((R1, RT1[:3, 3], s1), (R2, RT2[:3, 3], s2))
        got = iou_boxes(*(Box3D.from_transformation(*a) for a in args))
        want = iou_boxes_j(*(Box3DJ.from_transformation(*a) for a in args))
        assert abs(got - want) <= 1e-12
        assert metrics.compute_pose_error(None, RT2, up_sym).tolist() == [-1.0, -1.0]
