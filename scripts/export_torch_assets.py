"""Export a category's weights and test views for the PyTorch port.

Writes two files into ``cppf_tpu_torch/assets/``:

- ``<cat>_params_best.npz``: ``checkpoints/<cat>/params_best`` as flat
  arrays, one key per leaf of the params tree, path parts joined by ``/``
  (``point/params/spconv0/kernel/lin0/kernel`` ...).  The port reads only
  this file, so it needs no orbax.
- ``<cat>_views.npz``: ``--n_views`` depth-rendered views, built as
  ``scripts/eval_checkpoints.py`` builds them (native rasterizer →
  ``backproject`` → x/y sign fix, NOCS categories through ``FLIP2NOCS``,
  seed ``--seed``).  Per view ``i``: ``pc_i`` (the cloud, stride-subsampled
  to ``npoint_max`` with ``np.linspace`` as both runners do, so that they
  see the identical input), ``R_i``/``T_i`` (GT pose), ``bound_i`` (GT NOCS
  extent, the scale target) and the JAX ``CategoryRunner.estimate`` result
  on the CPU with the same per-view key schedule: ``jax_T_i``, ``jax_up_i``,
  ``jax_scale_i``, and ``jax_right_i`` where the category regresses its
  right axis; ``jax_key_i`` (uint32 [2]) is the key of that run, from which
  ``PoseDraws.from_jax_key`` remakes its draws in torch.  For laptop also
  ``laptop_up_i`` (GT up oriented toward the camera, the plane override's
  stand-in) and the JAX estimate with that override: ``jax_ov_T_i``,
  ``jax_ov_up_i``, ``jax_ov_right_i``, ``jax_ov_scale_i``.

With ``--nocs_frame`` it writes instead ``cppf_tpu_torch/assets/nocs_frame/``,
one rendered NOCS-format frame and the JAX NOCS driver's output on it:

- ``real/scene_1/0000_depth.png`` (uint16 mm) and ``0000_color.png``, written
  by ``cv2``: ``FRAME_LAYOUT``'s instances (native rasterizer, the
  categories' primitives, REAL275 intrinsics, 640×480), z-buffer composited
  with a mask each;
- ``results_real_scene1_0000.pkl.gz``: the detection record (masks, boxes,
  classes, scores, GT), gzipped;
- ``jax_driver.npz``: ``cppf_tpu.eval.nocs_inference.main`` on the CPU at
  full width with ``--seed 0`` on a checkpoint tree that links
  ``checkpoints/<cat>`` for the frame's categories (no ``laptop_aux``):
  ``pred_RTs``, ``pred_scales`` and each instance's ``T``, ``up``,
  ``right`` (from ``pred_RTs``); and ``cppf_tpu.eval.nocs_eval.main`` on
  that output (``--subsample 1``): ``iou_aps``, ``pose_aps``,
  ``pose_pred_matches``, ``pose_gt_matches``.

With ``--sun_scans`` it writes instead ``cppf_tpu_torch/assets/sun_scans/``:

- ``scans.npz``: the scans of ``sun_scan_set`` (``make_scans``, one scan
  of 2 instances of each weighted SUN category and one that joins two
  categories, with a segment under the drivers' 200-point floor), in the
  flat arrays of ``chip_smoke.sun_scans_to_arrays``;
- ``jax_driver.npz``: ``cppf_tpu.eval.sunrgbd_inference.main`` on the CPU
  at full width with ``--seed 0`` and its default 30° up prior on a
  checkpoint tree that links ``checkpoints/<cat>`` for the six: each posed
  instance's ``class_id``, ``scan``, box ``index``, result ``rows`` and its
  ``T``, ``R``, ``scale``, ``up``, ``right``; and
  ``cppf_tpu.eval.sunrgbd_eval.main`` on that output: ``<cat>_iou_aps``,
  ``<cat>_pose_aps``, ``<cat>_pose_pred_matches``, ``<cat>_pose_gt_matches``.

With ``--laptop_frame`` it writes ``cppf_tpu_torch/assets/nocs_laptop_frame/``,
a rendered NOCS frame of ``LAPTOP_LAYOUT`` (a mug, a laptop from
``random_laptop``, a bowl; ``render_nocs_frame``) and the JAX driver's run
on it at full width with ``--seed 0`` and the laptop segmenter on its real
weights (a checkpoint tree linking ``checkpoints/{mug,laptop,bowl,
laptop_aux}``): ``real/``, ``results_real_scene1_0000.pkl.gz`` as for
``--nocs_frame``, and ``jax_driver.npz`` with ``pred_RTs``, ``pred_scales``,
``T``, ``up``, ``right`` of each instance, the laptop's instance index
``laptop``, its keys ``r_inst`` and ``r_plane`` (uint32 [2]), its
segmenter ``crop`` [224, 224, 3], the label map ``labels`` [224, 224],
``idxs_resized`` [n, 2], ``laptop_up``, its pose before the override
(``before_T``, ``before_R``, ``before_scale``) and after it (``after_*``),
and ``seed``.

With ``--flags`` it writes ``cppf_tpu_torch/assets/flag_views.npz``: for
each cell of ``chip_smoke.FLAG_CELLS`` (pose flags that no category config
turns on, alone or in sets, on a category's committed views) the JAX
``CategoryRunner.estimate`` on the CPU at the category's full width with
the cell's flags set on its PoseConfig, on the key of the view's stored
JAX run (``chip_smoke.view_keys``): ``<cell>_T_i``, ``<cell>_up_i``, ``<cell>_scale_i``,
``<cell>_n_filtered_i`` and ``<cell>_right_i`` where the category
regresses its right axis.

Usage (needs JAX; runs on the CPU):
    python scripts/export_torch_assets.py [--category bowl] [--n_views 4] [--seed 0]
    python scripts/export_torch_assets.py --nocs_frame   (~5 min)
    python scripts/export_torch_assets.py --sun_scans    (~2 min)
    python scripts/export_torch_assets.py --laptop_frame
    python scripts/export_torch_assets.py --flags         (~5 min)
"""
from __future__ import annotations

import argparse
import gzip
import os
import pickle
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
ASSETS = os.path.join(ROOT, "cppf_tpu_torch", "assets")


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dict of arrays → {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def _store(views, prefix, i, out, right: bool):
    keys = ("T", "up", "scale") + (("right",) if right else ())
    for k in keys:
        views[f"{prefix}{k}_{i}"] = np.asarray(getattr(out, k), np.float32)


def render_views(category: str, n_views: int, seed: int, runner):
    """Depth-rendered views of ``category`` and the JAX pipeline's estimate
    of each."""
    import jax

    from cppf_tpu.core.geometry import backproject
    from cppf_tpu.data import native
    from cppf_tpu.data.shapenet import FLIP2NOCS, NOCS_CATEGORIES
    from cppf_tpu.data.synthetic import mesh_bounds, observation_pose, random_primitive
    from cppf_tpu.eval.nocs_inference import REAL275_INTRINSICS

    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    K = REAL275_INTRINSICS
    is_nocs = category in NOCS_CATEGORIES
    n_max = runner.cfg.npoint_max
    views = {}
    i = 0
    while i < n_views:
        mesh = random_primitive(category, rng)
        lo, hi = mesh_bounds(mesh)
        diag = float(np.linalg.norm(hi - lo))
        scale = float(rng.uniform(*runner.cfg.scale_range))
        R, T = observation_pose(rng, is_nocs=is_nocs)
        v_canon = (mesh.vertices - (lo + hi) / 2) / diag * scale
        if is_nocs:
            v_canon = v_canon @ FLIP2NOCS.T
        v_render = (v_canon @ R.T + T) * np.float32([1, -1, -1])
        depth = native.rasterize_depth(v_render, mesh.faces, K[0, 0], K[1, 1],
                                       K[0, 2], K[1, 2], 640, 480)
        mask = depth > 0
        if mask.sum() < 300:
            continue
        pc, _ = backproject(depth, K, mask)
        pc[:, 0] = -pc[:, 0]
        pc[:, 1] = -pc[:, 1]
        pc = pc.astype(np.float32)
        if len(pc) > n_max:
            pc = pc[np.linspace(0, len(pc) - 1, n_max).astype(int)]
        key, k1 = jax.random.split(key)
        out, _ = runner.estimate(k1, pc)
        views[f"pc_{i}"] = pc
        views[f"R_{i}"] = R.astype(np.float32)
        views[f"T_{i}"] = T.astype(np.float32)
        views[f"bound_{i}"] = ((hi - lo) / diag * scale).astype(np.float32)
        views[f"jax_key_{i}"] = np.asarray(jax.random.key_data(k1), np.uint32)
        _store(views, "jax_", i, out, runner.cfg.regress_right)
        if category == "laptop":
            lup = (R[:, 1] * (-1.0 if float(R[:, 1] @ T) > 0 else 1.0)).astype(np.float32)
            views[f"laptop_up_{i}"] = lup
            out_ov, _ = runner.estimate(k1, pc, laptop_up=lup)
            _store(views, "jax_ov_", i, out_ov, True)
        t_err = float(np.linalg.norm(np.asarray(out.T) - T))
        up_err = float(np.degrees(np.arccos(np.clip(np.asarray(out.up) @ R[:, 1], -1, 1))))
        print(f"view {i}: {len(pc)} points, JAX T err {t_err * 1000:.1f} mm, "
              f"up err {up_err:.1f} deg", flush=True)
        i += 1
    views["n_views"] = np.int32(n_views)
    return views


# the frame's instances: (category, x, y, z) in the driver's camera frame
# (meters; +y down the image, +z away); the categories of 3, 2 and 1+1
# instances make a batched chunk padded from 3 to 4, one of 2, and two
# singletons, one of them mug with its second center pass
FRAME_LAYOUT = (("can", -0.27, 0.10, 0.80), ("bowl", -0.05, 0.12, 0.78),
                ("mug", 0.20, 0.10, 0.82), ("bowl", 0.30, -0.08, 1.05),
                ("can", 0.05, -0.10, 1.10), ("camera", -0.22, -0.08, 1.02),
                ("bowl", -0.40, -0.14, 1.20))


def render_nocs_frame(out_root: str, layout=FRAME_LAYOUT, seed: int = 0):
    """A NOCS-format frame of ``layout``'s instances, each a random
    primitive of its category at a random training-distribution rotation,
    z-buffer composited: writes ``<out_root>/nocs/real/scene_1/0000_{depth,
    color}.png`` and ``<out_root>/seg/results_real_scene1_0000.pkl``.
    Returns (seg_dir, nocs_dir, the record)."""
    import cv2

    from cppf_tpu.config import load_config
    from cppf_tpu.data import native
    from cppf_tpu.data.shapenet import FLIP2NOCS
    from cppf_tpu.data.synthetic import mesh_bounds, observation_pose, random_primitive
    from cppf_tpu.eval.nocs_inference import REAL275_INTRINSICS, SYNSET_NAMES

    rng = np.random.default_rng(seed)
    K = REAL275_INTRINSICS
    depths, gts = [], []
    for cat, x, y, z in layout:
        mesh = random_primitive(cat, rng)
        lo, hi = mesh_bounds(mesh)
        diag = float(np.linalg.norm(hi - lo))
        scale = float(rng.uniform(*load_config(cat).scale_range))
        R, _ = observation_pose(rng, is_nocs=True)
        T = np.array([x, y, z])
        v_canon = (mesh.vertices - (lo + hi) / 2) / diag * scale @ FLIP2NOCS.T
        # the driver's backprojection recovers (x, -y_render, -z_render)
        v_render = (v_canon @ R.T + T) * np.float32([1, -1, -1])
        depths.append(native.rasterize_depth(v_render.astype(np.float32), mesh.faces,
                                             K[0, 0], K[1, 1], K[0, 2], K[1, 2], 640, 480))
        gts.append((R, T, (hi - lo) / diag * scale @ np.abs(FLIP2NOCS.T)))
    stack = np.where(np.stack(depths) > 0, np.stack(depths), np.inf)
    nearest = np.argmin(stack, axis=0)
    hit = np.isfinite(stack.min(axis=0))
    depth = np.where(hit, stack.min(axis=0), 0.0)
    # colour: each instance its hue, shaded by depth
    hues = np.float32([[200, 60, 50], [60, 160, 220], [230, 200, 60], [90, 200, 90],
                       [180, 90, 200], [240, 140, 40], [120, 120, 240]])
    shade = np.clip(1.4 - depth / 1.5, 0.2, 1.0)[:, :, None]
    rgb = np.where(hit[:, :, None], hues[nearest % len(hues)] * shade, 40).astype(np.uint8)

    frame_dir = os.path.join(out_root, "nocs", "real", "scene_1")
    seg_dir = os.path.join(out_root, "seg")
    os.makedirs(frame_dir, exist_ok=True)
    os.makedirs(seg_dir, exist_ok=True)
    cv2.imwrite(os.path.join(frame_dir, "0000_depth.png"), (depth * 1000).astype(np.uint16))
    cv2.imwrite(os.path.join(frame_dir, "0000_color.png"), rgb[:, :, ::-1])
    masks, boxes, gt_RTs, gt_scales = [], [], [], []
    for i, (R, T, bound) in enumerate(gts):
        mask = hit & (nearest == i)
        assert mask.sum() > 300, f"instance {i} shows {mask.sum()} pixels"
        rows, cols = np.where(mask)
        masks.append(mask)
        boxes.append([rows.min(), cols.min(), rows.max(), cols.max()])
        # NOCS GT conventions: RT holds R·|s|, gt_scales the unit scale
        s_norm = float(np.linalg.norm(bound))
        RT = np.eye(4, dtype=np.float32)
        RT[:3, :3] = R * s_norm
        RT[:3, 3] = T
        gt_RTs.append(RT)
        gt_scales.append(bound / s_norm)
    cls = np.array([SYNSET_NAMES.index(c) for c, *_ in layout], np.int32)
    record = {
        "image_path": "data/real/scene_1/0000",
        "pred_bboxes": np.asarray(boxes, np.int32),
        "pred_masks": np.stack(masks, -1),
        "pred_class_ids": cls,
        "pred_scores": np.linspace(0.95, 0.65, len(layout)).astype(np.float32),
        "gt_class_ids": cls,
        "gt_RTs": np.stack(gt_RTs),
        "gt_scales": np.asarray(gt_scales, np.float32),
        "gt_handle_visibility": np.ones(len(layout), np.int32),
    }
    with open(os.path.join(seg_dir, "results_real_scene1_0000.pkl"), "wb") as f:
        pickle.dump(record, f)
    return seg_dir, os.path.join(out_root, "nocs"), record


def link_checkpoints(ckpt_root: str, categories):
    """A checkpoint tree of ``categories`` only, each a link to the repo's
    ``checkpoints/<cat>`` (so no ``laptop_aux``)."""
    os.makedirs(ckpt_root, exist_ok=True)
    for cat in sorted(set(categories)):
        os.symlink(os.path.join(ROOT, "checkpoints", cat), os.path.join(ckpt_root, cat))
    return ckpt_root


def frame_axes(pred_RTs):
    """(T, up, right) of each pose row: R = RT[:3, :3] / ∛det, up its
    second column and right its first (no NOCS category has ``z_right``)."""
    R = pred_RTs[:, :3, :3] / np.cbrt(np.linalg.det(pred_RTs[:, :3, :3]))[:, None, None]
    return pred_RTs[:, :3, 3], R[:, :, 1], R[:, :, 0]


def export_nocs_frame(seed: int = 0):
    from cppf_tpu.eval import nocs_eval, nocs_inference

    out = os.path.join(ASSETS, "nocs_frame")
    with tempfile.TemporaryDirectory() as tmp:
        seg_dir, nocs_dir, record = render_nocs_frame(tmp)
        ckpt = link_checkpoints(os.path.join(tmp, "checkpoints"),
                                [c for c, *_ in FRAME_LAYOUT])
        pred_dir = os.path.join(tmp, "pred")
        nocs_inference.main(["--seg_dir", seg_dir, "--nocs_dir", nocs_dir, "--out_dir", pred_dir,
                             "--ckpt_path", ckpt, "--seed", str(seed)])
        with open(os.path.join(pred_dir, "results_real_scene_1_0000.pkl"), "rb") as f:
            pred = pickle.load(f)
        iou_aps, pose_aps, pred_m, gt_m = nocs_eval.main(["--pred_dir", pred_dir,
                                                          "--subsample", "1"])
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(os.path.join(nocs_dir, "real"), os.path.join(out, "real"))
    with gzip.open(os.path.join(out, "results_real_scene1_0000.pkl.gz"), "wb") as f:
        pickle.dump(record, f)
    T, up, right = frame_axes(pred["pred_RTs"])
    np.savez_compressed(os.path.join(out, "jax_driver.npz"), pred_RTs=pred["pred_RTs"],
                        pred_scales=pred["pred_scales"], T=T, up=up, right=right,
                        iou_aps=iou_aps, pose_aps=pose_aps, pose_pred_matches=pred_m,
                        pose_gt_matches=gt_m, seed=np.int32(seed))
    for i, (c, *_) in enumerate(FRAME_LAYOUT):
        gt = record["gt_RTs"][i]
        print(f"instance {i} ({c}): JAX T err {np.linalg.norm(T[i] - gt[:3, 3]) * 1e3:.1f} mm, "
              f"up err {np.degrees(np.arccos(np.clip(up[i] @ gt[:3, 1] / np.linalg.norm(gt[:3, 1]), -1, 1))):.1f} deg",
              flush=True)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(out) for f in fs)
    print(f"wrote {out}: {size} bytes", flush=True)


# the laptop frame: the laptop between a mug and a bowl, so that the driver
# poses it (twice, with the segmenter's up axis) between two singletons
LAPTOP_LAYOUT = (("mug", -0.32, 0.14, 0.95), ("laptop", 0.02, 0.02, 1.10),
                 ("bowl", 0.34, 0.16, 0.92))


def export_laptop_frame(seed: int = 0):
    """The JAX driver on the laptop frame, its laptop path recorded: the
    runner's two ``estimate`` calls on the laptop, the segmenter's input and
    labels, and ``laptop_up_from_aux``'s arguments and result."""
    from cppf_tpu.eval import nocs_inference
    from cppf_tpu.models import segmenter

    rec = {}
    real_estimate = nocs_inference.CategoryRunner.estimate
    real_up = nocs_inference.laptop_up_from_aux
    real_predict = segmenter.SegmenterRunner.predict

    def estimate(self, rng, pc_raw, laptop_up=None):
        out = real_estimate(self, rng, pc_raw, laptop_up)
        if self.cfg.category == "laptop":
            rec["after" if laptop_up is not None else "before"] = out[0]
            rec["r_inst"] = np.asarray(rng, np.uint32)
        return out

    def predict(self, rgb):
        rec["crop"], rec["labels"] = np.asarray(rgb, np.float32), real_predict(self, rgb)
        return rec["labels"]

    def laptop_up(img, depth_mask_idxs, pc, pre, seg, rng):
        rec["r_plane"], rec["mask_idxs"] = np.asarray(rng, np.uint32), depth_mask_idxs
        rec["laptop_up"] = real_up(img, depth_mask_idxs, pc, pre, seg, rng)
        return rec["laptop_up"]

    out = os.path.join(ASSETS, "nocs_laptop_frame")
    nocs_inference.CategoryRunner.estimate = estimate
    nocs_inference.laptop_up_from_aux = laptop_up
    segmenter.SegmenterRunner.predict = predict
    try:
        with tempfile.TemporaryDirectory() as tmp:
            seg_dir, nocs_dir, record = render_nocs_frame(tmp, LAPTOP_LAYOUT, seed)
            ckpt = link_checkpoints(os.path.join(tmp, "checkpoints"),
                                    [c for c, *_ in LAPTOP_LAYOUT] + ["laptop_aux"])
            pred_dir = os.path.join(tmp, "pred")
            nocs_inference.main(["--seg_dir", seg_dir, "--nocs_dir", nocs_dir, "--out_dir",
                                 pred_dir, "--ckpt_path", ckpt, "--seed", str(seed)])
            with open(os.path.join(pred_dir, "results_real_scene_1_0000.pkl"), "rb") as f:
                pred = pickle.load(f)
            shutil.rmtree(out, ignore_errors=True)
            shutil.copytree(os.path.join(nocs_dir, "real"), os.path.join(out, "real"))
    finally:
        nocs_inference.CategoryRunner.estimate = real_estimate
        nocs_inference.laptop_up_from_aux = real_up
        segmenter.SegmenterRunner.predict = real_predict
    if rec.get("laptop_up") is None or "after" not in rec:
        raise SystemExit("the JAX driver did not override the laptop's up axis on this frame")
    with gzip.open(os.path.join(out, "results_real_scene1_0000.pkl.gz"), "wb") as f:
        pickle.dump(record, f)
    rows, cols = rec["mask_idxs"]
    bbox = np.array([[rows.min(), rows.max()], [cols.min(), cols.max()]])
    idxs = np.clip(((np.stack([rows, cols], -1) - bbox[:, 0]) * (224 / (bbox[:, 1] - bbox[:, 0])))
                   .astype(np.int64), 0, 223)
    T, up, right = frame_axes(pred["pred_RTs"])
    arrays = dict(pred_RTs=pred["pred_RTs"], pred_scales=pred["pred_scales"], T=T, up=up,
                  right=right, laptop=np.int32([c for c, *_ in LAPTOP_LAYOUT].index("laptop")),
                  r_inst=rec["r_inst"], r_plane=rec["r_plane"], crop=rec["crop"],
                  labels=rec["labels"].astype(np.uint8), idxs_resized=idxs.astype(np.int16),
                  laptop_up=np.asarray(rec["laptop_up"], np.float32), seed=np.int32(seed))
    for when in ("before", "after"):
        o = rec[when]
        arrays.update({f"{when}_T": np.asarray(o.T, np.float32),
                       f"{when}_R": np.asarray(o.R, np.float32),
                       f"{when}_scale": np.asarray(o.scale, np.float32)})
    np.savez_compressed(os.path.join(out, "jax_driver.npz"), **arrays)
    gt = record["gt_RTs"][arrays["laptop"]]
    lap_up = arrays["after_R"][:, 1]
    print(f"laptop: {int((rec['labels'] == 0).sum())} base pixels of 224^2; laptop_up "
          f"{arrays['laptop_up']}; up err against GT before "
          f"{np.degrees(np.arccos(np.clip(arrays['before_R'][:, 1] @ gt[:3, 1] / np.linalg.norm(gt[:3, 1]), -1, 1))):.2f} deg, after "
          f"{np.degrees(np.arccos(np.clip(lap_up @ gt[:3, 1] / np.linalg.norm(gt[:3, 1]), -1, 1))):.2f} deg; T err "
          f"{np.linalg.norm(arrays['after_T'] - gt[:3, 3]) * 1e3:.1f} mm", flush=True)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(out) for f in fs)
    print(f"wrote {out}: {size} bytes", flush=True)


# the SUN scan set: a scan of 2 instances of each weighted SUN category,
# then one that holds instances of two categories (the first's second
# segment cut to SMALL_SEGMENT points, under the drivers' 200-point floor)
SUN_CATEGORIES = ("bed", "table", "sofa", "chair", "bookshelf", "bathtub")
SUN_MIXED = ("chair", "table")
SMALL_SEGMENT = 150


def _make_scan(scratch, cat, instances, seed):
    """One scan of ``make_scans`` in a scratch directory of its own, read
    back as a dict (see chip_smoke.sun_scans_to_arrays)."""
    from cppf_tpu.data.sunrgbd_synth import make_scans
    from cppf_tpu.eval.sunrgbd_inference import TYPE2CLASS

    d = tempfile.mkdtemp(dir=scratch)
    extra = os.path.join(d, "extra")
    make_scans(os.path.join(d, "sun"), extra, cat, TYPE2CLASS[cat], 1, instances=instances,
               seed=seed)
    base = os.path.join(extra, "sunrgbd_pc_bbox_votes_50k_v1_val", "1")
    with open(base + "_segments.pkl", "rb") as f:
        segments = pickle.load(f)
    return dict(pc=np.load(base + "_pc.npz")["pc"], rot=np.load(base + "_rot.npy"),
                bbox=np.load(base + "_bbox.npy"), segments=segments)


def _tilt(rng, max_deg=5.0):
    """A small camera tilt about the upright frame's x and y axes, as SUN
    RGB-D's Rtilt."""
    a, b = np.radians(rng.uniform(-max_deg, max_deg, 2))
    rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
    return rx @ ry


def sun_scan_set(scratch, categories=SUN_CATEGORIES, mixed=SUN_MIXED, seed=0):
    """SUN RGB-D-format scans from ``cppf_tpu.data.sunrgbd_synth.make_scans``
    (native rasterizer, one depth view, at most 6000 points an object,
    half-extent box coeffs, a random ``rot``): one scan of 2 instances of each of ``categories``, then one
    that joins 2 instances of ``mixed[0]`` (its second segment cut to
    ``SMALL_SEGMENT`` points) and 1 of ``mixed[1]``, moved 6 m along x (its
    floor left out).  Each scan gets its own small random ``Rtilt``."""
    rng = np.random.default_rng(seed)
    scans = [_make_scan(scratch, cat, 2, seed + k) for k, cat in enumerate(categories)]
    a = _make_scan(scratch, mixed[0], 2, seed + len(categories))
    b = _make_scan(scratch, mixed[1], 1, seed + len(categories) + 1)
    shift = np.array([6.0, 0.0, 0.0], np.float32)  # stored x is the world's x
    n_b = len(b["segments"][0])
    b_bbox = b["bbox"].copy()
    b_bbox[:, 0] += shift[0]
    a["segments"][1] = a["segments"][1][:SMALL_SEGMENT]
    scans.append(dict(
        pc=np.concatenate([a["pc"], b["pc"][:n_b] + shift]), rot=a["rot"],
        bbox=np.concatenate([a["bbox"], b_bbox]),
        segments=a["segments"] + [b["segments"][0] + len(a["pc"])]))
    for s in scans:
        s["Rtilt"] = _tilt(rng)
    return scans


def export_sun_scans(seed: int = 0):
    """``assets/sun_scans/``: the scan set and the JAX SUN driver's output
    on it (full width, ``--seed`` 0, the up prior at its default 30°) with
    the JAX eval of that output."""
    import chip_smoke
    from cppf_tpu.config import load_config
    from cppf_tpu.eval import sunrgbd_eval, sunrgbd_inference

    out = os.path.join(ASSETS, "sun_scans")
    os.makedirs(out, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        scans = sun_scan_set(tmp)
        sun_dir, extra_dir = chip_smoke.write_sun_layout(scans, os.path.join(tmp, "set"))
        ckpt = link_checkpoints(os.path.join(tmp, "checkpoints"), SUN_CATEGORIES)
        pred_dir = os.path.join(tmp, "pred")
        sunrgbd_inference.main(["--sunrgbd_dir", sun_dir, "--sunrgbd_extra_dir", extra_dir,
                                "--out_dir", pred_dir, "--ckpt_path", ckpt,
                                "--seed", str(seed)])
        aps = sunrgbd_eval.main(["--pred_dir", pred_dir, "--sunrgbd_dir", sun_dir,
                                 "--sunrgbd_extra_dir", extra_dir,
                                 "--categories", *SUN_CATEGORIES])
        rows, where = [], []
        for cat, cid in sunrgbd_inference.TYPE2CLASS.items():
            path = os.path.join(pred_dir, f"results_{cat}.pkl")
            if not os.path.exists(path):
                continue
            with open(path, "rb") as f:
                pred = pickle.load(f)
            for name, scan_rows in pred.items():
                s = scans[int(name) - 1]
                # the posed boxes of the class, in the drivers' order
                idx = [i for i, b in enumerate(s["bbox"])
                       if int(b[7]) == cid and len(s["segments"][i]) >= 200]
                assert len(idx) == len(scan_rows), (cat, name)
                rows += scan_rows
                where += [(cid, int(name), i) for i in idx]
    np.savez_compressed(os.path.join(out, "scans.npz"), **chip_smoke.sun_scans_to_arrays(scans))
    rows = np.asarray(rows, np.float64)
    R = rows[:, 5:14].reshape(-1, 3, 3)
    z_right = {cid: load_config(cat).z_right
               for cat, cid in sunrgbd_inference.TYPE2CLASS.items()}
    right = np.stack([r[:, 2] if z_right[int(c)] else r[:, 0] for r, c in zip(R, rows[:, 0])])
    arrays = dict(rows=rows, class_id=np.int32([w[0] for w in where]),
                  scan=np.int32([w[1] for w in where]), index=np.int32([w[2] for w in where]),
                  T=rows[:, 14:17], R=R, scale=rows[:, 2:5], up=R[:, :, 1], right=right,
                  seed=np.int32(seed), up_prior_deg=np.float32(30.0))
    for cat, (iou_aps, pose_aps, pred_m, gt_m) in aps.items():
        arrays.update({f"{cat}_iou_aps": iou_aps, f"{cat}_pose_aps": pose_aps,
                       f"{cat}_pose_pred_matches": pred_m, f"{cat}_pose_gt_matches": gt_m})
    np.savez_compressed(os.path.join(out, "jax_driver.npz"), **arrays)
    for k, (c, sc, i) in enumerate(where):
        s = scans[sc - 1]
        b = s["bbox"][i]
        t_gt = sunrgbd_inference.EX_MAT @ s["rot"] @ np.array([b[0], b[1], b[2]])
        print(f"instance {k} (class {c}, scan {sc}, box {i}): JAX T err "
              f"{np.linalg.norm(arrays['T'][k] - t_gt) * 1e3:.1f} mm", flush=True)
    for cat, (iou_aps, pose_aps, _, _) in aps.items():
        print(f"{cat}: JAX 3D IoU AP at 0.25 {iou_aps[-1, 25]:.4f}, pose AP at 10 deg 10 cm "
              f"{pose_aps[-1, 1, 1]:.4f}", flush=True)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(out) for f in fs)
    print(f"wrote {out}: {size} bytes", flush=True)


def export_flag_views(ckpt_path: str):
    """``assets/flag_views.npz`` (see the module docstring)."""
    import dataclasses

    import jax.numpy as jnp

    import chip_smoke
    from cppf_tpu.eval.nocs_inference import CategoryRunner

    class Args:
        num_rots = 72
        angle_prec = 1.5
        adaptive_voting = False
        ckpt_name = None

    runners, out = {}, {}
    for name, cat, flags, views in chip_smoke.FLAG_CELLS:
        if cat not in runners:
            runners[cat] = (CategoryRunner(cat, ckpt_path, Args),
                            np.load(os.path.join(ASSETS, f"{cat}_views.npz")))
        runner, z = runners[cat]
        keys = chip_smoke.view_keys(z)
        base = runner.pcfg
        runner.pcfg = dataclasses.replace(base, **flags)
        for i in views:
            res, _ = runner.estimate(jnp.asarray(np.array(keys[i], np.uint32)), z[f"pc_{i}"])
            _store(out, f"{name}_", i, res, runner.cfg.regress_right)
            out[f"{name}_n_filtered_{i}"] = np.int32(res.n_filtered)
            t_err = float(np.linalg.norm(np.asarray(res.T) - z[f"T_{i}"]))
            print(f"{name} ({cat}) view {i}: T err {t_err * 1000:.1f} mm, T moved "
                  f"{np.linalg.norm(np.asarray(res.T) - z[f'jax_T_{i}']) * 1000:.2f} mm from "
                  f"the unflagged estimate, survivors {int(res.n_filtered)}", flush=True)
        runner.pcfg = base
    np.savez_compressed(os.path.join(ASSETS, "flag_views.npz"), **out)
    print(f"wrote {len(out)} arrays to flag_views.npz", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--category", default="bowl")
    ap.add_argument("--n_views", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt_path", default=os.path.join(ROOT, "checkpoints"))
    ap.add_argument("--nocs_frame", action="store_true",
                    help="write assets/nocs_frame/ instead of a category's assets")
    ap.add_argument("--sun_scans", action="store_true",
                    help="write assets/sun_scans/ instead of a category's assets")
    ap.add_argument("--laptop_frame", action="store_true",
                    help="write assets/nocs_laptop_frame/ instead of a category's assets")
    ap.add_argument("--flags", action="store_true",
                    help="write assets/flag_views.npz, JAX's estimates under the pose flags")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.nocs_frame:
        export_nocs_frame(args.seed)
        return
    if args.sun_scans:
        export_sun_scans(args.seed)
        return
    if args.laptop_frame:
        export_laptop_frame(args.seed)
        return
    if args.flags:
        export_flag_views(args.ckpt_path)
        return
    from cppf_tpu.eval.nocs_inference import CategoryRunner
    from cppf_tpu.train.checkpoints import load_params

    cat = args.category
    os.makedirs(ASSETS, exist_ok=True)
    params = load_params(os.path.join(args.ckpt_path, cat), "params_best")
    flat = flatten_tree(params)
    np.savez(os.path.join(ASSETS, f"{cat}_params_best.npz"), **flat)
    print(f"wrote {len(flat)} arrays to {cat}_params_best.npz", flush=True)

    class Args:
        num_rots = 72
        angle_prec = 1.5
        adaptive_voting = False
        ckpt_name = None

    runner = CategoryRunner(cat, args.ckpt_path, Args)
    views = render_views(cat, args.n_views, args.seed, runner)
    np.savez_compressed(os.path.join(ASSETS, f"{cat}_views.npz"), **views)
    print(f"wrote {args.n_views} views to {cat}_views.npz", flush=True)


if __name__ == "__main__":
    main()
