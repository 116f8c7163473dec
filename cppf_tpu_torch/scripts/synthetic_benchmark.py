"""End-to-end synthetic quality benchmark (counterpart of
scripts/synthetic_benchmark.py): render frames of posed primitives, run the
NOCS driver with a trained checkpoint, score the result with the NOCS mAP
protocol.

The frames are those of the JAX script for the same arguments: the same
``default_rng(seed)`` stream through ``data/synthetic.py`` and the same
rasterizer (``data/native.py``), the depth written as a 16-bit grey PNG by
``data/png.py`` (decoded pixels equal to ``cv2.imwrite``'s).  The driver
(``eval/nocs_inference.py``) takes the JAX driver's draws for ``--seed``.

Usage:
    python -m cppf_tpu_torch.scripts.synthetic_benchmark --ckpt_path checkpoints \\
        --category bowl --n_frames 20 [--out_dir DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np

from cppf_tpu_torch.config import load_config
from cppf_tpu_torch.data import native
from cppf_tpu_torch.data.png import write_png
from cppf_tpu_torch.data.shapenet import FLIP2NOCS
from cppf_tpu_torch.data.synthetic import mesh_bounds, observation_pose, random_primitive
from cppf_tpu_torch.device import resolve_device
from cppf_tpu_torch.eval.nocs_inference import REAL275_INTRINSICS, SYNSET_NAMES
from cppf_tpu_torch.scripts import fresh_out_dir
from cppf_tpu_torch.utils.prof import sync

WIDTH, HEIGHT = 640, 480
POSE_DEGS = (5, 10, 15)
POSE_CMS = (5, 10, 15)


def _render(mesh, v_cam_nocs):
    """Depth [H, W] of a mesh posed in the driver's camera frame: the
    rasterizer looks down -z with +y up, so the y-mirrored scene at -z."""
    K = REAL275_INTRINSICS
    return native.rasterize_depth(v_cam_nocs * np.float32([1, -1, -1]), mesh.faces, K[0, 0],
                                  K[1, 1], K[0, 2], K[1, 2], WIDTH, HEIGHT)


def _unit_mesh(cat, rng):
    """A random primitive of ``cat`` scaled to a unit diagonal, and its bounds."""
    mesh = random_primitive(cat, rng)
    lo, hi = mesh_bounds(mesh)
    mesh = mesh._replace(vertices=mesh.vertices / float(np.linalg.norm(hi - lo)))
    return (mesh, *mesh_bounds(mesh))


def make_frames(out_root: str, category: str, n_frames: int, seed: int = 0,
                instances: int = 1, clutter: int = 0):
    """NOCS-format frames (depth PNG + detection pkl) of posed primitives.

    ``category`` may be a comma-separated list: each frame then holds
    ``instances`` posed instances of each category, z-buffer composited,
    each with its visibility mask.  ``clutter`` adds that many distractors a
    frame, which occlude but stand in neither the detections nor the GT.
    A frame where no instance keeps 300 pixels is not written.  Returns
    (seg_dir, nocs_dir)."""
    rng = np.random.default_rng(seed)
    cats = category.split(",")
    ranges = {c: load_config(c).scale_range for c in cats}
    seg_dir = os.path.join(out_root, "seg")
    nocs_dir = os.path.join(out_root, "nocs")
    os.makedirs(seg_dir, exist_ok=True)

    for f_idx in range(n_frames):
        depths, gts, inst_cls = [], [], []
        n_inst = len(cats) * instances
        for inst in range(n_inst):
            cat = cats[inst % len(cats)]
            inst_cls.append(SYNSET_NAMES.index(cat))
            mesh, lo, hi = _unit_mesh(cat, rng)
            # GT pose of the trained canonical frame (flip2nocs'd), seen from
            # the training elevation band
            R, T = observation_pose(rng, is_nocs=True)
            if n_inst > 1:
                # spread the instances so that each stays visible
                T[0] += 0.55 * (inst - (n_inst - 1) / 2)
                T[2] += 0.25 * inst
            scale = float(rng.uniform(*ranges[cat]))
            v_canon = (mesh.vertices - (lo + hi) / 2) * scale @ FLIP2NOCS.T
            depths.append(_render(mesh, v_canon @ R.T + T))
            bound = (hi - lo).copy()
            bound[[0, 2]] = bound[[2, 0]]
            gts.append((R, T, bound * scale))

        for _ in range(clutter):
            cat = cats[int(rng.integers(len(cats)))]
            mesh, lo, hi = _unit_mesh(cat, rng)
            Rc, Tc = observation_pose(rng, is_nocs=True)
            Tc[0] += rng.uniform(-0.5, 0.5)
            Tc[2] += rng.uniform(0.0, 0.3)
            scale = float(rng.uniform(*ranges[cat]))
            depths.append(_render(mesh, (mesh.vertices - (lo + hi) / 2) * scale @ FLIP2NOCS.T
                                  @ Rc.T + Tc))

        # z-buffer composite; the masks index the instances, which come first
        stack_inf = np.where(np.stack(depths) > 0, np.stack(depths), np.inf)
        nearest = np.argmin(stack_inf, axis=0)
        any_hit = np.isfinite(stack_inf.min(axis=0))
        composite = np.where(any_hit, stack_inf.min(axis=0), 0.0)

        masks, bboxes, keep = [], [], []
        for inst in range(n_inst):
            mask = any_hit & (nearest == inst)
            if mask.sum() < 300:
                continue
            rows, cols = np.where(mask)
            masks.append(mask)
            bboxes.append([rows.min(), cols.min(), rows.max(), cols.max()])
            keep.append(inst)
        if not keep:
            continue

        frame_dir = os.path.join(nocs_dir, "real", "scene_1")
        os.makedirs(frame_dir, exist_ok=True)
        write_png(os.path.join(frame_dir, f"{f_idx:04d}_depth.png"),
                  (composite * 1000).astype(np.uint16))
        write_png(os.path.join(frame_dir, f"{f_idx:04d}_color.png"),
                  np.zeros((HEIGHT, WIDTH, 3), np.uint8))

        # NOCS GT conventions: RT holds R·|s|, gt_scales the unit scale
        gt_RTs, gt_scales = [], []
        for inst in keep:
            R, T, abs_scale = gts[inst]
            s_norm = np.linalg.norm(abs_scale)
            gt_RT = np.eye(4, dtype=np.float32)
            gt_RT[:3, :3] = R * s_norm
            gt_RT[:3, 3] = T
            gt_RTs.append(gt_RT)
            gt_scales.append(abs_scale / s_norm)
        n = len(keep)
        cls_ids = np.asarray([inst_cls[i] for i in keep], np.int32)
        result = {
            "image_path": f"data/real/scene_1/{f_idx:04d}",
            "pred_bboxes": np.asarray(bboxes, np.int32),
            "pred_masks": np.stack(masks, -1),
            "pred_class_ids": cls_ids,
            "pred_scores": np.ones(n, np.float32),
            "gt_class_ids": cls_ids,
            "gt_RTs": np.stack(gt_RTs),
            "gt_scales": np.asarray(gt_scales, np.float32),
            "gt_handle_visibility": np.ones(n, np.int32),
        }
        with open(os.path.join(seg_dir, f"results_real_scene1_{f_idx:04d}.pkl"), "wb") as f:
            pickle.dump(result, f)
    return seg_dir, nocs_dir


def ap_table(iou_aps, pose_aps, cats) -> dict:
    """{category: {"iou_25", "iou_50", "<deg>deg_<cm>cm"}} in percent."""
    table = {}
    for cat in cats:
        cls = SYNSET_NAMES.index(cat)
        row = {"iou_25": float(iou_aps[cls, 25]) * 100, "iou_50": float(iou_aps[cls, 50]) * 100}
        for i, deg in enumerate(POSE_DEGS):
            for j, cm in enumerate(POSE_CMS):
                row[f"{deg}deg_{cm}cm"] = float(pose_aps[cls, i, j]) * 100
        table[cat] = row
    return table


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt_path", default="checkpoints")
    ap.add_argument("--category", default="bowl")
    ap.add_argument("--n_frames", type=int, default=20)
    ap.add_argument("--out_dir", default=None,
                    help="an empty or new directory (default: a new one under TMPDIR)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--instances", type=int, default=1,
                    help="instances per frame (>1 exercises the batched driver)")
    ap.add_argument("--clutter", type=int, default=0,
                    help="distractor objects per frame (occlude; absent from GT/detections)")
    ap.add_argument("--time_serial", action="store_true",
                    help="also time the reference-style serial driver and report speedup")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; never falls back to the CPU)")
    return ap


def main(argv=None):
    """Renders, runs the driver and the eval; prints the summary and one
    JSON line.  Returns that line's dict, with the eval's arrays under
    ``"eval"``."""
    from cppf_tpu_torch.eval import nocs_eval, nocs_inference

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    args.out_dir = fresh_out_dir(args.out_dir, "synth_bench_")
    print(f"working directory: {args.out_dir}")
    seg_dir, nocs_dir = make_frames(args.out_dir, args.category, args.n_frames, args.seed,
                                    instances=args.instances, clutter=args.clutter)
    pred_dir = os.path.join(args.out_dir, "pred")
    common = ["--seg_dir", seg_dir, "--nocs_dir", nocs_dir, "--ckpt_path", args.ckpt_path,
              "--seed", str(args.seed), "--device", str(device)]
    t_serial = None
    if args.time_serial:
        # one frame of each driver first, so that the timed runs are warm
        warm = ["--max_frames", "1", "--out_dir", os.path.join(args.out_dir, "warm")]
        nocs_inference.main(common + warm + ["--serial"])
        nocs_inference.main(common + warm)
        sync(device)
        t0 = time.perf_counter()
        nocs_inference.main(common + ["--out_dir", pred_dir + "_serial", "--serial"])
        sync(device)
        t_serial = time.perf_counter() - t0
    sync(device)
    t0 = time.perf_counter()
    frames = nocs_inference.main(common + ["--out_dir", pred_dir])
    sync(device)
    t_batch = time.perf_counter() - t0
    if args.time_serial:
        print(f"\nserial driver:  {t_serial:.2f}s  ({args.n_frames / t_serial:.2f} frames/s)")
        print(f"batched driver: {t_batch:.2f}s  ({args.n_frames / t_batch:.2f} frames/s)")
        print(f"speedup: {t_serial / t_batch:.2f}x  ({args.instances} instances/frame)")
    result = nocs_eval.main(["--pred_dir", pred_dir, "--subsample", "1"])
    iou_aps, pose_aps = result[:2]
    cats = args.category.split(",")
    print("\n=== synthetic benchmark summary ===")
    print(f"categories: {args.category}  frames: {args.n_frames}  "
          f"instances/frame: {args.instances}")
    for cat in cats:
        cls = SYNSET_NAMES.index(cat)
        print(f"[{cat}] 3D IoU@25: {iou_aps[cls, 25] * 100:.1f}   "
              f"IoU@50: {iou_aps[cls, 50] * 100:.1f}")
        for i, deg in enumerate(POSE_DEGS):
            for j, cm in enumerate(POSE_CMS):
                print(f"[{cat}] pose AP {deg}deg {cm}cm: {pose_aps[cls, i, j] * 100:.1f}")
    pose_s = [sum(c.seconds for c in chunks) for chunks in frames]
    summary = {
        "categories": cats, "frames": len(frames), "instances": sum(
            c.instances for chunks in frames for c in chunks),
        "aps": ap_table(iou_aps, pose_aps, cats), "device": str(device),
        # the driver's whole run (runners and weights loaded, PNGs read)
        # over its frames, and the median of a frame's pose calls alone
        "s_per_frame": t_batch / max(len(frames), 1),
        "pose_s_per_frame": float(np.median(pose_s)) if pose_s else None,
    }
    if t_serial is not None:
        summary["serial_s_per_frame"] = t_serial / max(len(frames), 1)
    print(json.dumps(summary))
    return dict(summary, eval=result)


if __name__ == "__main__":
    main()
