"""SUN RGB-D scan-level inference driver (counterpart of
cppf_tpu/eval/sunrgbd_inference.py).

Per category, in ``TYPE2CLASS`` order: each val scan's dumped cloud is
turned into the gravity-aligned working frame (``EX_MAT @ rot``), each GT
segment of the category is posed by :meth:`CategoryRunner.estimate` (the
scale without the NOCS factor 2, the up axis under the gravity prior
``--up_prior_deg``), and the poses go to ``results_<type>.pkl`` as flat rows
[class_id, score, s(3), R(9), T(3)] a scan, which
``cppf_tpu_torch.eval.sunrgbd_eval`` scores.

The random draws follow the JAX driver's key schedule: one key from
``--seed``, split once for every posed instance across scans and
categories, so with the same ``--seed`` the port meets the draws the JAX
driver met.

Usage:
    python -m cppf_tpu_torch.eval.sunrgbd_inference --sunrgbd_dir ... \\
        --sunrgbd_extra_dir ... --out_dir ... --ckpt_path checkpoints [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import pickle
import time
from typing import NamedTuple

import numpy as np

from cppf_tpu_torch.core import threefry
from cppf_tpu_torch.device import resolve_device
from cppf_tpu_torch.eval.nocs_inference import CategoryRunner
from cppf_tpu_torch.utils import prof

TYPE2CLASS = {
    "bed": 0, "table": 1, "sofa": 2, "chair": 3, "toilet": 4,
    "desk": 5, "dresser": 6, "night_stand": 7, "bookshelf": 8, "bathtub": 9,
}
EX_MAT = np.array([[1, 0, 0], [0, 0, 1], [0, 1, 0]], dtype=np.float64)
SPLIT = "val"
SCAN_DIR = "sunrgbd_pc_bbox_votes_50k_v1_val"
META_PATH = "SUNRGBDtoolbox/Metadata/SUNRGBDMeta.mat"
# segments under MIN_POINTS are skipped, those above MAX_POINTS cut to their
# first MAX_POINTS (reference sunrgbd/inference.py)
MIN_POINTS = 200
MAX_POINTS = 40000

log = logging.getLogger("cppf_tpu_torch.sunrgbd")


def decode_sunrgbd_depth(depth: np.ndarray) -> np.ndarray:
    """The 16-bit bit-rotation decode of a SUN RGB-D depth PNG, capped at
    8 m (reference sunrgbd/inference.py:106-107)."""
    d = (depth >> 3) | (depth << 13)
    d = d.copy()
    d[d > 8000] = 8000
    return d


def load_meta(sunrgbd_dir: str):
    """The scans' metadata records (``SUNRGBDMeta.mat``), indexed by scan
    number - 1."""
    import scipy.io as sio

    return sio.loadmat(os.path.join(sunrgbd_dir, META_PATH))["SUNRGBDMeta"][0]


def scan_names(extra_dir: str, class_id: int, max_scans: int = 0) -> list:
    with open(os.path.join(extra_dir, "scan_names_list", f"{class_id}_{SPLIT}.txt")) as f:
        names = [s.strip() for s in f]
    return names[:max_scans] if max_scans else names


def read_scan(extra_dir: str, scan_name: str):
    """(bboxes [n, 8], segments [n] index arrays, points [N, 3] float64 in
    the working frame ``EX_MAT @ rot @ pc``) of a dumped scan."""
    base = os.path.join(extra_dir, SCAN_DIR, scan_name)
    rot = np.load(base + "_rot.npy")
    bboxes = np.load(base + "_bbox.npy")
    with open(base + "_segments.pkl", "rb") as f:
        segments = pickle.load(f)
    points3d = (EX_MAT @ rot @ np.load(base + "_pc.npz")["pc"][:, :3].T).T
    return bboxes, segments, points3d


def scan_instances(points3d: np.ndarray, bboxes, segments, class_id: int) -> list:
    """[(bbox index, cloud [M, 3] float32)] of a scan's instances of
    ``class_id``: segments under ``MIN_POINTS`` points left out, those above
    ``MAX_POINTS`` cut to their first ``MAX_POINTS``."""
    out = []
    for i, bbox in enumerate(bboxes):
        if int(bbox[7]) != class_id:
            continue
        pc = points3d[segments[i]]
        if pc.shape[0] < MIN_POINTS:
            continue
        out.append((i, pc[:MAX_POINTS].astype(np.float32)))
    return out


class Instance(NamedTuple):
    """One posed instance; seconds include the copy of its pose to the host."""
    category: str
    scan: str
    index: int
    points: int
    seconds: float


def pose_instances(runner: CategoryRunner, items, rng, class_id: int):
    """Rows [class_id, 1.0, s(3), R(9), T(3)] of ``items``
    (:func:`scan_instances`), one key split off ``rng`` an instance.
    Returns (rows, the next rng, [(bbox index, points, seconds)]).  The
    span ``scan`` is the request: each instance's ``draws`` and ``pose``
    nest under it."""
    rows, timing = [], []
    with prof.span("scan", instances=len(items)):
        for i, pc in items:
            rng, r_inst = threefry.split(rng)
            t0 = time.perf_counter()
            out, _ = runner.estimate(pc, draws=runner.draws(r_inst))
            prof.host_sync(out.T.device, n=3)  # the copies below
            scale, R, T = (out.scale.cpu().numpy(), out.R.cpu().numpy(), out.T.cpu().numpy())
            timing.append((i, len(pc), time.perf_counter() - t0))
            rows.append([class_id, 1.0, *scale, *R.reshape(-1), *T])
    return rows, rng, timing


def load_runner(typename: str, args):
    """The category's runner with the driver's settings (scale without the
    NOCS factor 2, the gravity prior), or None when it has no weights under
    ``args.ckpt_path``."""
    try:
        runner = CategoryRunner(typename, device=args.device, num_rots=args.num_rots,
                                angle_prec=args.angle_prec,
                                adaptive_voting=args.adaptive_voting,
                                ckpt_path=args.ckpt_path)
    except FileNotFoundError as e:
        log.warning("skipping %s: %s", typename, e)
        return None
    runner.pcfg = dataclasses.replace(runner.pcfg, scale_multiplier=1.0,
                                      up_prior_deg=args.up_prior_deg)
    return runner


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="SUN RGB-D inference: val scans' GT segments → result pkls. A category "
        "runs with <ckpt_path>/<cat> as the NOCS driver's runner reads it and is skipped "
        "without weights.")
    ap.add_argument("--sunrgbd_dir", default="data/OFFICIAL_SUNRGBD")
    ap.add_argument("--sunrgbd_extra_dir", default="data/sunrgbd_extra")
    ap.add_argument("--out_dir", default="data/sunrgbd_prediction")
    ap.add_argument("--ckpt_path", default="checkpoints")
    ap.add_argument("--angle_prec", type=float, default=1.5)
    ap.add_argument("--num_rots", type=int, default=72)
    ap.add_argument("--adaptive_voting", action="store_true")
    ap.add_argument("--up_prior_deg", type=float, default=30.0,
                    help="gravity prior on the up axis, degrees from the working frame's +y "
                    "(0 turns it off)")
    ap.add_argument("--categories", nargs="*", default=None)
    ap.add_argument("--max_scans", type=int, default=0, help="0 = all")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; never falls back to the CPU)")
    return ap


def main(argv=None):
    """Runs the driver; returns the posed instances, in order."""
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    meta_data = load_meta(args.sunrgbd_dir)
    rng = threefry.key(args.seed)
    posed = []
    for typename in args.categories or list(TYPE2CLASS):
        class_id = TYPE2CLASS[typename]
        runner = load_runner(typename, args)
        if runner is None:
            continue
        poses_pred = {}
        for scan_name in scan_names(args.sunrgbd_extra_dir, class_id, args.max_scans):
            if not 0 < int(scan_name) <= len(meta_data):
                raise IndexError(f"scan {scan_name} has no record in {META_PATH}")
            bboxes, segments, points3d = read_scan(args.sunrgbd_extra_dir, scan_name)
            items = scan_instances(points3d, bboxes, segments, class_id)
            poses_pred[scan_name], rng, timing = pose_instances(runner, items, rng, class_id)
            posed += [Instance(typename, scan_name, *t) for t in timing]
            log.info("%s %s: %d poses", typename, scan_name, len(poses_pred[scan_name]))
        with open(os.path.join(args.out_dir, f"results_{typename}.pkl"), "wb") as f:
            pickle.dump(poses_pred, f)
    return posed


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, force=True)
    main()
