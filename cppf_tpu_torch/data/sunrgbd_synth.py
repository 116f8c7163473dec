"""Synthetic scenes in the SUN RGB-D layout (counterpart of
cppf_tpu/data/sunrgbd_synth.py).

Writes the on-disk layout that the SUN RGB-D drivers read (reference
sunrgbd/inference.py:36-120 and eval.py:85-107): ``SUNRGBDMeta.mat`` with
each scan's ``Rtilt``, each scan's ``_pc.npz`` / ``_bbox.npy`` /
``_rot.npy`` / ``_segments.pkl`` and ``scan_names_list/<class>_val.txt``,
so that the whole scan → inference → NMS → mAP loop runs with no dataset.
The draws follow ``np.random.default_rng(seed)`` in the JAX package's
order, through the port's own renderer and primitives, so the files are
the JAX package's byte for byte.

Frames (taken from the driver's and the eval's arithmetic, so that a
perfect predictor scores a perfect AP): the eval conjugates GT and
predictions by ``inv(EX·rot·Rtilt·EX)``; with ``Rtilt = I`` the GT box in
the final frame is ``(rot_gt, t_gt, extents)`` and the stored cloud is
``pc = EX @ (rot_gt @ v_canonical + t_gt)``.  The per-scan augmentation
``rot`` cancels in the conjugation for any orthonormal value, so a random
yaw exercises that path.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from cppf_tpu_torch.config import load_config
from cppf_tpu_torch.core.geometry import backproject
from cppf_tpu_torch.data import native
from cppf_tpu_torch.data.synthetic import mesh_bounds, random_primitive, sample_surface

EX = np.array([[1, 0, 0], [0, 0, 1], [0, 1, 0]], dtype=np.float64)


def _roty(ry: float) -> np.ndarray:
    """The eval's gravity-axis rotation convention (sunrgbd/eval.py:90-92)."""
    c, s = np.cos(ry), np.sin(ry)
    return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])


def make_scans(sunrgbd_dir: str, extra_dir: str, category: str, class_id: int,
               n_scans: int, instances: int = 2, pts_per_obj: int = 6000,
               seed: int = 0, target_diag: float | None = None):
    """Write ``n_scans`` synthetic scans of ``instances`` posed instances of
    ``category`` (and floor clutter) in the SUN RGB-D val layout.

    Returns the scan names ("1".."n_scans").
    """
    import scipy.io as sio

    rng = np.random.default_rng(seed)
    root = os.path.join(extra_dir, "sunrgbd_pc_bbox_votes_50k_v1_val")
    names_dir = os.path.join(extra_dir, "scan_names_list")
    meta_dir = os.path.join(sunrgbd_dir, "SUNRGBDtoolbox", "Metadata")
    for d in (root, names_dir, meta_dir):
        os.makedirs(d, exist_ok=True)

    meta = np.zeros((1, n_scans), dtype=[("Rtilt", "O")])
    for i in range(n_scans):
        meta[0, i]["Rtilt"] = np.eye(3)
    sio.savemat(os.path.join(meta_dir, "SUNRGBDMeta.mat"), {"SUNRGBDMeta": meta})

    scan_names = [str(i + 1) for i in range(n_scans)]
    for scan in scan_names:
        yaw = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(yaw), np.sin(yaw)
        # an upright (z) rotation in the stored cloud's frame: the dumps'
        # random augmentation, which cancels in the eval's conjugation
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

        pcs, segments, bboxes = [], [], []
        offset = 0
        # every size first, so that placement respects the neighbours: the
        # diagonals come from the category's training scale range
        # (reference utils/dataset.py:180), clipped to a scene that holds
        # them; sizes outside it make the scale regression fall back to
        # the training mean
        if target_diag is not None:
            diags = [rng.uniform(0.8, 1.2) * target_diag for _ in range(instances)]
        else:
            lo_s, hi_s = load_config(category).scale_range
            lo_c, hi_c = max(lo_s, 1.0), min(hi_s, 4.5)
            if hi_c <= lo_c:  # the whole range outside [1, 4.5]: kept as it is
                lo_c, hi_c = lo_s, hi_s
            diags = [rng.uniform(lo_c, hi_c) for _ in range(instances)]
        # cumulative x, so that neighbours never overlap whatever their size
        gaps = [0.0]
        for i in range(1, instances):
            gaps.append(gaps[-1] + 0.62 * (diags[i - 1] + diags[i]) + 0.4)
        x_centers = np.array(gaps) - (gaps[-1] / 2 if instances > 1 else 0.0)
        insts = []
        for inst in range(instances):
            mesh = random_primitive(category, rng)
            lo, hi = mesh_bounds(mesh)
            diag = float(np.linalg.norm(hi - lo))
            k = diags[inst] / diag
            extents = (hi - lo) * k

            ry = rng.uniform(0, 2 * np.pi)
            R_gt = _roty(ry)
            t_gt = np.array([
                x_centers[inst] + rng.uniform(-0.2, 0.2),
                extents[1] / 2,
                2.0 + max(1.0, max(diags)) + 0.8 * inst + rng.uniform(-0.2, 0.2),
            ])
            v_world = ((mesh.vertices - (lo + hi) / 2) * k) @ R_gt.T + t_gt
            insts.append((mesh, k, lo, hi, v_world, R_gt, t_gt))
            # the bbox row as sunrgbd/eval.py:87-92 reads it: (tx, ty, tz) =
            # bbox[0, 2, 1], (sx, sy, sz) = bbox[3, 5, 4], ry = -bbox[6];
            # SUN RGB-D's coefficients are half extents, as the whole
            # reference chain reads them
            coeffs = extents / 2.0
            bboxes.append([t_gt[0], t_gt[2], t_gt[1],
                           coeffs[0], coeffs[2], coeffs[1],
                           -ry, class_id])

        # one depth view, as a real scan is one Kinect view: the raster
        # camera looks down -z, v_raster = p_world·[-1, 1, -1], whose
        # backprojection (K⁻¹ and the NOCS x/y negation) is p_world
        fx = fy = 570.0  # a Kinect-class focal length, SUN RGB-D kv1's
        cx, cy, W, H = 320.0, 240.0, 640, 480
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        flip = np.array([-1.0, 1.0, -1.0])
        dmaps = np.stack([
            native.rasterize_depth((v_world * flip).astype(np.float32),
                                   mesh.faces, fx, fy, cx, cy, W, H)
            for (mesh, _, _, _, v_world, _, _) in insts
        ])
        occ = np.where(dmaps > 0, dmaps, np.inf)
        winner = np.argmin(occ, axis=0)
        combined = np.min(occ, axis=0)
        for inst, (mesh, k, lo, hi, v_world, R_gt, t_gt) in enumerate(insts):
            m = (winner == inst) & np.isfinite(combined)
            if m.sum() >= 200:
                depth = np.where(m, combined, 0.0).astype(np.float32)
                p_world, _ = backproject(depth, K, m)
                if len(p_world) > pts_per_obj:
                    pick = rng.choice(len(p_world), pts_per_obj, replace=False)
                    p_world = p_world[pick]
            else:
                # out of the frustum or hidden: posed surface samples, so
                # that the scan stays well formed
                pts = (sample_surface(mesh, pts_per_obj, rng) - (lo + hi) / 2) * k
                p_world = pts @ R_gt.T + t_gt
            pcs.append((p_world @ EX.T).astype(np.float32))
            segments.append(np.arange(offset, offset + len(p_world)))
            offset += len(p_world)

        floor = np.stack([
            rng.uniform(-4, 4, 2000), rng.uniform(1, 6, 2000), np.zeros(2000),
        ], -1).astype(np.float32)  # stored frame: z up
        # the driver applies EX @ rot @ pc_stored and the eval conjugates by
        # inv(EX·rot·EX), so the stored cloud is the world cloud under EX
        pc_store = np.concatenate(pcs + [floor], 0)

        base = os.path.join(root, scan)
        np.savez(base + "_pc.npz", pc=pc_store)
        np.save(base + "_rot.npy", rot)
        np.save(base + "_bbox.npy", np.asarray(bboxes, np.float64))
        with open(base + "_segments.pkl", "wb") as f:
            pickle.dump(segments, f)

    with open(os.path.join(names_dir, f"{class_id}_val.txt"), "w") as f:
        f.write("\n".join(scan_names) + "\n")
    return scan_names
