"""Training data of the laptop lid/base segmenter (counterpart of
cppf_tpu/data/laptop_aux.py).

RGB crops [224, 224, 3] in [0, 1] with labels lid 1, base 0 and -100 for
pixels to ignore.  Two sources, drawn from one ``numpy.random.default_rng``
in the order the JAX dataset draws, so a seed gives JAX's samples:

- the reference's Blender renders, when ``data_root`` holds them
  (``<root>/<class>/<mesh>/N.png``, ``N_depth0001.exr``, ``N.tr.npy``,
  ``N.rot.npy``): the labels come from two RANSAC planes, whose uniforms
  are JAX's draws from ``PRNGKey(rng.integers(1 << 30))``, remade by
  ``core/threefry.py``;
- otherwise a synthetic two-plate laptop through the native rasteriser,
  its labels from per-part depth renders.

``cv2.resize`` has its copy in ``data/resize.py``, ``cv2.imread`` its
counterpart in ``data/png.py`` and the EXR reader is ``data/exr.py``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np
import torch

from cppf_tpu_torch.config import REPO_ROOT
from cppf_tpu_torch.core import threefry
from cppf_tpu_torch.core.geometry import rotx, roty
from cppf_tpu_torch.data import native
from cppf_tpu_torch.data.exr import read_exr
from cppf_tpu_torch.data.png import read_png
from cppf_tpu_torch.data.resize import resize_linear, resize_nearest
from cppf_tpu_torch.data.synthetic import Mesh
from cppf_tpu_torch.ops.ransac import segment_plane

BLENDER_INTRINSICS = np.array([[591.0125, 0, 322.525], [0, 590.16775, 244.11084], [0, 0, 1]])
CROP = 224
IGNORE = -100
PLANE_ITERS = 100
BLENDER_PAD = 65536  # the JAX dataset's fixed RANSAC row count


def make_laptop_mesh(open_angle_deg: float, width=0.3, depth=0.22,
                     thickness=0.008) -> Tuple[Mesh, np.ndarray]:
    """Base plate on y≈0 and a lid plate hinged at its back edge, opened
    by ``open_angle_deg``.  Returns (mesh, per-face labels 0 base, 1 lid)."""
    signs = (-1, 1)
    v = np.array([[sx * width / 2, sy * thickness / 2, sz * depth / 2]
                  for sx in signs for sy in signs for sz in signs], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                  [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    # the lid turns up about x around the hinge at z = -depth/2
    hinge = np.float32([0, 0, -depth / 2])
    R = rotx(np.deg2rad(180.0 - open_angle_deg))[:3, :3].astype(np.float32)
    lid = (v - hinge) @ R.T + hinge
    labels = np.repeat(np.int32([0, 1]), len(f))
    return Mesh(np.concatenate([v, lid]), np.concatenate([f, f + len(v)])), labels


def _plane_uniforms(rng: np.random.Generator) -> torch.Tensor:
    """The [100, 3] uniforms that JAX's jitted ``segment_plane`` draws from
    ``PRNGKey(int(rng.integers(1 << 30)))``."""
    key = threefry.key(int(rng.integers(1 << 30)))
    return threefry.draw_many([("uniform", key, (PLANE_ITERS, 3))], "cpu")[0]


def _bbox(mask: np.ndarray):
    rows, cols = np.where(mask)
    return rows, cols, np.array([[rows.min(), rows.max()], [cols.min(), cols.max()]])


def _augment(crop: np.ndarray, fg: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """The reference's brightness augmentation of the foreground."""
    crop[fg] *= 1 + 0.4 * rng.random(3) - 0.2
    crop[fg] += 0.05 * rng.random(fg.sum())[:, None] - 0.025
    return np.clip(crop, 0, 1).astype(np.float32)


@dataclass
class LaptopAuxDataset:
    """Yields (rgb [224, 224, 3] float32, labels [224, 224] int64)."""

    data_root: str = "./data/laptop"
    seed: int = 0
    epoch_len: int = 200

    # Blender camera model (reference utils/dataset.py:272-275)
    camera_lens: float = 29.55062484741211
    camera_sensor_width: float = 32.0
    resolution_x: int = 640
    resolution_y: int = 480

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        self.model_names = []
        if os.path.isdir(self.data_root):
            bl_path = os.path.join(REPO_ROOT, "data", "laptop_nonreal.txt")
            blacklist = set()
            if os.path.exists(bl_path):
                with open(bl_path) as f:
                    blacklist = set(f.read().splitlines())
            for cls in sorted(os.listdir(self.data_root)):
                cls_dir = os.path.join(self.data_root, cls)
                if os.path.isdir(cls_dir):
                    self.model_names += [f"{cls}/{m}" for m in sorted(os.listdir(cls_dir))
                                         if f"{cls}/{m}" not in blacklist]
        self.use_blender = bool(self.model_names)

    def __len__(self):
        return self.epoch_len

    def __iter__(self) -> Iterator:
        for _ in range(self.epoch_len):
            yield self.sample()

    def sample(self):
        """One sample; a draw that the source rejects is drawn again."""
        while True:
            out = self._blender_sample() if self.use_blender else self._synthetic_sample()
            if out is not None:
                return out

    def _blender_sample(self):
        """A Blender render (reference utils/dataset.py:319-392), or None
        where the JAX dataset draws again."""
        from scipy.spatial.transform import Rotation

        rng = self.rng
        name = self.model_names[int(rng.integers(len(self.model_names)))]
        base = os.path.join(self.data_root, name, str(int(rng.integers(1, 21))))
        if not (os.path.exists(base + ".png") and os.path.exists(base + "_depth0001.exr")):
            return None
        tr, rot = np.load(base + ".tr.npy"), np.load(base + ".rot.npy")
        beta = Rotation.from_matrix(rot).as_euler("yxy", degrees=True)
        if beta[1] > 60 or np.abs(tr[2]) < 0.8:
            return None

        rgb = read_png(base + ".png")
        if rgb.dtype != np.uint8:
            raise ValueError(f"{base}.png: 8-bit colour expected, not {rgb.dtype}")
        rgb = np.repeat(rgb[..., None], 3, -1) if rgb.ndim == 2 else rgb[..., :3].copy()
        depth = read_exr(base + "_depth0001.exr")["R"].astype(np.float32)
        depth[depth > 100] = 0
        rgb[depth == 0] = 255
        mask = depth > 0
        if mask.sum() < 100:
            return None
        pc = self._backproject_blender(depth, mask)
        pc[:, 0] = -pc[:, 0]
        pc[:, 2] = -pc[:, 2]
        pc = (pc + tr) @ rot  # rot.T applied to the rows

        rows, cols, bbox = _bbox(mask)
        crop = resize_linear(rgb[bbox[0, 0]:bbox[0, 1] + 1, bbox[1, 0]:bbox[1, 1] + 1],
                             (CROP, CROP)).astype(np.float32) / 255.0

        # two-stage RANSAC split (reference utils/dataset.py:371-388)
        take = min(len(pc), BLENDER_PAD)
        pts = torch.zeros(BLENDER_PAD, 3)
        pts[:take] = torch.from_numpy(pc[:take].astype(np.float32))
        valid = torch.arange(BLENDER_PAD) < take
        plane1, in1 = segment_plane(_plane_uniforms(rng), pts, 0.01, valid)
        if int(in1.sum()) > take - 3:
            return None
        plane2, in2 = segment_plane(_plane_uniforms(rng), pts, 0.01, valid & ~in1)
        base_m, screen_m = in1[:take].numpy(), in2[:take].numpy()
        if abs(float(plane1[1])) < abs(float(plane2[1])):
            base_m, screen_m = screen_m, base_m

        label = np.full((CROP, CROP), IGNORE, np.int64)
        idx = resized_idxs(rows, cols, bbox)[:take]
        label[idx[base_m][:, 0], idx[base_m][:, 1]] = 0
        label[idx[screen_m][:, 0], idx[screen_m][:, 1]] = 1
        return _augment(crop, np.any(np.abs(crop - 1.0) > 1e-3, -1), rng), label

    def _backproject_blender(self, depth, mask):
        """Blender thin-lens unprojection (reference utils/dataset.py:280-317)."""
        sensor_h = self.resolution_y / self.resolution_x * self.camera_sensor_width
        u, v = np.meshgrid(np.arange(self.resolution_x), np.arange(self.resolution_y))
        u, v = u[mask], v[mask]
        x = (0.5 - u / self.resolution_x) * self.camera_sensor_width / self.camera_lens
        y = (0.5 - v / self.resolution_y) * sensor_h / self.camera_lens
        norm = np.sqrt(x**2 + y**2 + 1.0)
        uu = (0.5 - x * self.camera_lens / self.camera_sensor_width) * self.resolution_x
        vv = (0.5 - y * self.camera_lens / sensor_h) * self.resolution_y
        xyz = (np.linalg.inv(BLENDER_INTRINSICS) @ np.stack([uu, vv, np.ones_like(uu)], 0)).T
        z = depth[mask] / norm
        pts = xyz * (z[:, None] / xyz[:, 2:3])
        pts[:, 0] = -pts[:, 0]
        pts[:, 1] = -pts[:, 1]
        return pts

    def _synthetic_sample(self):
        """A rendered two-plate laptop, or None where the JAX dataset draws
        again (under 100 pixels in view)."""
        rng = self.rng
        mesh, face_labels = make_laptop_mesh(
            open_angle_deg=float(rng.uniform(70, 135)),
            width=float(rng.uniform(0.25, 0.35)),
            depth=float(rng.uniform(0.18, 0.26)),
        )
        y_angle = rng.uniform(0, 2 * np.pi)
        x_angle = rng.uniform(np.deg2rad(15), np.deg2rad(60))
        R = rotx(x_angle)[:3, :3] @ roty(y_angle)[:3, :3]
        tr = np.array([rng.uniform(-0.15, 0.15), rng.uniform(-0.15, 0.15),
                       -rng.uniform(0.8, 1.6)])
        v_cam = mesh.vertices @ R.T + tr

        K = BLENDER_INTRINSICS

        def render(faces):
            return native.rasterize_depth(v_cam, faces, K[0, 0], K[1, 1], K[0, 2], K[1, 2],
                                          640, 480)

        # per-part renders give exact pixel labels
        depth, base_depth, lid_depth = (render(mesh.faces), render(mesh.faces[face_labels == 0]),
                                        render(mesh.faces[face_labels == 1]))
        mask = depth > 0
        if mask.sum() < 100:
            return None
        _, _, bbox = _bbox(mask)
        box = (slice(bbox[0, 0], bbox[0, 1] + 1), slice(bbox[1, 0], bbox[1, 1] + 1))

        # inverse depth times a tint stands in for Blender's shading
        shade = np.zeros((480, 640, 3), np.float32)
        d = np.where(mask, depth, np.nan)
        dn = (np.nanmax(d) - d) / max(np.nanmax(d) - np.nanmin(d), 1e-6)
        tint = rng.uniform(0.3, 1.0, 3)
        shade[mask] = dn[mask, None] * tint
        bg = rng.uniform(0, 1, 3)
        shade[~mask] = bg
        crop = resize_linear(shade[box], (CROP, CROP))

        label_full = np.full((480, 640), IGNORE, np.int64)
        label_full[(base_depth > 0) & (np.abs(base_depth - depth) < 1e-4)] = 0
        label_full[(lid_depth > 0) & (np.abs(lid_depth - depth) < 1e-4)] = 1
        label = resize_nearest(label_full[box].astype(np.float32), (CROP, CROP)).astype(np.int64)
        return _augment(crop, np.any(np.abs(crop - bg) > 1e-3, -1), rng), label


def resized_idxs(rows: np.ndarray, cols: np.ndarray, bbox: np.ndarray) -> np.ndarray:
    """Each pixel's (row, col) in the 224² crop of ``bbox``.  The scale is
    224 / (max - min), not / (max - min + 1): the reference's, kept."""
    scale = CROP / (bbox[:, 1] - bbox[:, 0])
    xy = np.stack([rows, cols], -1)
    return np.clip(((xy - bbox[:, 0]) * scale).astype(np.int64), 0, CROP - 1)
