"""Rendered training data (counterpart of cppf_tpu/data/shapenet.py).

Per sample, on the host:

1. a mesh: a ShapeNet OBJ, or, without a ShapeNet root, a fresh primitive
   of the category's family (``data/synthetic.py``, ``compose.py``);
2. a random NOCS-style (or SUN-style) pose and a uniform scale;
3. a 640x480 depth map from the native rasterizer (``data/native.py``);
4. backprojected and taken back to the canonical (NOCS) frame, with the
   x/z swap of ``FLIP2NOCS`` for the NOCS categories.

Every draw comes from one ``np.random.default_rng(seed)`` in the JAX
dataset's order, so the two give the same samples for a seed.  Jitter,
voxels, normals, pairs and targets are made on the device by
``train/loop.py::build_batch``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, NamedTuple, Optional

import numpy as np

from cppf_tpu_torch.config import REPO_ROOT, Config
from cppf_tpu_torch.core.geometry import backproject, rotx, roty
from cppf_tpu_torch.data import native
from cppf_tpu_torch.data.mesh import load_obj
from cppf_tpu_torch.data.synthetic import Mesh, random_primitive

# training-render intrinsics (reference utils/dataset.py:96)
TRAIN_INTRINSICS = np.array([[591.0125, 0, 320], [0, 590.16775, 240], [0, 0, 1]])
FLIP2NOCS = np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], np.float64)

# reference shapenet class ids for the SUN RGB-D categories
# (reference utils/util.py:31-38)
TYPENAME2SHAPENETID = {
    "chair": "03001627",
    "bathtub": "02808440",
    "bookshelf": "02871439",
    "bed": "02818832",
    "sofa": "04256520",
    "table": "04379243",
}

NOCS_CATEGORIES = ("bottle", "bowl", "camera", "can", "laptop", "mug")


def apply_depth_noise(depth: np.ndarray, rng: np.random.Generator,
                      strength: float = 1.0) -> np.ndarray:
    """Structured-light-style depth corruption (Kinect/RealSense model):

    - axial noise with sigma growing quadratically with range
      (~1.5 mm at 1 m for ``strength=1``),
    - disparity quantisation (the sensor measures integer-ish disparity:
      quantisation step also grows with z^2),
    - pixel dropout at depth discontinuities (edge shadowing).

    Real NOCS/SUN RGB-D depth carries all three; clean z-buffer renders
    carry none, which lets long training runs overfit razor-sharp synthetic
    geometry (measured: zero-shot proposal contrast on the real demo frame
    degrades with training length on clean renders).
    """
    mask = depth > 0
    z = depth[mask]
    sigma = strength * (0.0012 + 0.0019 * (z - 0.4) ** 2)   # Nguyen et al. axial model
    z = z + rng.normal(0.0, 1.0, z.shape) * sigma
    # disparity quantisation: d = f*b/z with f*b ≈ 0.075*580 m·px; the
    # sensor resolves 1/8-px disparity steps (≈2.9 mm at 1 m)
    fb = 0.075 * 580.0
    step = strength * 0.125
    if step > 0:
        z = fb / (np.round(fb / z / step) * step + 1e-9)
    out = np.zeros_like(depth)
    out[mask] = z.astype(depth.dtype)
    # edge shadowing: drop pixels whose neighbourhood spans a depth jump
    gy, gx = np.gradient(out)
    jump = (np.abs(gy) + np.abs(gx)) > 0.03
    drop = jump & (rng.random(out.shape) < 0.5 * strength)
    out[drop] = 0.0
    return out


class RenderedSample(NamedTuple):
    pc: np.ndarray          # [M, 3] canonical-frame cloud (float32)
    bound: np.ndarray       # [3] NOCS-frame mesh extent (x/z swapped)
    scale: float            # sampled uniform scale


@dataclass
class ShapeNetRenderDataset:
    """Iterable over rendered canonical clouds for one category."""

    cfg: Config
    model_names: Optional[List[str]] = None
    seed: int = 0
    epoch_len: int = 200     # reference caps the epoch at 200 samples
    min_points: int = 100

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        self.is_nocs = self.cfg.category in NOCS_CATEGORIES
        if self.model_names is None:
            self.model_names = self.discover_models()

    def discover_models(self) -> List[str]:
        names_file = os.path.join(REPO_ROOT, "data", "shapenet_names",
                                  f"{self.cfg.category}.txt")
        root = self.cfg.shapenet_root
        if os.path.exists(names_file) and os.path.isdir(root):
            return open(names_file).read().splitlines()
        if os.path.isdir(root) and self.cfg.category in TYPENAME2SHAPENETID:
            sid = TYPENAME2SHAPENETID[self.cfg.category]
            cat_dir = os.path.join(root, sid)
            if os.path.isdir(cat_dir):
                return [f"{sid}/{m}" for m in sorted(os.listdir(cat_dir))]
        return []  # primitive fallback

    def __len__(self) -> int:
        return min(len(self.model_names), self.epoch_len) if self.model_names else self.epoch_len

    def _load_mesh(self, name: Optional[str]) -> Mesh:
        if name is None:
            # parameter-randomised primitive family: a fresh shape per sample
            # stands in for ShapeNet's category-level variation
            # (reference utils/dataset.py:84-257)
            prim = random_primitive(self.cfg.category, self.rng)
            # primitives are metric; normalise to unit-diagonal like ShapeNet
            v = prim.vertices
            diag = np.linalg.norm(v.max(0) - v.min(0))
            return Mesh((v / diag).astype(np.float32), prim.faces)
        cls_id, mesh_name = name.split("/")
        path = os.path.join(self.cfg.shapenet_root, cls_id, mesh_name, "models", "model_normalized.obj")
        return load_obj(path)

    def sample(self) -> RenderedSample:
        name = None
        if self.model_names:
            name = self.model_names[int(self.rng.integers(len(self.model_names)))]
        for _ in range(20):  # resample on bad renders (reference :221-222)
            out = self._render_once(name)
            if out is not None:
                return out
            if self.model_names:
                name = self.model_names[int(self.rng.integers(len(self.model_names)))]
        raise RuntimeError("could not render a valid sample in 20 tries")

    def _render_once(self, name: Optional[str]) -> Optional[RenderedSample]:
        rng = self.rng
        mesh = self._load_mesh(name)

        # pose (reference utils/dataset.py:152-171)
        pose = np.eye(4)
        if self.is_nocs:
            y_angle = rng.uniform(0, 2 * np.pi)
            x_angle = rng.uniform(np.deg2rad(25), np.deg2rad(65))
            yy_angle = rng.uniform(np.deg2rad(-15), np.deg2rad(15))
            pose[:3, :3] = roty(yy_angle)[:3, :3] @ rotx(x_angle)[:3, :3] @ roty(y_angle)[:3, :3]
            tr = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3), -rng.uniform(0.6, 2.0)])
        else:
            y_angle = rng.uniform(0, 2 * np.pi)
            x_angle = np.clip(rng.normal(40, 10), 10, 70) / 180 * np.pi
            pose[:3, :3] = rotx(x_angle)[:3, :3] @ roty(y_angle)[:3, :3]
            tr = np.array([rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2), -rng.uniform(1.0, 5.0)])
        pose[:3, 3] = tr

        # center + scale (reference :174-181)
        lo, hi = mesh.vertices.min(0), mesh.vertices.max(0)
        center = (lo + hi) / 2
        scale = float(rng.uniform(self.cfg.scale_range[0], self.cfg.scale_range[1]))
        v_cam = (mesh.vertices - center) * scale @ pose[:3, :3].T + tr

        K = TRAIN_INTRINSICS
        depth = native.rasterize_depth(
            v_cam, mesh.faces, K[0, 0], K[1, 1], K[0, 2], K[1, 2], 640, 480
        )
        if self.cfg.depth_noise > 0:
            depth = apply_depth_noise(depth, rng, self.cfg.depth_noise)
        mask = depth > 0
        if mask.sum() < self.min_points:
            return None

        pc, _ = backproject(depth, K, mask)
        pc[:, 0] = -pc[:, 0]
        pc[:, 2] = -pc[:, 2]
        pc = pc - tr
        pc = pc @ np.linalg.inv(pose[:3, :3]).T
        if self.is_nocs:
            pc = pc @ FLIP2NOCS.T
        if pc.shape[0] > self.cfg.npoint_max:
            # keep the voxel budget bounded like the reference's rejection;
            # subsample instead of rejecting outright
            pick = rng.choice(pc.shape[0], self.cfg.npoint_max, replace=False)
            pc = pc[pick]

        bound = (hi - lo).astype(np.float32)
        bound[[0, 2]] = bound[[2, 0]]  # NOCS x/z swap (reference :246-247)
        return RenderedSample(pc.astype(np.float32), bound, scale)

    def __iter__(self) -> Iterator[RenderedSample]:
        for _ in range(len(self)):
            yield self.sample()
