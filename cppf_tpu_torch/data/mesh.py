"""Minimal OBJ mesh loading (counterpart of cppf_tpu/data/mesh.py).

Handles the subset ShapeNetCore ``model_normalized.obj`` files use: ``v``
vertex lines and ``f`` faces with any ``v/vt/vn`` index syntax (negative
indices count from the end), fan-triangulated; groups and materials are
ignored, since a depth render needs geometry only.
"""
from __future__ import annotations

import numpy as np

from cppf_tpu_torch.data.synthetic import Mesh


def load_obj(path: str) -> Mesh:
    verts = []
    faces = []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    if not verts or not faces:
        raise ValueError(f"empty or unsupported OBJ: {path}")
    return Mesh(np.asarray(verts, np.float32), np.asarray(faces, np.int32))


def transform_mesh(mesh: Mesh, matrix: np.ndarray) -> Mesh:
    """A homogeneous 4x4 applied to the vertices."""
    v = mesh.vertices @ matrix[:3, :3].T + matrix[:3, 3]
    return Mesh(v.astype(np.float32), mesh.faces)
