"""Oriented 3D bounding box (9-keypoint convention); the port's own copy of
cppf_tpu/eval/box3d.py.

Functional parity target: reference ``utils/box.py`` (itself derived from
Google's Objectron box utilities): a box is stored as 9 keypoints (center +
8 corners in (x,y,z)-sign order), with least-squares 9-DoF recovery.
"""
from __future__ import annotations

import numpy as np

# edge quadruples per axis (indices into the 9-keypoint layout, center = 0)
EDGES_X = [(1, 5), (2, 6), (3, 7), (4, 8)]
EDGES_Y = [(1, 3), (5, 7), (2, 4), (6, 8)]
EDGES_Z = [(1, 2), (3, 4), (5, 6), (7, 8)]
EDGES = EDGES_X + EDGES_Y + EDGES_Z

# quad faces, vertices ordered so face normals point inward
FACES = np.array(
    [
        [5, 6, 8, 7],  # +x
        [1, 3, 4, 2],  # -x
        [3, 7, 8, 4],  # +y (top)
        [1, 2, 6, 5],  # -y
        [2, 4, 8, 6],  # +z (front)
        [1, 5, 7, 3],  # -z
    ]
)

NUM_KEYPOINTS = 9


def unit_vertices(scale) -> np.ndarray:
    """Axis-aligned 9-keypoint layout for the given (3,) scale."""
    h = np.asarray(scale, dtype=np.float64) / 2.0
    signs = np.array(
        [
            [0, 0, 0],
            [-1, -1, -1], [-1, -1, 1], [-1, 1, -1], [-1, 1, 1],
            [1, -1, -1], [1, -1, 1], [1, 1, -1], [1, 1, 1],
        ],
        dtype=np.float64,
    )
    return signs * h


class Box3D:
    """9-keypoint oriented box with lazy 9-DoF decomposition."""

    def __init__(self, vertices: np.ndarray):
        self._vertices = np.asarray(vertices, dtype=np.float64)
        self._fit = None

    @classmethod
    def from_transformation(cls, rotation: np.ndarray, translation: np.ndarray, scale) -> "Box3D":
        if np.asarray(rotation).size != 9:
            raise ValueError("rotation must be a 3x3 matrix")
        verts = unit_vertices(scale) @ np.asarray(rotation).T + np.asarray(translation).reshape(3)
        return cls(verts)

    @property
    def vertices(self) -> np.ndarray:
        return self._vertices

    def fit(self):
        """Recover (rotation, translation, scale) by least squares on the
        9 keypoints: scale from edge lengths, then a linear solve."""
        if self._fit is None:
            v = self._vertices
            scale = np.zeros(3)
            for axis, edges in enumerate((EDGES_X, EDGES_Y, EDGES_Z)):
                scale[axis] = np.mean(
                    [np.linalg.norm(v[i] - v[j]) for i, j in edges]
                )
            x = unit_vertices(scale)
            system = np.concatenate([x, np.ones((NUM_KEYPOINTS, 1))], axis=1)
            sol, *_ = np.linalg.lstsq(system, v, rcond=None)
            rotation = sol[:3, :3].T
            translation = sol[3, :3]
            self._fit = (rotation, translation, scale)
        return self._fit

    @property
    def rotation(self):
        return self.fit()[0]

    @property
    def translation(self):
        return self.fit()[1]

    @property
    def scale(self):
        return self.fit()[2]

    @property
    def transformation(self) -> np.ndarray:
        rot, tr, _ = self.fit()
        m = np.eye(4)
        m[:3, :3] = rot
        m[:3, 3] = tr
        return m

    @property
    def volume(self) -> float:
        """|det| of the three edge vectors out of vertex 1 — exact for
        parallelepipeds."""
        v = self._vertices
        sys_ = np.stack([v[2] - v[1], v[3] - v[1], v[5] - v[1]])
        return float(abs(np.linalg.det(sys_)))

    def apply_transformation(self, transformation: np.ndarray) -> "Box3D":
        if transformation.shape != (4, 4):
            raise ValueError("need a 4x4 transform")
        rot, tr, scale = self.fit()
        new_rot = transformation[:3, :3] @ rot
        new_tr = transformation[:3, 3] + transformation[:3, :3] @ tr
        return Box3D.from_transformation(new_rot, new_tr, scale)

    def inside(self, point: np.ndarray) -> bool:
        inv = np.linalg.inv(self.transformation)
        local = inv[:3, :3] @ np.asarray(point) + inv[:3, 3]
        return bool(np.all(np.abs(local) <= self.scale / 2.0))

    def sample(self, rng: np.random.Generator | None = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        p = rng.uniform(-0.5, 0.5, 3) * self.scale
        return self.rotation @ p + self.translation
