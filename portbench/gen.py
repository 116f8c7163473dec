"""The benchmark's one traffic generator: partial-view crops of a
category's synthetic primitive, made on the host from a seed.

A category's mesh is a data file, ``meshes/<category>.json``: a list of
parts, each a shape of :data:`SHAPES` with its sizes and an offset
(``at``), found by the configuration's ``category``.  The shapes and the
area-weighted surface sampler are a frozen copy of the program's
``data/synthetic.py`` (``make_cylinder``, ``make_box``, ``make_bowl``,
``sample_surface``), and each mesh file a copy of its ``PRIMITIVES`` entry,
so that a later change there cannot move the traffic.  A crop stands in for a
masked depth crop: the mesh scaled to a diagonal in the category's
``scale_range``, turned by a rotation of the mix's view law
(:func:`view`), placed ``distance_m`` in front of a camera at the origin
looking along +z, and seen by a virtual depth camera: the surface sampled
densely, the samples binned into pixels sized so that the object covers
about twice its point count of them, the nearest sample of each pixel kept,
in scanline order.

The view law is the mix's ``rotation``: ``uniform`` (the default), any
rotation; or ``upright``, a gravity-aligned object as a scan in the working
frame (up +y) sees it, turned about its +y by a uniform yaw and tilted off
+y by at most ``tilt_deg``.  The object's centre lies ``offset_x`` and
``offset_y`` times its distance off the camera's axis, each way, or, where
the mix gives ``height_m: [lo, hi]``, that far below it (-y): a scan seen
from above.

A mix file (``traffic/<mix>.json``) gives the ranges.  Every seed gets the
same set of point counts (log-uniform quantiles on ``points``), diagonals
(uniform quantiles) and views (:func:`work`), so that the seed changes the
order, the placement, the surface samples and the draws, and not the
amount of work.  The same seed gives the same crops.
"""
from __future__ import annotations

import json
import os
from typing import List, NamedTuple

import numpy as np


class Mesh(NamedTuple):
    vertices: np.ndarray
    faces: np.ndarray


def make_cylinder(radius=0.04, height=0.12, segments=48, rings=16) -> Mesh:
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ys = np.linspace(-height / 2, height / 2, rings)
    side = np.array([[radius * np.cos(a), y, radius * np.sin(a)] for y in ys for a in ang])
    verts = np.concatenate([side, np.array([[0, height / 2, 0.0], [0, -height / 2, 0.0]])])
    faces = []
    for r in range(rings - 1):
        for s in range(segments):
            a, b = r * segments + s, r * segments + (s + 1) % segments
            c, d = (r + 1) * segments + s, (r + 1) * segments + (s + 1) % segments
            faces += [[a, b, c], [b, d, c]]
    top_i, bot_i, last = len(side), len(side) + 1, (rings - 1) * segments
    for s in range(segments):
        faces.append([last + s, last + (s + 1) % segments, top_i])
        faces.append([(s + 1) % segments, s, bot_i])
    return Mesh(verts.astype(np.float32), np.array(faces, np.int32))


def make_box(extents=(0.08, 0.05, 0.1)) -> Mesh:
    ex, ey, ez = np.asarray(extents) / 2
    v = np.array([[sx * ex, sy * ey, sz * ez] for sx in (-1, 1) for sy in (-1, 1)
                  for sz in (-1, 1)], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                  [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return Mesh(v, f)


def make_bowl(radius=0.09, height=0.045, segments=48, rings=12) -> Mesh:
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    verts = []
    for t in np.linspace(0, 1, rings):
        r = radius * np.sin(t * np.pi / 2)
        y = -height * np.cos(t * np.pi / 2)
        verts += [[r * np.cos(a), y, r * np.sin(a)] for a in ang]
    faces = []
    for r in range(rings - 1):
        for s in range(segments):
            a, b = r * segments + s, r * segments + (s + 1) % segments
            c, d = (r + 1) * segments + s, (r + 1) * segments + (s + 1) % segments
            faces += [[a, c, b], [b, c, d]]
    return Mesh(np.array(verts, np.float32), np.array(faces, np.int32))


SHAPES = {"cylinder": make_cylinder, "box": make_box, "bowl": make_bowl}
MESHES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "meshes")


def load_mesh(category: str) -> Mesh:
    """The mesh of ``meshes/<category>.json``: its parts made by
    :data:`SHAPES`, each moved by its ``at``, merged in order."""
    with open(os.path.join(MESHES, f"{category}.json")) as f:
        parts = json.load(f)["parts"]
    verts, faces, off = [], [], 0
    for part in parts:
        sizes = {k: v for k, v in part.items() if k not in ("shape", "at")}
        m = SHAPES[part["shape"]](**sizes)
        verts.append(m.vertices + np.asarray(part.get("at", (0, 0, 0)), np.float32))
        faces.append(m.faces + off)
        off += len(m.vertices)
    return Mesh(np.concatenate(verts), np.concatenate(faces))


def sample_surface(mesh: Mesh, n: int, rng: np.random.Generator) -> np.ndarray:
    """Area-weighted uniform surface samples [n, 3]."""
    tri = mesh.vertices[mesh.faces]
    area = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1)
    pick = rng.choice(len(mesh.faces), size=n, p=area / area.sum())
    u = rng.uniform(size=(n, 1))
    w = rng.uniform(size=(n, 1))
    flip = (u + w) > 1
    u, w = np.where(flip, 1 - u, u), np.where(flip, 1 - w, w)
    t = tri[pick]
    return (t[:, 0] + u * (t[:, 1] - t[:, 0]) + w * (t[:, 2] - t[:, 0])).astype(np.float32)


def random_rotation(rng: np.random.Generator) -> np.ndarray:
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def upright_rotation(rng: np.random.Generator, tilt_deg: float) -> np.ndarray:
    """A turn about +y by a uniform yaw, then a tilt, uniform in
    [0, ``tilt_deg``] degrees, about a horizontal axis at a uniform azimuth:
    the mesh's +y ends within ``tilt_deg`` of +y."""
    yaw, azimuth = rng.uniform(0.0, 2 * np.pi, size=2)
    tilt = np.deg2rad(rng.uniform(0.0, tilt_deg))
    c, s = np.cos(yaw), np.sin(yaw)
    turn = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    kx, kz = np.cos(azimuth), np.sin(azimuth)
    k = np.array([[0.0, -kz, 0.0], [kz, 0.0, -kx], [0.0, kx, 0.0]])  # [k]x, k = (kx, 0, kz)
    return (np.eye(3) + np.sin(tilt) * k + (1 - np.cos(tilt)) * k @ k) @ turn


def view(mix: dict, rng: np.random.Generator) -> np.ndarray:
    """A rotation of the mix's view law (``rotation``, default ``uniform``)."""
    law = mix.get("rotation", "uniform")
    if law == "uniform":
        return random_rotation(rng)
    if law == "upright":
        return upright_rotation(rng, mix["tilt_deg"])
    raise ValueError(f"rotation {law!r}: gen.py draws 'uniform' or 'upright'")


def make_crop(category: str, mix: dict, diag: float, n: int, rot: np.ndarray,
              rng: np.random.Generator) -> np.ndarray:
    """One crop [<= n, 3] float32 of the category's mesh scaled to diagonal
    ``diag`` and turned by ``rot``, in meters in the camera frame (z
    forward)."""
    mesh = load_mesh(category)
    lo, hi = mesh.vertices.min(0), mesh.vertices.max(0)
    verts = (mesh.vertices - (lo + hi) / 2) * (diag / np.linalg.norm(hi - lo))
    d = float(rng.uniform(*mix["distance_m"]))
    x = rng.uniform(-1, 1) * mix["offset_x"] * d
    y = (-rng.uniform(*mix["height_m"]) if "height_m" in mix
         else rng.uniform(-1, 1) * mix["offset_y"] * d)
    off = np.array([x, y, d])
    verts = verts @ rot.T + off
    pts = sample_surface(Mesh(verts.astype(np.float32), mesh.faces),
                         mix["samples_per_point"] * n, rng)
    uv = pts[:, :2] / pts[:, 2:3]
    extent = uv.max(0) - uv.min(0)
    # pixels of the virtual camera: the object's image covers about 2n of
    # them, of which the visible half of the surface fills about n
    pix = np.sqrt(extent[0] * extent[1] / (2 * n))
    cell = np.floor((uv - uv.min(0)) / pix).astype(np.int64)
    cell_id = cell[:, 1] * (int(cell[:, 0].max()) + 1) + cell[:, 0]
    # the nearest sample of each pixel, pixels in scanline order
    order = np.lexsort((pts[:, 2], cell_id))
    first = np.ones(len(order), bool)
    first[1:] = cell_id[order][1:] != cell_id[order][:-1]
    keep = order[first]
    if len(keep) > n:
        keep = keep[np.sort(rng.choice(len(keep), n, replace=False))]
    return np.ascontiguousarray(pts[keep], np.float32)


def work(count: int, mix: dict, scale_range):
    """The work of a pool of ``count`` crops, the same for every seed:
    [(point count, diagonal, rotation)].  Point counts at the ``count``
    quantile midpoints of a log-uniform law on ``points``, diagonals at
    those of a uniform law on ``scale_range`` (paired by a fixed stride so
    that size and diagonal do not move together), and a rotation of the
    mix's view law each from a generator of its own: how much of the object
    a view shows sets how many voxels the pose works on."""
    q = (np.arange(count) + 0.5) / count
    lo, hi = np.log(mix["points"][0]), np.log(mix["points"][1])
    points = np.round(np.exp(lo + q * (hi - lo))).astype(int)
    stride = next(s for s in range(count // 2 + 1, count + 1) if np.gcd(s, count) == 1) \
        if count > 2 else 1
    diags = scale_range[0] + q[(np.arange(count) * stride) % count] * (
        scale_range[1] - scale_range[0])
    views = np.random.default_rng(count)
    return [(int(p), float(d), view(mix, views)) for p, d in zip(points, diags)]


def make_crops(category: str, mix: dict, scale_range, count: int,
               rng: np.random.Generator) -> List[np.ndarray]:
    """``count`` crops of :func:`work`, in an order, at distances and
    offsets, and with surface samples drawn from ``rng``."""
    pool = work(count, mix, scale_range)
    return [make_crop(category, mix, pool[i][1], pool[i][0], pool[i][2], rng)
            for i in rng.permutation(count)]
