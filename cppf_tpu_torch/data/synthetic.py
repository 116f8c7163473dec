"""Synthetic primitives and ground-truth oracles (counterpart of
cppf_tpu/data/synthetic.py, numpy on the host; draws in the same order
from the same ``np.random.Generator``, so a seed gives the same meshes).

Used as the training data of the ShapeNet-free dataset
(``data/shapenet.py``), the held-out poses of decode validation, and
oracle pair predictions for tests.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from cppf_tpu_torch.config import Config


class Mesh(NamedTuple):
    vertices: np.ndarray  # [V, 3]
    faces: np.ndarray     # [F, 3] int


def make_cylinder(radius=0.04, height=0.12, segments=48, rings=16) -> Mesh:
    """Closed cylinder along +y, centred at the origin (can/bottle-like)."""
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ys = np.linspace(-height / 2, height / 2, rings)
    side = np.array([[radius * np.cos(a), y, radius * np.sin(a)] for y in ys for a in ang])
    top = np.array([[0, height / 2, 0.0], [0, -height / 2, 0.0]])
    verts = np.concatenate([side, top])
    faces = []
    for r in range(rings - 1):
        for s in range(segments):
            a = r * segments + s
            b = r * segments + (s + 1) % segments
            c = (r + 1) * segments + s
            d = (r + 1) * segments + (s + 1) % segments
            faces += [[a, b, c], [b, d, c]]
    top_i, bot_i = len(side), len(side) + 1
    last = (rings - 1) * segments
    for s in range(segments):
        faces.append([last + s, last + (s + 1) % segments, top_i])
        faces.append([(s + 1) % segments, s, bot_i])
    return Mesh(verts.astype(np.float32), np.array(faces, np.int32))


def make_box(extents=(0.08, 0.05, 0.1)) -> Mesh:
    ex, ey, ez = np.asarray(extents) / 2
    v = np.array(
        [[sx * ex, sy * ey, sz * ez] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        np.float32,
    )
    f = np.array(
        [
            [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
            [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
            [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
        ],
        np.int32,
    )
    return Mesh(v, f)


def make_bowl(radius=0.09, height=0.045, segments=48, rings=12) -> Mesh:
    """Open hemisphere-ish bowl, opening up (+y)."""
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ts = np.linspace(0, 1, rings)
    verts = []
    for t in ts:
        r = radius * np.sin(t * np.pi / 2)
        y = -height * np.cos(t * np.pi / 2)
        verts += [[r * np.cos(a), y, r * np.sin(a)] for a in ang]
    verts = np.array(verts, np.float32)
    faces = []
    for r in range(rings - 1):
        for s in range(segments):
            a = r * segments + s
            b = r * segments + (s + 1) % segments
            c = (r + 1) * segments + s
            d = (r + 1) * segments + (s + 1) % segments
            faces += [[a, c, b], [b, c, d]]
    return Mesh(verts, np.array(faces, np.int32))


def _merge(*meshes: Mesh) -> Mesh:
    verts, faces, off = [], [], 0
    for m in meshes:
        verts.append(m.vertices)
        faces.append(m.faces + off)
        off += len(m.vertices)
    return Mesh(np.concatenate(verts), np.concatenate(faces))


def _translate(mesh: Mesh, t) -> Mesh:
    return Mesh(mesh.vertices + np.asarray(t, np.float32), mesh.faces)


def make_bottle() -> Mesh:
    """Body + narrower neck: breaks the top/bottom symmetry a bare cylinder
    has (otherwise the up-aux orientation bit is unlearnable)."""
    body = make_cylinder(0.035, 0.13)
    neck = _translate(make_cylinder(0.015, 0.05), (0, 0.09, 0))
    return _merge(body, neck)


def make_mug() -> Mesh:
    """Cylinder + a simple 3-segment handle on +x."""
    body = make_cylinder(0.04, 0.09)
    h1 = _translate(make_box((0.03, 0.012, 0.012)), (0.055, 0.03, 0))
    h2 = _translate(make_box((0.03, 0.012, 0.012)), (0.055, -0.03, 0))
    h3 = _translate(make_box((0.012, 0.072, 0.012)), (0.065, 0.0, 0))
    return _merge(body, h1, h2, h3)


def make_table() -> Mesh:
    """:func:`random_table` at the midpoints of its ranges: a 1.0 × 0.065 ×
    0.75 m top whose face is 0.7 m up, on four 0.07 m legs."""
    return _table(0.75, 0.7, 0.065, 0.07)


def _table(d, h, t, lt, w=1.0) -> Mesh:
    top = _translate(make_box((w, t, d)), (0, h - t / 2, 0))
    legs = [_translate(make_box((lt, h - t, lt)),
                       (sx * (w / 2 - lt), (h - t) / 2, sz * (d / 2 - lt)))
            for sx in (-1, 1) for sz in (-1, 1)]
    return _merge(top, *legs)


PRIMITIVES = {
    "bottle": make_bottle,
    "can": lambda: make_cylinder(0.035, 0.1),
    "bowl": make_bowl,
    "mug": make_mug,
    "box": make_box,
    "camera": lambda: _merge(make_box((0.11, 0.07, 0.05)),
                             _translate(make_cylinder(0.022, 0.04), (0.02, 0, 0.04))),
    "laptop": lambda: make_box((0.3, 0.02, 0.25)),
    # the JAX package's PRIMITIVES has no table; the benchmark's table mesh
    # (portbench/meshes/table.json) is a copy of this one
    "table": make_table,
}


# ---------------------------------------------------------------------------
# Parameter-randomised primitive families
#
# ShapeNet's role in the reference (utils/dataset.py:84-257) is to supply
# *category-level shape variation* — the network must generalise over radii,
# aspect ratios, necks, handles.  Without ShapeNet in the environment, each
# family below draws those parameters per sample, standing in for the 100+
# CAD models per category.  Proportions only matter (the dataset normalises
# to unit diagonal and rescales by cfg.scale_range).
# ---------------------------------------------------------------------------

def make_lathe(profile, segments: int = 48, close_bottom=True, close_top=True) -> Mesh:
    """Surface of revolution around +y from an ordered (y, r) profile."""
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ca, sa = np.cos(ang), np.sin(ang)
    verts, faces = [], []
    rings = []
    for y, r in profile:
        rings.append(len(verts))
        verts.extend(np.stack([r * ca, np.full_like(ca, y), r * sa], -1))
    for r0, r1 in zip(rings[:-1], rings[1:]):
        for s in range(segments):
            a, b = r0 + s, r0 + (s + 1) % segments
            c, d = r1 + s, r1 + (s + 1) % segments
            faces += [[a, b, c], [b, d, c]]
    if close_bottom:
        pole = len(verts)
        verts.append([0.0, profile[0][0], 0.0])
        for s in range(segments):
            faces.append([(s + 1) % segments, s, pole])
    if close_top:
        pole = len(verts)
        verts.append([0.0, profile[-1][0], 0.0])
        r0 = rings[-1]
        for s in range(segments):
            faces.append([r0 + s, r0 + (s + 1) % segments, pole])
    return Mesh(np.asarray(verts, np.float32), np.asarray(faces, np.int32))


def _rot_x90(mesh: Mesh) -> Mesh:
    """Rotate +y axis onto +z (lathe axis → camera-lens axis)."""
    v = mesh.vertices[:, [0, 2, 1]].copy()
    v[:, 1] = -v[:, 1]
    return Mesh(v.astype(np.float32), mesh.faces)


def random_bottle(rng) -> Mesh:
    body_r = rng.uniform(0.18, 0.33)
    taper = rng.uniform(0.92, 1.05)
    shoulder = rng.uniform(0.55, 0.8)
    neck_r = body_r * rng.uniform(0.25, 0.6)
    neck_start = shoulder + rng.uniform(0.05, 0.15)
    prof = [(0.0, body_r * rng.uniform(0.85, 1.0)), (0.03, body_r),
            (shoulder, body_r * taper), (min(neck_start, 0.97), neck_r), (1.0, neck_r)]
    if rng.uniform() < 0.5:  # lip
        prof.insert(-1, (0.96, neck_r))
        prof[-1] = (1.0, neck_r * rng.uniform(1.05, 1.25))
    return make_lathe(prof)


def random_can(rng) -> Mesh:
    """Beverage-can profile.  The top rim is always inset deeper than the
    bottom (the drinking end is necked like real cans): a perfectly
    top-bottom-symmetric cylinder makes the up-orientation aux bit
    unlearnable (both signs fit the same invariant features)."""
    r = rng.uniform(0.25, 0.5)
    rim_bot = rng.uniform(0.9, 0.97)
    rim_top = rng.uniform(0.78, 0.88)
    return make_lathe([(0.0, r * rim_bot), (0.03, r), (0.93, r),
                       (0.97, r * rim_top), (1.0, r * rim_top)])


def random_bowl(rng) -> Mesh:
    height = rng.uniform(0.35, 0.7)
    base_r = rng.uniform(0.2, 0.5)
    p = rng.uniform(0.5, 1.3)  # wall curvature exponent
    ts = np.linspace(0, 1, 10)
    prof = [(0.0, base_r * 0.999)] + [
        (height * t, base_r + (1.0 - base_r) * t ** p) for t in ts[1:]
    ]
    return make_lathe(prof, close_top=False)


def random_mug(rng) -> Mesh:
    r = rng.uniform(0.3, 0.45)
    h = 1.0
    taper = rng.uniform(0.85, 1.05)
    body = make_lathe([(0.0, r * 0.98), (0.02, r), (h, r * taper)], close_top=False)
    # handle: arc of thin boxes on +x
    span = h * rng.uniform(0.4, 0.75)
    stick = r * rng.uniform(0.6, 1.1)
    th = rng.uniform(0.05, 0.09)
    y0 = h / 2 + rng.uniform(-0.1, 0.1)
    top = _translate(make_box((stick, th, th)), (r + stick / 2 - th, y0 + span / 2, 0))
    bot = _translate(make_box((stick, th, th)), (r + stick / 2 - th, y0 - span / 2, 0))
    out = _translate(make_box((th, span + th, th)), (r + stick - th, y0, 0))
    return _merge(body, top, bot, out)


def random_camera(rng) -> Mesh:
    """Camera body + lens + viewfinder + grip.  The viewfinder is ALWAYS
    present and the lens sits above the body midline: a vertically
    mirror-symmetric sample (the old 50% no-viewfinder draw) gives the
    up-orientation targets contradictory labels across samples, which
    poisons the up-angle/aux heads.  The +x grip breaks left-right mirror
    symmetry so the right axis is geometrically determined."""
    w = 1.0
    hh = w * rng.uniform(0.55, 0.8)
    d = w * rng.uniform(0.35, 0.55)
    body = make_box((w, hh, d))
    lens_r = w * rng.uniform(0.16, 0.28)
    lens_l = d * rng.uniform(0.3, 0.8)
    lens = _rot_x90(make_lathe([(0.0, lens_r), (lens_l, lens_r)]))
    lens = _translate(lens, (rng.uniform(-0.15, 0.15) * w,
                             hh * rng.uniform(0.02, 0.12), d / 2))
    vf = _translate(
        make_box((w * rng.uniform(0.25, 0.4), hh * rng.uniform(0.18, 0.3),
                  d * rng.uniform(0.5, 0.7))),
        (rng.uniform(-0.2, 0.2) * w, hh / 2, 0))
    grip = _translate(
        make_box((w * 0.18, hh * rng.uniform(0.7, 0.95),
                  d * rng.uniform(0.2, 0.35))),
        (w / 2, 0.0, d * 0.2))
    return _merge(body, lens, vf, grip)


def random_laptop(rng) -> Mesh:
    """Open laptop: base slab in xz + screen slab hinged at the back (-z)."""
    w = rng.uniform(1.0, 1.4)
    d = rng.uniform(0.7, 1.0)
    t = rng.uniform(0.035, 0.07)
    ang = np.deg2rad(rng.uniform(95, 135))
    base = _translate(make_box((w, t, d)), (0, t / 2, 0))
    sh = d * rng.uniform(0.85, 1.1)
    screen = _translate(make_box((w, sh, t * rng.uniform(0.5, 0.9))), (0, sh / 2, 0))
    c, s = np.cos(ang - np.pi / 2), np.sin(ang - np.pi / 2)
    v = screen.vertices.copy()
    y, z = v[:, 1].copy(), v[:, 2].copy()
    v[:, 1] = c * y - s * z
    v[:, 2] = s * y + c * z
    v[:, 2] -= d / 2  # hinge at the back edge
    v[:, 1] += t
    return _merge(base, Mesh(v.astype(np.float32), screen.faces))


def random_table(rng) -> Mesh:
    d = rng.uniform(0.5, 1.0)
    h = rng.uniform(0.5, 0.9)
    t = rng.uniform(0.04, 0.09)
    lt = rng.uniform(0.04, 0.1)
    return _table(d, h, t, lt)


def random_chair(rng) -> Mesh:
    w = rng.uniform(0.45, 0.65)
    seat_h = rng.uniform(0.4, 0.55)
    back_h = rng.uniform(0.4, 0.6)
    t = rng.uniform(0.04, 0.08)
    lt = rng.uniform(0.03, 0.06)
    seat = _translate(make_box((w, t, w)), (0, seat_h, 0))
    back = _translate(make_box((w, back_h, t)), (0, seat_h + back_h / 2, -(w - t) / 2))
    legs = [_translate(make_box((lt, seat_h, lt)),
                       (sx * (w / 2 - lt), seat_h / 2, sz * (w / 2 - lt)))
            for sx in (-1, 1) for sz in (-1, 1)]
    return _merge(seat, back, *legs)


def random_bed(rng) -> Mesh:
    w = rng.uniform(0.8, 1.2)
    d = w * rng.uniform(1.4, 1.9)
    h = rng.uniform(0.25, 0.45)
    head_h = rng.uniform(0.3, 0.6)
    body = _translate(make_box((w, h, d)), (0, h / 2, 0))
    head = _translate(make_box((w, head_h, 0.08)), (0, h + head_h / 2, -(d - 0.08) / 2))
    return _merge(body, head)


def random_sofa(rng) -> Mesh:
    w = rng.uniform(1.2, 2.0)
    d = rng.uniform(0.6, 0.9)
    seat_h = rng.uniform(0.3, 0.45)
    back_h = rng.uniform(0.35, 0.55)
    arm_w = rng.uniform(0.1, 0.2)
    seat = _translate(make_box((w, seat_h, d)), (0, seat_h / 2, 0))
    back = _translate(make_box((w, back_h, d * 0.25)), (0, seat_h + back_h / 2, -d * 0.375))
    arms = [_translate(make_box((arm_w, seat_h * 1.5, d)),
                       (sx * (w - arm_w) / 2, seat_h * 0.75, 0)) for sx in (-1, 1)]
    return _merge(seat, back, *arms)


def random_bookshelf(rng) -> Mesh:
    w = rng.uniform(0.7, 1.1)
    h = rng.uniform(1.3, 2.0)
    d = rng.uniform(0.25, 0.4)
    t = 0.04
    n_shelves = int(rng.integers(3, 6))
    sides = [_translate(make_box((t, h, d)), (sx * (w - t) / 2, h / 2, 0)) for sx in (-1, 1)]
    backp = _translate(make_box((w, h, t)), (0, h / 2, -(d - t) / 2))
    shelves = [_translate(make_box((w - 2 * t, t, d)), (0, h * (i + 0.5) / n_shelves, 0))
               for i in range(n_shelves)]
    return _merge(*sides, backp, *shelves)


def random_bathtub(rng) -> Mesh:
    w = rng.uniform(0.6, 0.9)
    d = w * rng.uniform(1.8, 2.6)
    h = rng.uniform(0.4, 0.6) * w
    t = 0.08 * w
    outer = _translate(make_box((w, h, d)), (0, h / 2, 0))
    walls = [
        _translate(make_box((w, t, d)), (0, t / 2, 0)),  # floor marker
        _translate(make_box((t, h, d)), ((w - t) / 2, h / 2, 0)),
        _translate(make_box((t, h, d)), (-(w - t) / 2, h / 2, 0)),
        _translate(make_box((w, h, t)), (0, h / 2, (d - t) / 2)),
        _translate(make_box((w, h, t)), (0, h / 2, -(d - t) / 2)),
    ]
    del outer
    return _merge(*walls)


def random_box(rng) -> Mesh:
    return make_box((rng.uniform(0.5, 1.2), rng.uniform(0.5, 1.2), rng.uniform(0.5, 1.2)))


RANDOM_PRIMITIVES = {
    "bottle": random_bottle,
    "can": random_can,
    "bowl": random_bowl,
    "mug": random_mug,
    "camera": random_camera,
    "laptop": random_laptop,
    "table": random_table,
    "chair": random_chair,
    "bed": random_bed,
    "sofa": random_sofa,
    "bookshelf": random_bookshelf,
    "bathtub": random_bathtub,
}


def random_primitive(category: str, rng: np.random.Generator) -> Mesh:
    """A fresh randomly-parameterised instance of the category family.

    Dispatches to the compositional generators
    (:mod:`cppf_tpu_torch.data.compose` — multi-part bodies, part styles, surface
    detail); the single-template families above remain as the simpler
    fallback for categories without a compositional generator.
    """
    from cppf_tpu_torch.data.compose import COMPOSITIONAL

    fn = COMPOSITIONAL.get(category) or RANDOM_PRIMITIVES.get(category, random_box)
    return fn(rng)


def sample_surface(mesh: Mesh, n: int, rng: np.random.Generator) -> np.ndarray:
    """Area-weighted uniform surface samples [n, 3]."""
    v = mesh.vertices
    f = mesh.faces
    tri = v[f]                                        # [F, 3, 3]
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=-1)
    probs = area / area.sum()
    pick = rng.choice(len(f), size=n, p=probs)
    u = rng.uniform(size=(n, 1))
    w = rng.uniform(size=(n, 1))
    flip = (u + w) > 1
    u = np.where(flip, 1 - u, u)
    w = np.where(flip, 1 - w, w)
    t = tri[pick]
    return (t[:, 0] + u * (t[:, 1] - t[:, 0]) + w * (t[:, 2] - t[:, 0])).astype(np.float32)


def mesh_bounds(mesh: Mesh) -> Tuple[np.ndarray, np.ndarray]:
    return mesh.vertices.min(0), mesh.vertices.max(0)


def mesh_sign_cue(verts: np.ndarray, faces: np.ndarray, axis: int, diag: float):
    """Geometric learnability of the right-axis SIGN, as a fraction of scale.

    A body invariant under a 180° rotation about up maps right → −right, so
    no training signal can fix the sign (the aux bit sits at chance: plain
    rectangular tables).  The proxy is the area-weighted centroid offset in
    the plane ⊥ up — that flip negates both in-plane coordinates, so any
    first-moment offset (desk drawer pedestal along +x, sofa backrest along
    +z, mug handle) breaks the symmetry and carries a sign cue.  ``axis``
    is the canonical up (1 for y-up categories).  Shared by the
    checkpoint eval and the in-training decode validation so signed-right
    errors are scored only where the sign is learnable."""
    tri = verts[faces]
    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1)
    cen = np.delete(tri.mean(1), axis, axis=1)  # in-plane coords [F, 2]
    off = np.linalg.norm(area @ cen) / (np.sum(area) + 1e-12)
    return float(off / diag)


def oracle_pair_predictions(
    pc_cam: np.ndarray,
    normals_cam: np.ndarray,
    point_idxs: np.ndarray,
    T: np.ndarray,
    R: np.ndarray,
    bound_nocs: np.ndarray,
    scale: float,
    cfg: Config,
) -> np.ndarray:
    """Ground-truth PPF-head output [P, out_dim] for a posed instance.

    ``bound_nocs`` is the canonical full extent (x/z already swapped to NOCS
    convention), ``scale`` the uniform scale applied at render time; the
    scale logit is the training label of reference utils/dataset.py:246-248.
    Bin logits are sharp one-hots of the ground-truth bins.
    """
    a = pc_cam[point_idxs[:, 0]]
    b = pc_cam[point_idxs[:, 1]]
    d = a - b
    d_unit = d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-7)
    rel = a - T
    proj_len = np.sum(rel * d_unit, -1)
    dist2o = np.linalg.norm(rel - proj_len[:, None] * d_unit, axis=-1)

    up_axis = R @ np.array([0, 1, 0.0])
    right_axis = R @ (np.array([0, 0, 1.0]) if cfg.z_right else np.array([1.0, 0, 0]))
    up_ang = np.arccos(np.clip(np.sum(d_unit * up_axis, -1), -1, 1))
    if cfg.up_sym:
        up_ang = np.minimum(up_ang, np.pi - up_ang)
    right_ang = np.arccos(np.clip(np.sum(d_unit * right_axis, -1), -1, 1))
    if cfg.right_sym:
        right_ang = np.minimum(right_ang, np.pi - right_ang)

    n_a = normals_cam[point_idxs[:, 0]].copy()
    n_a[np.sum(n_a * d_unit, -1) < 0] *= -1
    aux_up = (np.sum(n_a * up_axis, -1) > 0).astype(np.float32)
    aux_right = (np.sum(n_a * right_axis, -1) > 0).astype(np.float32)

    B, Rb = cfg.tr_num_bins, cfg.rot_num_bins
    v0, v1 = cfg.vote_range
    big = 50.0

    def onehot_logits(vals, max_val, bins):
        idx = np.clip(np.round(vals / max_val * (bins - 1)).astype(int), 0, bins - 1)
        out = np.full((len(vals), bins), -big, np.float32)
        out[np.arange(len(vals)), idx] = big
        return out

    tr0 = onehot_logits(np.clip(proj_len + v0, 0, 2 * v0), 2 * v0, B)
    tr1 = onehot_logits(np.clip(dist2o, 0, v1), v1, B)
    upl = onehot_logits(up_ang, np.pi, Rb)
    rightl = onehot_logits(right_ang, np.pi, Rb)

    scale_logit = np.log(bound_nocs / 2 * scale) - np.log(np.asarray(cfg.scale_mean))
    P = len(point_idxs)
    out = np.concatenate(
        [
            np.stack([tr0, tr1], 1).reshape(P, 2 * B),
            upl,
            rightl,
            (aux_up[:, None] * 2 - 1) * big,
            (aux_right[:, None] * 2 - 1) * big,
            np.tile(scale_logit[None, :], (P, 1)).astype(np.float32),
        ],
        -1,
    )
    return out.astype(np.float32)


def random_pose(rng: np.random.Generator, nocs_style: bool = True):
    """Random pose like the renderer applies (reference utils/dataset.py:153-171)."""
    from cppf_tpu_torch.core.geometry import rotx, roty

    if nocs_style:
        y_angle = rng.uniform(0, 2 * np.pi)
        x_angle = rng.uniform(np.deg2rad(25), np.deg2rad(65))
        yy_angle = rng.uniform(np.deg2rad(-15), np.deg2rad(15))
        R = (roty(yy_angle)[:3, :3] @ rotx(x_angle)[:3, :3] @ roty(y_angle)[:3, :3])
        tr = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3), -rng.uniform(0.6, 2.0)])
    else:  # SUN RGB-D recipe (reference utils/dataset.py:163-171)
        y_angle = rng.uniform(0, 2 * np.pi)
        x_angle = np.clip(rng.normal(40, 10), 10, 70) / 180 * np.pi
        R = rotx(x_angle)[:3, :3] @ roty(y_angle)[:3, :3]
        tr = np.array([rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2), -rng.uniform(1.0, 5.0)])
    return R, tr


# the NOCS camera frame (after the reference's backproject x/y negations,
# nocs/inference.py:131-138) relates to our raster camera frame by this
# involution: p_nocs = D @ p_raster
_D_NOCS = np.diag([1.0, -1.0, -1.0])


def observation_pose(rng: np.random.Generator, is_nocs: bool = True):
    """GT pose of the TRAINED canonical frame in the observation (NOCS
    driver) camera frame, with the view direction drawn from the TRAINING
    distribution (objects seen from 25-65 deg ABOVE, reference
    utils/dataset.py:153-171 — naively reusing ``random_pose`` with the z
    sign flipped views objects from BELOW, off the training manifold).

    Returns (R_gt, T_gt): canonical points ``c`` (already flip2nocs'd for
    NOCS categories) observe at ``c @ R_gt.T + T_gt``; render their depth at
    ``(c @ R_gt.T + T_gt) * [1, -1, -1]``.  ``R_gt[:, 1]`` is the true up,
    ``R_gt[:, 0]``/``R_gt[:, 2]`` the true right under the x/z conventions.
    """
    from cppf_tpu_torch.data.shapenet import FLIP2NOCS

    R_t, tr_t = random_pose(rng, nocs_style=is_nocs)
    R_gt = _D_NOCS @ R_t @ (FLIP2NOCS.T if is_nocs else np.eye(3))
    T_gt = _D_NOCS @ tr_t
    return R_gt, T_gt
