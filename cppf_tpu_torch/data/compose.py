"""Compositional random shape families (counterpart of
cppf_tpu/data/compose.py, numpy on the host, the same draws in the same
order).

They stand in for ShapeNet's category-level shape variation: every sample
is assembled from randomised parts —

- lathe bodies from random multi-control-point profiles
  (:func:`random_profile`),
- swept-tube handles (:func:`make_tube`), boxes, stepped barrels attached at
  random placements with random counts,
- per-category structural *styles* (table leg styles, chair back styles,
  book fills, …) drawn per sample,
- elliptic cross-section squash and smooth sinusoidal surface-detail
  displacement (:func:`displace`) on top.

Category-defining orientation cues stay consistent across draws (camera
viewfinder on top and grip on +x, can top rim inset deeper than the bottom,
bottle neck up, …): a family whose cue flips across samples feeds the
up/right heads contradictory labels and trains them to chance.

Canonical frames match the trained conventions: up = +y, the right cue on
+x, proportions only (the dataset normalises to unit diagonal and rescales
by cfg.scale_range).
"""
from __future__ import annotations

import numpy as np

from cppf_tpu_torch.data.synthetic import (
    Mesh,
    _merge,
    _translate,
    make_box,
    make_lathe,
)


# ---------------------------------------------------------------------------
# generic part machinery
# ---------------------------------------------------------------------------

def random_profile(rng, n_ctrl: int, r_lo: float, r_hi: float,
                   y0: float = 0.0, y1: float = 1.0,
                   smooth: int = 3, walk: float = 0.35):
    """Random ordered (y, r) lathe profile.

    ``n_ctrl`` control radii are drawn as a bounded random walk in
    [r_lo, r_hi], then Chaikin-smoothed ``smooth`` times so the revolved
    surface has ShapeNet-like curvature rather than hard cones.
    """
    ys = np.sort(rng.uniform(y0, y1, n_ctrl - 2))
    ys = np.concatenate([[y0], ys, [y1]])
    rs = np.empty(n_ctrl)
    rs[0] = rng.uniform(r_lo, r_hi)
    for i in range(1, n_ctrl):
        step = rng.uniform(-walk, walk) * (r_hi - r_lo)
        rs[i] = np.clip(rs[i - 1] + step, r_lo, r_hi)
    pts = np.stack([ys, rs], -1)
    for _ in range(smooth):  # Chaikin corner cutting (keeps endpoints)
        q = 0.75 * pts[:-1] + 0.25 * pts[1:]
        r = 0.25 * pts[:-1] + 0.75 * pts[1:]
        pts = np.concatenate([pts[:1], np.stack([q, r], 1).reshape(-1, 2), pts[-1:]])
    return [(float(y), float(max(r, 1e-3))) for y, r in pts]


def make_tube(path: np.ndarray, radius: float, segments: int = 10) -> Mesh:
    """Sweep a circle of ``radius`` along a 3D polyline (parallel transport).

    Open ends (caps are invisible where tubes attach to bodies); used for
    mug/cup handles and rails.
    """
    path = np.asarray(path, np.float64)
    n = len(path)
    tang = np.gradient(path, axis=0)
    tang /= np.linalg.norm(tang, axis=-1, keepdims=True) + 1e-9
    # initial normal: anything not parallel to the first tangent
    ref = np.array([0.0, 0.0, 1.0]) if abs(tang[0] @ [0, 0, 1]) < 0.9 else np.array([1.0, 0.0, 0.0])
    u = np.cross(tang[0], ref)
    u /= np.linalg.norm(u) + 1e-9
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    verts = []
    for i in range(n):
        if i:
            # transport u along the path: remove the new tangent component
            u = u - (u @ tang[i]) * tang[i]
            u /= np.linalg.norm(u) + 1e-9
        v = np.cross(tang[i], u)
        ring = path[i] + radius * (np.cos(ang)[:, None] * u + np.sin(ang)[:, None] * v)
        verts.append(ring)
    verts = np.concatenate(verts)
    faces = []
    for i in range(n - 1):
        for s in range(segments):
            a = i * segments + s
            b = i * segments + (s + 1) % segments
            c = (i + 1) * segments + s
            d = (i + 1) * segments + (s + 1) % segments
            faces += [[a, b, c], [b, d, c]]
    return Mesh(verts.astype(np.float32), np.asarray(faces, np.int32))


def displace(mesh: Mesh, rng, amp: float, n_waves: int = 3) -> Mesh:
    """Smooth sinusoidal surface-detail displacement.

    ``amp`` is relative to the mesh diagonal (0.01 ≈ 1% ripple — panel
    seams, embossing, fabric at depth-sensor scale).  The field is smooth in
    space so normals stay estimable from the sampled cloud.
    """
    v = mesh.vertices.astype(np.float64)
    diag = float(np.linalg.norm(v.max(0) - v.min(0))) + 1e-9
    out = v.copy()
    for _ in range(n_waves):
        k = rng.normal(size=3)
        k *= rng.uniform(2.0, 6.0) * 2 * np.pi / (diag * (np.linalg.norm(k) + 1e-9))
        d = rng.normal(size=3)
        d /= np.linalg.norm(d) + 1e-9
        a = amp * diag * rng.uniform(0.3, 1.0) / n_waves
        out += a * np.sin(v @ k + rng.uniform(0, 2 * np.pi))[:, None] * d
    return Mesh(out.astype(np.float32), mesh.faces)


def squash(mesh: Mesh, sx: float, sz: float) -> Mesh:
    """Elliptic cross-section: scale x/z (flasks, oval bowls, round tables)."""
    v = mesh.vertices * np.array([sx, 1.0, sz], np.float32)
    return Mesh(v.astype(np.float32), mesh.faces)


def _rot_y(mesh: Mesh, ang: float) -> Mesh:
    c, s = np.cos(ang), np.sin(ang)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return Mesh((mesh.vertices @ R.T).astype(np.float32), mesh.faces)


def _rot_x90(mesh: Mesh) -> Mesh:
    """Rotate the +y lathe axis onto +z (camera-lens axis)."""
    v = mesh.vertices[:, [0, 2, 1]].copy()
    v[:, 1] = -v[:, 1]
    return Mesh(v.astype(np.float32), mesh.faces)


def _maybe(rng, p: float) -> bool:
    return bool(rng.uniform() < p)


# ---------------------------------------------------------------------------
# NOCS categories
# ---------------------------------------------------------------------------

def random_bottle(rng) -> Mesh:
    """Body from a random multi-point profile + shoulder + neck (+ lip/cap).

    Always: neck at the top (the up-orientation cue).  Varies: body profile
    (straight/bulged/waisted), shoulder height, neck radius/length, lip,
    screw cap, elliptic (flask) squash, surface detail.
    """
    body_r = rng.uniform(0.16, 0.34)
    shoulder = rng.uniform(0.5, 0.8)
    neck_r = body_r * rng.uniform(0.22, 0.55)
    prof = random_profile(rng, int(rng.integers(3, 7)),
                          body_r * 0.75, body_r, 0.0, shoulder, walk=0.3)
    # shoulder taper into the neck
    neck_start = min(shoulder + rng.uniform(0.04, 0.16), 0.96)
    prof += [(neck_start, neck_r), (1.0, neck_r)]
    if _maybe(rng, 0.5):  # pouring lip
        prof.insert(-1, (0.96, neck_r))
        prof[-1] = (1.0, neck_r * rng.uniform(1.05, 1.3))
    mesh = make_lathe(prof)
    if _maybe(rng, 0.4):  # screw cap
        cap_r = neck_r * rng.uniform(1.1, 1.4)
        cap = make_lathe([(1.0, cap_r), (1.0 + rng.uniform(0.03, 0.08), cap_r)])
        mesh = _merge(mesh, cap)
    if _maybe(rng, 0.15):  # slightly out-of-round (manufacturing), NOT flasks:
        # bottle trains up_sym, and a strongly elliptic body makes the
        # (proj_len, dist2o, scale) targets azimuth-dependent while the
        # SE(3)-invariant features cannot observe azimuth — irreducible label
        # noise that was measured as 43 mm T / 45 % scale error (the
        # 0.45-0.85 flask squash of the first compositional family)
        mesh = squash(mesh, 1.0, rng.uniform(0.9, 0.98))
    return displace(mesh, rng, rng.uniform(0.0, 0.01))


def random_can(rng) -> Mesh:
    """Beverage/food cans: the top rim is ALWAYS inset deeper than the
    bottom (the up cue a plain cylinder lacks).  Varies: aspect, rib
    embossing, taper, neck (soda) vs straight (food) styles."""
    r = rng.uniform(0.22, 0.55)
    rim_bot = rng.uniform(0.9, 0.97)
    rim_top = rng.uniform(0.74, 0.88)
    if _maybe(rng, 0.5):  # soda-style necked top
        prof = [(0.0, r * rim_bot), (0.03, r), (0.82, r),
                (0.93, r * rng.uniform(0.82, 0.92)),
                (0.97, r * rim_top), (1.0, r * rim_top)]
    else:  # straight food can
        prof = [(0.0, r * rim_bot), (0.03, r), (0.93, r),
                (0.97, r * rim_top), (1.0, r * rim_top)]
    if _maybe(rng, 0.4):  # pressed ribs (real food cans)
        ribbed = []
        for (y, pr) in prof:
            ribbed.append((y, pr))
        ys = np.linspace(0.15, 0.8, int(rng.integers(3, 7)))
        depth = r * rng.uniform(0.02, 0.05)
        for y in ys:
            ribbed += [(float(y) - 0.015, r), (float(y), r - depth), (float(y) + 0.015, r)]
        prof = sorted(set(ribbed))
    return displace(make_lathe(prof), rng, rng.uniform(0.0, 0.006))


def random_bowl(rng) -> Mesh:
    """Open vessels with visible wall thickness: outer wall, rim, inner wall
    (+ optional foot ring).  Varies: curvature, depth, flare, ellipse."""
    height = rng.uniform(0.3, 0.7)
    base_r = rng.uniform(0.15, 0.5)
    p = rng.uniform(0.45, 1.6)  # wall curvature exponent
    t = rng.uniform(0.02, 0.06)  # wall thickness
    ts = np.linspace(0, 1, 9)
    outer = [(0.0, base_r)] + [
        (height * s, base_r + (1.0 - base_r) * s ** p) for s in ts[1:]
    ]
    # inner wall: mirror the profile inward, descending from the rim to an
    # inner floor above the base
    inner = [(max(y - t, t), max(r - t, base_r * 0.2)) for y, r in reversed(outer)]
    prof = outer + inner
    mesh = make_lathe(prof, close_bottom=True, close_top=True)
    if _maybe(rng, 0.5):  # foot ring
        foot_r = base_r * rng.uniform(0.7, 1.1)
        foot = make_lathe([(-rng.uniform(0.03, 0.09), foot_r), (0.0, foot_r)],
                          close_top=False)
        mesh = _merge(mesh, foot)
    if _maybe(rng, 0.25):
        # mild out-of-round only — bowl also trains up_sym (see random_bottle)
        mesh = squash(mesh, 1.0, rng.uniform(0.9, 0.98))
    return displace(mesh, rng, rng.uniform(0.0, 0.008))


def random_mug(rng) -> Mesh:
    """Body lathe (straight/barrel/tapered, wall thickness like bowls) + a
    swept-tube handle on +x (the right-axis cue) at random height/size."""
    r = rng.uniform(0.28, 0.48)
    h = 1.0
    style = rng.uniform()
    if style < 0.4:    # straight with taper
        outer = [(0.0, r * rng.uniform(0.85, 1.0)), (0.05, r), (h, r * rng.uniform(0.85, 1.08))]
    elif style < 0.7:  # barrel bulge
        outer = [(0.0, r * 0.9), (0.05, r), (h * 0.45, r * rng.uniform(1.05, 1.2)),
                 (h, r * rng.uniform(0.8, 1.0))]
    else:              # flared cup
        outer = [(0.0, r * rng.uniform(0.55, 0.75)), (h * 0.3, r * 0.85), (h, r * rng.uniform(1.0, 1.2))]
    t = rng.uniform(0.03, 0.06)
    inner = [(max(y - t, t * 2), max(rr - t, 0.08)) for y, rr in reversed(outer)]
    body = make_lathe(outer + inner)
    r_top = outer[-1][1]
    r_mid = max(o[1] for o in outer)

    # handle: C-arc swept tube on +x, attached at random heights
    y_hi = h * rng.uniform(0.6, 0.92)
    y_lo = h * rng.uniform(0.12, 0.4)
    reach = r_mid + rng.uniform(0.5, 1.0) * r
    th = rng.uniform(0.04, 0.08)
    ts = np.linspace(0, 1, 9)
    # attach x at the wall for the end points, bulge out in between
    yy = y_lo + (y_hi - y_lo) * ts
    bulge = np.sin(ts * np.pi)
    xx = r_mid * 0.95 + (reach - r_mid) * bulge
    path = np.stack([xx, yy, np.zeros_like(ts)], -1)
    handle = make_tube(path, th)
    mesh = _merge(body, handle)
    del r_top
    if _maybe(rng, 0.4):  # foot ring
        foot = make_lathe([(-rng.uniform(0.02, 0.06), outer[0][1] * 0.9),
                           (0.0, outer[0][1] * 0.95)], close_top=False)
        mesh = _merge(mesh, foot)
    return displace(mesh, rng, rng.uniform(0.0, 0.006))


def random_camera(rng) -> Mesh:
    """Body + stepped lens barrel + viewfinder (ALWAYS on top) + grip
    (ALWAYS +x) + random top knobs/flash.  The consistent top/right cues are
    what make the up/right heads learnable."""
    w = 1.0
    hh = w * rng.uniform(0.5, 0.8)
    d = w * rng.uniform(0.32, 0.55)
    body = make_box((w, hh, d))

    # stepped lens barrel on +z, above the body midline
    n_steps = int(rng.integers(1, 4))
    lens_r = w * rng.uniform(0.14, 0.28)
    z0, prof = 0.0, []
    for _ in range(n_steps):
        seg = d * rng.uniform(0.15, 0.45)
        prof += [(z0, lens_r), (z0 + seg, lens_r)]
        z0 += seg
        lens_r *= rng.uniform(0.75, 0.95)
    lens = _rot_x90(make_lathe(prof))
    lens = _translate(lens, (rng.uniform(-0.15, 0.15) * w,
                             hh * rng.uniform(0.02, 0.14), d / 2))

    vf = _translate(
        make_box((w * rng.uniform(0.22, 0.42), hh * rng.uniform(0.16, 0.32),
                  d * rng.uniform(0.5, 0.75))),
        (rng.uniform(-0.2, 0.2) * w, hh / 2, 0))
    grip = _translate(
        make_box((w * rng.uniform(0.14, 0.22), hh * rng.uniform(0.7, 0.98),
                  d * rng.uniform(0.2, 0.4))),
        (w / 2, 0.0, d * rng.uniform(0.1, 0.3)))
    parts = [body, lens, vf, grip]
    for _ in range(int(rng.integers(0, 3))):  # top dials
        kr = w * rng.uniform(0.03, 0.07)
        knob = make_lathe([(0.0, kr), (hh * rng.uniform(0.06, 0.14), kr)])
        parts.append(_translate(knob, (rng.uniform(-0.45, 0.45) * w, hh / 2, 0)))
    if _maybe(rng, 0.3):  # side thumb rest on -x (smaller than the grip)
        parts.append(_translate(
            make_box((w * 0.08, hh * rng.uniform(0.3, 0.6), d * 0.25)),
            (-w / 2, hh * 0.1, -d * 0.2)))
    return displace(_merge(*parts), rng, rng.uniform(0.0, 0.006))


def random_laptop(rng) -> Mesh:
    """Open clamshell: base slab + keyboard plateau + screen slab with bezel
    frame, hinged at the back (-z) at a random opening angle."""
    w = rng.uniform(1.0, 1.45)
    d = rng.uniform(0.65, 1.0)
    t = rng.uniform(0.03, 0.08)
    ang = np.deg2rad(rng.uniform(95, 140))
    base = _translate(make_box((w, t, d)), (0, t / 2, 0))
    parts = [base]
    if _maybe(rng, 0.7):  # keyboard plateau / touchpad step
        kb = _translate(
            make_box((w * rng.uniform(0.8, 0.95), t * 0.35, d * rng.uniform(0.35, 0.55))),
            (0, t + t * 0.14, -d * rng.uniform(0.05, 0.2)))
        parts.append(kb)
    sh = d * rng.uniform(0.8, 1.15)
    st = t * rng.uniform(0.4, 0.8)
    screen = _translate(make_box((w, sh, st)), (0, sh / 2, 0))
    if _maybe(rng, 0.5):  # raised bezel frame on the display face
        bz = w * rng.uniform(0.03, 0.07)
        frame = _merge(
            _translate(make_box((w, bz, st * 0.5)), (0, sh - bz / 2, st * 0.4)),
            _translate(make_box((w, bz, st * 0.5)), (0, bz / 2, st * 0.4)),
            _translate(make_box((bz, sh, st * 0.5)), ((w - bz) / 2, sh / 2, st * 0.4)),
            _translate(make_box((bz, sh, st * 0.5)), (-(w - bz) / 2, sh / 2, st * 0.4)),
        )
        screen = _merge(screen, frame)
    c, s = np.cos(ang - np.pi / 2), np.sin(ang - np.pi / 2)
    v = screen.vertices.copy()
    y, z = v[:, 1].copy(), v[:, 2].copy()
    v[:, 1] = c * y - s * z
    v[:, 2] = s * y + c * z
    v[:, 2] -= d / 2
    v[:, 1] += t
    parts.append(Mesh(v.astype(np.float32), screen.faces))
    return displace(_merge(*parts), rng, rng.uniform(0.0, 0.004))


# ---------------------------------------------------------------------------
# SUN RGB-D categories
# ---------------------------------------------------------------------------

def random_table(rng) -> Mesh:
    """Leg styles: 4 legs / pedestal / trestle panels; round or rectangular
    top; optional apron and lower shelf; desk variants with a drawer
    pedestal under the +x side.

    Most tables are 2-fold symmetric about up, so the right-axis *sign* is
    unlearnable on them (the aux bit trains to chance — same for the
    reference, whose ShapeNet table list also mixes desks in,
    reference data/shapenet_names/table.txt).  The desk draws carry a
    consistent +x cue so sign-informative pairs exist in the family at all;
    pair informativeness weighting (cfg.aux_asym) makes them dominate the
    aux BCE."""
    w, d = 1.0, rng.uniform(0.45, 1.0)
    h = rng.uniform(0.5, 0.95)
    t = rng.uniform(0.04, 0.1)
    style = rng.uniform()
    desk = False
    if _maybe(rng, 0.25):  # round top (pedestal-biased)
        rad = w / 2
        top = _translate(make_lathe([(0.0, rad), (t, rad)]), (0, h - t, 0))
        top = squash(top, 1.0, d / w)
        style = 0.9 if _maybe(rng, 0.8) else style
    else:
        top = _translate(make_box((w, t, d)), (0, h - t / 2, 0))
        if _maybe(rng, 0.35):  # desk: drawer pedestal under the +x side
            desk = True
            bw = w * rng.uniform(0.25, 0.4)
            bd = d * rng.uniform(0.7, 0.95)
            bank = _translate(make_box((bw, h - t, bd)),
                              ((w - bw) / 2 - w * 0.02, (h - t) / 2, 0))
            if _maybe(rng, 0.5):  # drawer-face steps (depth-visible seams)
                nd = int(rng.integers(2, 5))
                for i in range(nd):
                    fh = (h - t) / nd
                    bank = _merge(bank, _translate(
                        make_box((bw * 0.9, fh * 0.75, 0.015)),
                        ((w - bw) / 2 - w * 0.02,
                         fh * (i + 0.5), bd / 2)))
            parts_extra = [bank]
        else:
            parts_extra = []
    parts = [top]
    if desk:
        parts += parts_extra
        # support the open side with two -x legs
        lt = rng.uniform(0.04, 0.08)
        for sz in (-1, 1):
            parts.append(_translate(make_box((lt, h - t, lt)),
                                    (-(w / 2 - lt), (h - t) / 2,
                                     sz * (d / 2 - lt))))
        return displace(_merge(*parts), rng, rng.uniform(0.0, 0.004))
    if style < 0.55:  # 4 legs
        lt = rng.uniform(0.04, 0.1)
        inset = rng.uniform(1.0, 2.0)
        for sx in (-1, 1):
            for sz in (-1, 1):
                parts.append(_translate(
                    make_box((lt, h - t, lt)),
                    (sx * (w / 2 - lt * inset), (h - t) / 2, sz * (d / 2 - lt * inset))))
        if _maybe(rng, 0.4):  # apron frame under the top
            at = t * 0.8
            parts += [
                _translate(make_box((w * 0.9, at, lt)), (0, h - t - at / 2, sz * (d / 2 - lt * inset)))
                for sz in (-1, 1)]
        if _maybe(rng, 0.3):  # lower shelf
            parts.append(_translate(make_box((w * 0.85, t * 0.6, d * 0.85)),
                                    (0, h * rng.uniform(0.15, 0.4), 0)))
    elif style < 0.8:  # trestle: two side panels + stretcher
        pt = rng.uniform(0.05, 0.12)
        for sx in (-1, 1):
            parts.append(_translate(make_box((pt, h - t, d * rng.uniform(0.7, 1.0))),
                                    (sx * (w / 2 - pt), (h - t) / 2, 0)))
        parts.append(_translate(make_box((w * 0.9, t, pt)), (0, h * rng.uniform(0.1, 0.3), 0)))
    else:  # pedestal column + base
        cr = rng.uniform(0.06, 0.12)
        parts.append(_translate(make_lathe([(0.0, cr), (h - t, cr)]), (0, 0, 0)))
        parts.append(make_lathe([(0.0, rng.uniform(0.25, 0.45) * w), (t, cr * 1.5)]))
    return displace(_merge(*parts), rng, rng.uniform(0.0, 0.004))


def random_chair(rng) -> Mesh:
    """Backrest ALWAYS at -z (up/right cues); back styles solid / vertical
    slats / horizontal rails; optional armrests; leg styles."""
    w = rng.uniform(0.45, 0.68)
    seat_h = rng.uniform(0.38, 0.55)
    back_h = rng.uniform(0.35, 0.75)
    t = rng.uniform(0.04, 0.09)
    seat_d = w * rng.uniform(0.85, 1.1)
    seat = _translate(make_box((w, t, seat_d)), (0, seat_h, 0))
    parts = [seat]
    style = rng.uniform()
    zb = -(seat_d - t) / 2
    if style < 0.45:  # solid panel
        parts.append(_translate(make_box((w, back_h, t)),
                                (0, seat_h + back_h / 2, zb)))
    elif style < 0.75:  # vertical slats + top rail
        n = int(rng.integers(2, 6))
        st = w * rng.uniform(0.06, 0.12)
        xs = np.linspace(-(w / 2 - st), w / 2 - st, n)
        for x in xs:
            parts.append(_translate(make_box((st, back_h, t * 0.8)),
                                    (x, seat_h + back_h / 2, zb)))
        parts.append(_translate(make_box((w, t, t)),
                                (0, seat_h + back_h, zb)))
    else:  # horizontal rails
        n = int(rng.integers(2, 4))
        for i in range(n):
            parts.append(_translate(
                make_box((w, t * rng.uniform(0.8, 1.6), t * 0.8)),
                (0, seat_h + back_h * (i + 1) / n, zb)))
    if _maybe(rng, 0.35):  # armrests
        ah = seat_h * rng.uniform(0.35, 0.55)
        for sx in (-1, 1):
            parts.append(_translate(make_box((t, t, seat_d * 0.8)),
                                    (sx * (w / 2 - t / 2), seat_h + ah, 0)))
            parts.append(_translate(make_box((t, ah, t)),
                                    (sx * (w / 2 - t / 2), seat_h + ah / 2, seat_d * 0.3)))
    lt = rng.uniform(0.03, 0.07)
    if _maybe(rng, 0.85):  # 4 legs (else pedestal)
        for sx in (-1, 1):
            for sz in (-1, 1):
                parts.append(_translate(make_box((lt, seat_h, lt)),
                                        (sx * (w / 2 - lt), seat_h / 2, sz * (seat_d / 2 - lt))))
    else:
        parts.append(make_lathe([(0.0, w * 0.3), (t, lt * 2), (seat_h, lt * 2)]))
    return displace(_merge(*parts), rng, rng.uniform(0.0, 0.004))


def random_bed(rng) -> Mesh:
    """Mattress + base + headboard (ALWAYS at -z) + optional footboard and
    pillows (pillows at the head end reinforce the right cue)."""
    w = rng.uniform(0.8, 1.3)
    d = w * rng.uniform(1.3, 2.0)
    base_h = rng.uniform(0.15, 0.35)
    mat_h = rng.uniform(0.12, 0.25)
    head_h = rng.uniform(0.3, 0.7)
    parts = [
        _translate(make_box((w, base_h, d)), (0, base_h / 2, 0)),
        _translate(make_box((w * 0.98, mat_h, d * 0.97)), (0, base_h + mat_h / 2, 0)),
        _translate(make_box((w, head_h, 0.08)),
                   (0, base_h + mat_h + head_h / 2 - 0.05, -(d - 0.08) / 2)),
    ]
    if _maybe(rng, 0.4):  # footboard, always lower than the headboard
        fh = head_h * rng.uniform(0.25, 0.6)
        parts.append(_translate(make_box((w, fh, 0.07)),
                                (0, base_h + fh / 2, (d - 0.07) / 2)))
    for i in range(int(rng.integers(0, 3))):  # pillows at the head end
        pw = w * rng.uniform(0.3, 0.45)
        parts.append(displace(_translate(
            make_box((pw, mat_h * 0.6, d * 0.12)),
            ((i - 0.5) * pw * 1.2 if i < 2 else 0.0,
             base_h + mat_h + mat_h * 0.3, -d * 0.38)), rng, 0.02))
    return displace(_merge(*parts), rng, rng.uniform(0.0, 0.006))


def random_sofa(rng) -> Mesh:
    """Seat + back (ALWAYS -z) + arms + seat/back cushion bumps."""
    w = rng.uniform(1.2, 2.2)
    d = rng.uniform(0.6, 0.95)
    seat_h = rng.uniform(0.28, 0.45)
    back_h = rng.uniform(0.3, 0.6)
    arm_w = rng.uniform(0.08, 0.22)
    arm_h = seat_h * rng.uniform(1.3, 1.7)
    parts = [
        _translate(make_box((w, seat_h, d)), (0, seat_h / 2, 0)),
        _translate(make_box((w, back_h, d * rng.uniform(0.2, 0.3))),
                   (0, seat_h + back_h / 2, -d * 0.375)),
    ]
    for sx in (-1, 1):
        parts.append(_translate(make_box((arm_w, arm_h, d)),
                                (sx * (w - arm_w) / 2, arm_h / 2, 0)))
    n_cush = int(rng.integers(1, 4))
    cw = (w - 2 * arm_w) / n_cush
    if _maybe(rng, 0.7):  # seat cushions
        for i in range(n_cush):
            parts.append(displace(_translate(
                make_box((cw * 0.92, seat_h * 0.25, d * 0.8)),
                (-(w - 2 * arm_w) / 2 + cw * (i + 0.5), seat_h * 1.05, d * 0.05)),
                rng, 0.02))
    if _maybe(rng, 0.5):  # back pillows
        for i in range(n_cush):
            parts.append(displace(_translate(
                make_box((cw * 0.88, back_h * 0.8, d * 0.12)),
                (-(w - 2 * arm_w) / 2 + cw * (i + 0.5), seat_h + back_h * 0.45, -d * 0.22)),
                rng, 0.03))
    if _maybe(rng, 0.5):  # short legs
        for sx in (-1, 1):
            for sz in (-1, 1):
                parts.append(_translate(make_box((0.06, 0.08, 0.06)),
                                        (sx * (w / 2 - 0.1), -0.04, sz * (d / 2 - 0.1))))
    return displace(_merge(*parts), rng, rng.uniform(0.0, 0.006))


def random_bookshelf(rng) -> Mesh:
    """Frame + random shelves; shelves partially filled with random 'book'
    slabs (the dominant depth structure of real shelves)."""
    w = rng.uniform(0.7, 1.2)
    h = rng.uniform(1.2, 2.0)
    d = rng.uniform(0.22, 0.4)
    t = rng.uniform(0.03, 0.06)
    n_shelves = int(rng.integers(3, 7))
    parts = [
        _translate(make_box((t, h, d)), (-(w - t) / 2, h / 2, 0)),
        _translate(make_box((t, h, d)), ((w - t) / 2, h / 2, 0)),
        _translate(make_box((w, h, t)), (0, h / 2, -(d - t) / 2)),
    ]
    ys = np.sort(rng.uniform(0.1, 0.95, n_shelves - 1)) * h
    ys = np.concatenate([[0.05 * h], ys])
    for i, y in enumerate(ys):
        parts.append(_translate(make_box((w - 2 * t, t, d)), (0, y, 0)))
        gap = (ys[i + 1] if i + 1 < len(ys) else h) - y - t
        if gap < 0.08 * h or not _maybe(rng, 0.75):
            continue
        # fill a random run of books
        x = -(w / 2 - t) + rng.uniform(0, 0.3) * w
        while x < w / 2 - t - 0.05 * w:
            bw = w * rng.uniform(0.02, 0.05)
            bh = gap * rng.uniform(0.5, 0.95)
            parts.append(_translate(
                make_box((bw, bh, d * rng.uniform(0.5, 0.8))),
                (x + bw / 2, y + t / 2 + bh / 2, rng.uniform(-0.05, 0.05) * d)))
            x += bw * rng.uniform(1.05, 1.8)
            if _maybe(rng, 0.15):  # gap in the run
                x += w * rng.uniform(0.05, 0.2)
    return displace(_merge(*parts), rng, rng.uniform(0.0, 0.004))


def random_bathtub(rng) -> Mesh:
    """Open tub: floor + walls + rim lip; one end sloped (the backrest —
    the right-axis cue); optional freestanding feet."""
    w = rng.uniform(0.55, 0.9)
    d = w * rng.uniform(1.7, 2.7)
    h = rng.uniform(0.4, 0.65) * w
    t = rng.uniform(0.05, 0.1) * w
    parts = [
        _translate(make_box((w, t, d)), (0, t / 2, 0)),                      # floor
        _translate(make_box((t, h, d)), ((w - t) / 2, h / 2, 0)),            # sides
        _translate(make_box((t, h, d)), (-(w - t) / 2, h / 2, 0)),
        _translate(make_box((w, h, t)), (0, h / 2, (d - t) / 2)),            # foot end
    ]
    # sloped backrest end at -z: a leaning slab
    slope = np.deg2rad(rng.uniform(0, 35))
    back = make_box((w, h / np.cos(slope), t))
    v = back.vertices.copy()
    y, z = v[:, 1].copy(), v[:, 2].copy()
    c, s = np.cos(slope), np.sin(slope)
    v[:, 1] = c * y - s * z
    v[:, 2] = s * y + c * z
    v[:, 1] += h / 2
    v[:, 2] += -(d - t) / 2 - s * h / 2
    parts.append(Mesh(v.astype(np.float32), back.faces))
    if _maybe(rng, 0.6):  # rim lip around the top
        lip = rng.uniform(0.05, 0.15) * w
        parts += [
            _translate(make_box((w + 2 * lip, t, lip)), (0, h - t / 2, (d + lip) / 2)),
            _translate(make_box((w + 2 * lip, t, lip)), (0, h - t / 2, -(d + lip) / 2)),
            _translate(make_box((lip, t, d)), ((w + lip) / 2, h - t / 2, 0)),
            _translate(make_box((lip, t, d)), (-(w + lip) / 2, h - t / 2, 0)),
        ]
    if _maybe(rng, 0.3):  # clawfoot feet
        for sx in (-1, 1):
            for sz in (-1, 1):
                parts.append(_translate(make_box((0.1 * w, 0.12 * w, 0.1 * w)),
                                        (sx * w * 0.35, -0.06 * w, sz * d * 0.4)))
    return displace(_merge(*parts), rng, rng.uniform(0.0, 0.005))


COMPOSITIONAL = {
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
