"""The port's drawing (eval/viz.py) against cv2 and the JAX package's
viz.py, and its PNG writer (data/png.py::write_png) against read_png and
cv2.imread.

draw_line paints exactly cv2.line's pixels at every thickness: against
cv2 5.0, of 16 000 random segments at thicknesses 1-8, on images of 1-70
rows by 1-90 columns, with end points up to 5 000 pixels outside them,
none differed; so the pinned tolerance is 0 pixels for thick lines too."""
import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cppf_tpu.eval import viz as viz_j
from cppf_tpu_torch.data.png import decode_png, encode_png, read_png, write_png
from cppf_tpu_torch.eval import viz

H, W = 48, 64
COORD = st.integers(-120, 180)


@settings(max_examples=300, deadline=None)
@given(x0=COORD, y0=COORD, x1=COORD, y1=COORD, thickness=st.integers(1, 3),
       channels=st.sampled_from([1, 3]))
def test_draw_line_equals_cv2(x0, y0, x1, y1, thickness, channels):
    """Segments inside, across and wholly outside the image: the painted
    pixels equal cv2.line's (0 differing pixels at every thickness)."""
    shape = (H, W) if channels == 1 else (H, W, 3)
    img = np.random.default_rng(abs(x0 * 7 + y1)).integers(0, 256, shape).astype(np.uint8)
    color = (200, 30, 90)
    want = cv2.line(img.copy(), (x0, y0), (x1, y1), color, thickness)
    got = viz.draw_line(img.copy(), (x0, y0), (x1, y1), color, thickness)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("thickness", [1, 2, 3, 5, 8])
def test_draw_line_degenerate_and_far_segments(thickness):
    """A point (p = q), segments far outside the image and ones crossing
    it from far away."""
    rng = np.random.default_rng(thickness)
    for _ in range(60):
        p = tuple(int(v) for v in rng.integers(-3000, 3000, 2))
        q = p if rng.random() < 0.2 else tuple(int(v) for v in rng.integers(-3000, 3000, 2))
        img = np.zeros((H, W), np.uint8)
        want = cv2.line(img.copy(), p, q, 255, thickness)
        np.testing.assert_array_equal(viz.draw_line(img.copy(), p, q, 255, thickness), want)


def test_draw_line_rejects_what_cv2_draws_otherwise():
    with pytest.raises(ValueError, match="uint8"):
        viz.draw_line(np.zeros((4, 4), np.float32), (0, 0), (3, 3), 1)
    with pytest.raises(ValueError, match="thickness"):
        viz.line_mask((4, 4), (0, 0), (3, 3), 0)


def _pose(rng):
    """A random 9D pose in front of the demo camera: R·s and T."""
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    q *= np.sign(np.linalg.det(q))
    RT = np.eye(4)
    RT[:3, :3] = q * rng.uniform(0.1, 0.3)
    RT[:3, 3] = [rng.uniform(-0.3, 0.3), rng.uniform(-0.2, 0.2), rng.uniform(0.5, 1.5)]
    return RT, rng.uniform(0.3, 1.0, 3)


@pytest.mark.parametrize("seed", range(4))
def test_render_pose_overlay_equals_jax(seed):
    """The JAX package's render_pose_overlay (cv2.line at thickness 3, the
    shaded box and the three axes) and the port's on the same pose."""
    from cppf_tpu_torch.eval.zero_shot import DEMO_INTRINSICS

    rng = np.random.default_rng(seed)
    RT, scale = _pose(rng)
    img = rng.integers(0, 256, (480, 640, 3)).astype(np.uint8)
    want = viz_j.render_pose_overlay(img.copy(), RT, scale, DEMO_INTRINSICS, color=(30, 220, 90))
    got = viz.render_pose_overlay(img.copy(), RT, scale, DEMO_INTRINSICS, color=(30, 220, 90))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, img)


def test_draw_box_equals_jax():
    """draw_box without axes, corners partly outside the image."""
    rng = np.random.default_rng(7)
    pts = rng.integers(-50, 700, (8, 2)).astype(np.float64)
    img = np.zeros((480, 640, 3), np.uint8)
    want = viz_j.draw_box(img.copy(), pts, None, (255, 120, 0))
    np.testing.assert_array_equal(viz.draw_box(img.copy(), pts, None, (255, 120, 0)), want)
    assert viz.BBOX_EDGES == viz_j.BBOX_EDGES


@pytest.mark.parametrize("shape,dtype", [((7, 5), np.uint8), ((7, 5, 3), np.uint8),
                                         ((7, 5, 4), np.uint8), ((9, 4), np.uint16),
                                         ((1, 1, 3), np.uint8), ((480, 640, 3), np.uint8)])
def test_write_png_round_trips(tmp_path, shape, dtype):
    """What write_png writes, read_png and cv2.imread give back (cv2 in
    BGR(A) order)."""
    img = np.random.default_rng(3).integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    got = read_png(path)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        want = want[:, :, [2, 1, 0, 3][: img.shape[2]]]
    np.testing.assert_array_equal(want, img)


def test_write_png_grey_alpha_and_refusals():
    img = np.random.default_rng(4).integers(0, 256, (6, 3, 2)).astype(np.uint8)
    np.testing.assert_array_equal(decode_png(encode_png(img)), img)
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 3), np.uint16),
                np.zeros((4, 4, 5), np.uint8), np.zeros((0, 4), np.uint8)):
        with pytest.raises(ValueError, match="write_png"):
            encode_png(bad)
