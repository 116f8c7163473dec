"""The port's text drawing (eval/viz.py: ``draw_text``, ``put_text``,
``text_size``, ``draw_rectangle``) against the JAX package's ``draw_text``,
that is against cv2 5.0.

Tolerance: 0, every pixel and channel equal.  OpenCV 5 antialiases
``putText``: a glyph pixel takes ``bg + (color - bg)·a/255`` rounded, for
the glyph's coverage ``a`` there, and the glyphs are blended one after
another; the glyph table ``assets/hershey_triplex.npz`` stores each
glyph's pixels and coverage (``scripts/export_torch_hershey.py``)."""
import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cppf_tpu.eval import viz as viz_j
from cppf_tpu_torch.eval import viz

FONT = cv2.FONT_HERSHEY_TRIPLEX
PRINTABLE = "".join(chr(c) for c in range(32, 127))


def _cases(n=40, seed=0):
    """Seeded strings, boxes and image sizes: boxes near each edge and
    corner, and inside; images from narrower than the text box to 640×480;
    half with ``draw_bbox``."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        H, W = int(rng.integers(30, 481)), int(rng.integers(30, 641))
        text = "".join(rng.choice(list(PRINTABLE), int(rng.integers(1, 18))))
        h, w = int(rng.integers(1, 150)), int(rng.integers(1, 150))
        where = k % 5
        r0 = {0: 0, 1: H - h, 2: int(rng.integers(0, H))}.get(where % 3, 0)
        c0 = {0: 0, 1: W - w, 3: W - 1, 4: int(rng.integers(0, W))}.get(where, 0)
        out.append(((H, W), [r0, c0, r0 + h, c0 + w], text, bool(k % 2)))
    return out


@pytest.mark.parametrize("shape,bbox,text,draw_bbox", _cases(),
                         ids=[f"case{k}" for k in range(40)])
def test_draw_text_equals_jax(shape, bbox, text, draw_bbox):
    img = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3)).astype(np.uint8)
    want = viz_j.draw_text(img.copy(), bbox, text, draw_bbox)
    got = viz.draw_text(img.copy(), bbox, text, draw_bbox)
    np.testing.assert_array_equal(got, want)


def test_draw_text_labels_of_the_drivers():
    """Labels as a detection overlay writes them, on a 640×480 frame, at
    every corner and the middle."""
    img = np.random.default_rng(1).integers(0, 256, (480, 640, 3)).astype(np.uint8)
    for text in ("bowl 0.93", "Mug", "laptop_7 12.5%", "camera: 3.1 cm / 4.2 deg"):
        for bbox in ([0, 0, 40, 60], [440, 600, 479, 639], [0, 600, 30, 639],
                     [450, 0, 479, 30], [200, 300, 260, 380]):
            want = viz_j.draw_text(img.copy(), bbox, text, True)
            got = viz.draw_text(img.copy(), bbox, text, True)
            np.testing.assert_array_equal(got, want, err_msg=f"{text} {bbox}")


@settings(max_examples=200, deadline=None)
@given(text=st.text(alphabet=PRINTABLE, min_size=0, max_size=30))
def test_text_size_equals_cv2(text):
    assert viz.text_size(text) == cv2.getTextSize(text, FONT, 1, 1)


@settings(max_examples=150, deadline=None)
@given(text=st.text(alphabet=PRINTABLE, min_size=1, max_size=12),
       x=st.integers(-60, 120), y=st.integers(-20, 90), channels=st.sampled_from([1, 3]),
       color=st.tuples(*(st.integers(0, 255),) * 3))
def test_put_text_equals_cv2(text, x, y, channels, color):
    """Anywhere on a small image, partly or wholly outside it, grey or
    colour, on a random background."""
    shape = (64, 96) if channels == 1 else (64, 96, 3)
    img = np.random.default_rng(abs(x * 131 + y)).integers(0, 256, shape).astype(np.uint8)
    want = cv2.putText(img.copy(), text, (x, y), FONT, 1, color, 1)
    got = viz.put_text(img.copy(), text, (x, y), color)
    np.testing.assert_array_equal(got, want)


@settings(max_examples=200, deadline=None)
@given(x0=st.integers(-30, 90), y0=st.integers(-30, 70), x1=st.integers(-30, 90),
       y1=st.integers(-30, 70), thickness=st.sampled_from([-1, 1, 2, 3]))
def test_rectangle_equals_cv2(x0, y0, x1, y1, thickness):
    img = np.random.default_rng(abs(x0 * 17 + y1)).integers(0, 256, (48, 64, 3)).astype(np.uint8)
    want = cv2.rectangle(img.copy(), (x0, y0), (x1, y1), (255, 0, 0), thickness)
    got = viz.draw_rectangle(img.copy(), (x0, y0), (x1, y1), (255, 0, 0), thickness)
    np.testing.assert_array_equal(got, want)


def test_glyph_table_is_small_and_complete():
    import os

    z = np.load(viz.FONT_PATH)
    assert os.path.getsize(viz.FONT_PATH) < 100_000
    assert z["codes"].tolist() == list(range(32, 127))
    assert len(z["offsets"]) == len(z["alpha"]) == z["start"][-1]
    assert z["alpha"].min() >= 1
    assert "Hershey" in str(z["source"]) and "OpenCV" in str(z["source"])


@pytest.mark.parametrize("text", ["naïve", "tab\there", "line\n", "€"])
def test_characters_outside_the_table_raise(text):
    img = np.zeros((100, 300, 3), np.uint8)
    with pytest.raises(ValueError, match="no Hershey glyph"):
        viz.draw_text(img, [10, 10, 50, 50], text)
