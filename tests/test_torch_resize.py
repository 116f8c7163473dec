"""``data/resize.py`` against ``cv2.resize``, the three calls of the laptop
path: ``INTER_LINEAR`` on float32 (within 1e-6) and on uint8 (exact), and
``INTER_NEAREST`` on float32 labels (exact), from sources of 20 to 400
pixels a side, upsampled and downsampled, to the 224² crop and to other
sizes."""
import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cppf_tpu_torch.data.resize import resize_linear, resize_nearest

torch.set_num_threads(1)

SIDE = st.integers(20, 400)


def _image(h, w, seed, dtype, channels=3):
    rng = np.random.default_rng(seed)
    shape = (h, w, channels) if channels else (h, w)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape, dtype=np.float32)


@settings(max_examples=60, deadline=None)
@given(h=SIDE, w=SIDE, seed=st.integers(0, 2**16))
def test_linear_float32_to_crop(h, w, seed):
    img = _image(h, w, seed, np.float32)
    got = resize_linear(img, (224, 224))
    assert got.dtype == np.float32 and got.shape == (224, 224, 3)
    np.testing.assert_allclose(got, cv2.resize(img, (224, 224)), rtol=0, atol=1e-6)


@settings(max_examples=60, deadline=None)
@given(h=SIDE, w=SIDE, seed=st.integers(0, 2**16))
def test_linear_uint8_to_crop_is_exact(h, w, seed):
    img = _image(h, w, seed, np.uint8)
    got = resize_linear(img, (224, 224))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, cv2.resize(img, (224, 224)))


@settings(max_examples=60, deadline=None)
@given(h=SIDE, w=SIDE, seed=st.integers(0, 2**16))
def test_nearest_labels_to_crop_is_exact(h, w, seed):
    labels = np.random.default_rng(seed).integers(-1, 2, (h, w)).astype(np.float32) * 100
    got = resize_nearest(labels, (224, 224))
    np.testing.assert_array_equal(
        got, cv2.resize(labels, (224, 224), interpolation=cv2.INTER_NEAREST))


@settings(max_examples=40, deadline=None)
@given(h=SIDE, w=SIDE, dh=SIDE, dw=SIDE, seed=st.integers(0, 2**16),
       channels=st.sampled_from([0, 1, 3]))
def test_any_size_any_channels(h, w, dh, dw, seed, channels):
    for dtype in (np.float32, np.uint8):
        img = _image(h, w, seed, dtype, channels)
        want = cv2.resize(img, (dw, dh)).reshape((dh, dw) + img.shape[2:])
        got = resize_linear(img, (dw, dh))
        if dtype == np.uint8:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    img = _image(h, w, seed, np.float32, channels)
    np.testing.assert_array_equal(
        resize_nearest(img, (dw, dh)),
        cv2.resize(img, (dw, dh), interpolation=cv2.INTER_NEAREST).reshape(
            (dh, dw) + img.shape[2:]))


@pytest.mark.parametrize("side", [112, 448])
def test_exact_halving_and_doubling(side):
    """cv2 takes its area route for an exact 2× downscale; the bilinear
    taps give the same values."""
    for dtype in (np.float32, np.uint8):
        img = _image(side, side, side, dtype)
        got, want = resize_linear(img, (224, 224)), cv2.resize(img, (224, 224))
        if dtype == np.uint8:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_rejects_other_dtypes():
    with pytest.raises(TypeError, match="float32 or uint8"):
        resize_linear(np.zeros((30, 30), np.float64), (224, 224))
