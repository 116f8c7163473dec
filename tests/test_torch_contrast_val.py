"""The port's proposal-contrast validation (eval/contrast_val.py) against
cppf_tpu.eval.contrast_val: the val scene bit for bit, and the score of
the same predictors and of the committed params_zs on it.

The port's KNN takes ~100 s single-threaded on the whole scene's 67 000
network points at 4 mm, so the predictor cases run the whole scene at
8 mm (~17 000 points), and the committed weights, trained at 4 mm, run a
crop of the scene around its two bowls and the box at 4 mm.  Hits and false
positives must be equal; the mean contrast (and so the score's bonus)
moves with the network's float32 rounding, 4.6e-5 of a logit
(tests/test_torch_encoders.py), and is held to 1e-4 relative."""
import numpy as np
import pytest
import torch

from cppf_tpu.config import load_config as load_config_j
from cppf_tpu.eval import contrast_val as cv_j
from cppf_tpu_torch.config import load_config
from cppf_tpu_torch.eval import contrast_val as cv
from cppf_tpu_torch.models.convert import ASSETS, load_encoders, load_npz_params
from test_contrast_val import _diffuse_predict, _oracle_predict

torch.set_num_threads(1)
SNAP = "checkpoints/bowl_reg/config.yaml"
CONTRAST_RTOL = 1e-4


@pytest.mark.parametrize("category", ["bowl", "mug"])
def test_val_scene_bit_equal(category):
    depth_j, centers_j = cv_j.make_val_scene(category)
    depth, centers = cv.make_val_scene(category)
    assert depth.dtype == np.uint16 and depth.shape == (480, 640)
    np.testing.assert_array_equal(depth, depth_j)
    for c, c_j in zip(centers, centers_j, strict=True):
        assert c.dtype == c_j.dtype
        np.testing.assert_array_equal(c, c_j)


def _assert_scores_equal(got, want):
    assert sorted(got) == sorted(want)
    assert got["zs_hits"] == want["zs_hits"] and got["zs_false"] == want["zs_false"], (got, want)
    np.testing.assert_allclose(got["zs_mean_contrast"], want["zs_mean_contrast"],
                               rtol=CONTRAST_RTOL)
    np.testing.assert_allclose(got["zs_score"], want["zs_score"], rtol=CONTRAST_RTOL)


@pytest.mark.parametrize("predictor", ["oracle", "diffuse"])
def test_predictor_scores_match_jax(predictor):
    """JAX's center-perfect oracle and diffuse predictors (the JAX test's,
    at its 150 000 pairs and threshold 5) on the whole scene at 8 mm: the
    oracle finds both objects, the diffuse one none, in both packages."""
    cfg_j, cfg = load_config_j("bowl"), load_config("bowl")
    for c in (cfg_j, cfg):
        c.cls_bins = False
        c.res = 0.008
    depth, centers = cv.make_val_scene("bowl")
    fn = _oracle_predict(centers, cfg_j) if predictor == "oracle" else _diffuse_predict
    kw = dict(n_pairs=150000, num_rots=36, prop_thresh=5.0, predict_fn=fn)
    want = cv_j.proposal_contrast_score(depth, centers, None, cfg_j, **kw)
    got = cv.proposal_contrast_score(depth, centers, None, cfg, device="cpu", **kw)
    _assert_scores_equal(got, want)
    assert got["zs_hits"] == (2 if predictor == "oracle" else 0)


def test_committed_params_zs_score_matches_jax():
    """The committed params_zs at its own width (4 mm, knn 60) on the scene
    cropped to rows 195-294, columns 115-499 (both bowls, the box), at
    150 000 pairs and the threshold scaled with them (10 · 150/500 = 3):
    2 hits and 9 false positives in both packages; the port given the
    encoders scores as given the params tree."""
    cfg_j, cfg = load_config_j("bowl", snapshot=SNAP), load_config("bowl", snapshot=SNAP)
    cfg_j.cls_bins = cfg.cls_bins = False
    params = load_npz_params(f"{ASSETS}/bowl_reg_params_zs.npz")
    depth, centers = cv.make_val_scene("bowl")
    crop = np.zeros_like(depth)
    box = (slice(195, 295), slice(115, 500))
    crop[box] = depth[box]
    kw = dict(n_pairs=150000, prop_thresh=3.0)
    want = cv_j.proposal_contrast_score(crop, centers, params, cfg_j, **kw)
    got = cv.proposal_contrast_score(crop, centers, load_encoders(params, 9, "cpu"), cfg,
                                     device="cpu", **kw)
    _assert_scores_equal(got, want)
    assert want["zs_hits"] == 2 and want["zs_false"] == 9


def test_score_needs_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    depth, centers = cv.make_val_scene("bowl")
    with pytest.raises(RuntimeError, match="CUDA"):
        cv.proposal_contrast_score(depth, centers, None, load_config("bowl"),
                                   predict_fn=_diffuse_predict)


def test_contrast_scores_peaks_and_suppression():
    """contrast_scores on a synthetic heatmap: a sharp blob at each GT
    center is a hit at that voxel, a third blob elsewhere one false
    positive; score = 100·2 − 5·1 + min(mean/thresh, 10)."""
    grid = np.zeros((80, 60, 50), np.float32)
    corner = np.float32([-0.1, -0.1, 0.5])
    res = 0.004
    centers = [np.float32([0.0, 0.0, 0.6]), np.float32([0.1, 0.05, 0.65])]
    blobs = [np.round((c - corner) / res).astype(int) for c in centers] + [np.array([70, 10, 5])]
    for b in blobs:
        grid[tuple(b)] = 1000.0
    scores, peaks = cv.contrast_scores(grid, corner, res, centers)
    for p, b in zip(peaks, blobs[:2]):
        np.testing.assert_array_equal(p, b)
    assert scores["zs_hits"] == 2 and scores["zs_false"] == 1
    assert scores["zs_score"] == pytest.approx(195.0 + min(scores["zs_mean_contrast"] / 10, 10))
