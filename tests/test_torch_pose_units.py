"""The flagged categories' pieces of the port's pose pipeline against
cppf_tpu's, on committed views at the slice tests' size: the radial
asymmetry score, the protrusion centroid, the axis vote with pair weights
and with the top-K decode, and the coplanar center mask.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf_tpu.core.targets import radial_asymmetry_about as radial_asymmetry_about_j
from cppf_tpu.pipeline import pose as pose_j
from cppf_tpu.train.checkpoints import load_params
from cppf_tpu_torch.core.targets import radial_asymmetry_about
from cppf_tpu_torch.pipeline import pose
from torch_slices import ROOT, _axis_draws, preprocess, small_configs, t, view

torch.set_num_threads(1)


def _cloud(category, i=0, n_points=512):
    """(JAX preprocessed cloud, the view's GT center and up) of view ``i``."""
    raw, z = view(category, i)
    _, _, cfg = small_configs(category)
    return preprocess(raw, cfg.res, n_points), z[f"T_{i}"], z[f"R_{i}"][:, 1]


@pytest.mark.parametrize("category", ["mug", "camera", "table"])
def test_radial_asymmetry_and_protrusion_match_jax(category):
    """radial_asymmetry_about to 1e-6 and _protrusion_centroid's direction
    to 1e-6 (the same gate), about the GT axis through a center moved off
    the GT one, on a cloud whose padded tail is masked."""
    pre, T, up = _cloud(category)
    center = (T + np.float32([0.004, -0.002, 0.003])).astype(np.float32)
    n_valid = min(int(pre.n_valid), pre.pc.shape[0] - 32)
    asym_j = radial_asymmetry_about_j(pre.pc, jnp.asarray(center), jnp.asarray(up), n_valid)
    asym_t = radial_asymmetry_about(t(pre.pc), t(center), t(up), n_valid)
    np.testing.assert_allclose(asym_t.numpy(), np.asarray(asym_j), atol=1e-6, rtol=0)
    assert float(asym_t.max()) > 0 and float(asym_t[n_valid:].abs().sum()) == 0
    h_j, gate_j = pose_j._protrusion_centroid(pre.pc, jnp.asarray(center), jnp.asarray(up),
                                              n_valid, asym_j)
    h_t, gate_t = pose._protrusion_centroid(t(pre.pc), t(center), t(up), n_valid, asym_t)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-6, rtol=0)
    assert bool(gate_t) == bool(gate_j)


def _network(category, seed=3):
    """JAX pair predictions on view 0 at the test size: (pre, point_idxs,
    preds, pair_mask with ~30 % dropped, both PoseConfigs)."""
    pre, T, up = _cloud(category)
    pcfg_j, pcfg_t, _ = small_configs(category)
    params = load_params(os.path.join(ROOT, "checkpoints", category), "params_best")
    idxs, preds = pose_j.pair_predictions(jax.random.PRNGKey(seed), params["point"],
                                          params["ppf"], pre.pc, pre.normals, pre.n_valid,
                                          pcfg_j, pre.nbr_idx)
    mask = np.random.default_rng(seed).random(idxs.shape[0]) < 0.7
    return pre, T, up, idxs, preds, mask, pcfg_j, pcfg_t


@pytest.mark.parametrize("category,case", [("mug", "pair_weights"), ("laptop", "axis_topk")])
def test_vote_axis_matches_jax(category, case):
    """_vote_axis on the right-axis logits, on JAX's draws: with the
    asymmetry pair weights of asym_right_votes (mug), and with laptop's
    top-4 decode; the same signed sphere direction to 1e-6."""
    pre, T, up, idxs, preds, mask, pcfg_j, pcfg_t = _network(category)
    assert (pcfg_t.axis_topk > 1) == (case == "axis_topk")
    B, R = pcfg_j.tr_num_bins, pcfg_j.rot_num_bins
    logits, aux = preds[:, 2 * B + R: 2 * B + 2 * R], preds[:, -4]
    weights = None
    if case == "pair_weights":
        asym = radial_asymmetry_about_j(pre.pc, jnp.asarray(T), jnp.asarray(up), pre.n_valid)
        weights = 0.05 + 0.95 * jnp.maximum(asym[idxs[:, 0]], asym[idxs[:, 1]])
    sphere = pcfg_t.sphere_points()
    key = jax.random.PRNGKey(5)
    got_j = pose_j._vote_axis(key, pre.pc, pre.normals, idxs, jnp.asarray(mask), logits, aux,
                              jnp.asarray(sphere), pcfg_j, pair_weights=weights)
    got_t = pose._vote_axis(t(pre.pc), t(pre.normals), t(idxs), torch.from_numpy(mask),
                            t(logits), t(aux), torch.from_numpy(sphere), pcfg_t,
                            _axis_draws(key, pcfg_t),
                            pair_weights=None if weights is None else t(weights))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(got_j), atol=1e-6, rtol=0)


def _coplanar_j(pc, pc_normal, point_idxs):
    """The JAX pipeline's filter_coplanar base_mask, as
    cppf_tpu/pipeline/pose.py:566-593 computes it inline."""
    n1 = pc_normal[point_idxs[:, 0]]
    n2 = pc_normal[point_idxs[:, 1]]
    ab = pc[point_idxs[:, 0]] - pc[point_idxs[:, 1]]
    abu = ab / (jnp.linalg.norm(ab, axis=-1, keepdims=True) + 1e-7)
    coplanar = ((jnp.abs(jnp.sum(n1 * n2, -1)) > 0.9)
                & (jnp.abs(jnp.sum(abu * n1, -1)) < 0.1)
                & (jnp.abs(jnp.sum(abu * n2, -1)) < 0.1))
    keep = ~coplanar
    return keep | (jnp.mean(keep.astype(pc.dtype)) < 0.05)


@pytest.mark.parametrize("cloud", ["table view", "one plane"])
def test_coplanar_mask_matches_jax(cloud):
    """filter_coplanar's center mask, bit-equal to JAX's: on a view of
    table's (2048 points: at 512 the cloud holds only the top), where it
    drops pairs, and on a single plane, where it would keep under 5 % and so
    keeps every pair."""
    rng = np.random.default_rng(0)
    if cloud == "table view":
        pre = _cloud("table", 1, 2048)[0]
        pc, nrm = np.asarray(pre.pc), np.asarray(pre.normals)
        n = int(pre.n_valid)
    else:
        n = 400
        pc = np.concatenate([rng.random((n, 2)), np.full((n, 1), 0.7)], 1).astype(np.float32)
        nrm = np.tile(np.float32([0, 0, 1]), (n, 1))
    idxs = rng.integers(0, n, (4096, 2)).astype(np.int32)
    got_j = np.asarray(_coplanar_j(jnp.asarray(pc), jnp.asarray(nrm), jnp.asarray(idxs)))
    got_t = pose.coplanar_center_mask(t(pc), t(nrm), t(idxs)).numpy()
    np.testing.assert_array_equal(got_t, got_j)
    if cloud == "table view":
        assert 0.05 < got_t.mean() < 1.0
    else:
        assert got_t.all()
