"""The port's zero-shot slice against cppf_tpu.eval.zero_shot on the CPU.

Function by function on identical numpy inputs, then the slice as a whole
with the oracle ``predict_fn`` of tests/test_zero_shot.py on its two-can
frame.  tests/test_torch_zero_shot_demo.py runs it with the real
``params_zs`` weights on the demo frame.

Where the packages round differently upstream, the later stage is also fed
the JAX stage's own numpy outputs, so that each stage is held to what it
can reach:

- KNN neighbour sets differ at the k-th distance (float32 expansion of
  ``|p-q|²`` at ~1 m, XLA's and MKL's products rounding apart), which moves
  a few normals, hence a few degenerate-pair decisions and network inputs;
- float32 sums run in another order (``index_add_`` against a scatter,
  MKL against XLA).

Whole-slice tolerances: the same detection count; T within ``res`` (one
voxel: a heatmap peak can move one voxel when two near-tied voxels swap);
up within 2° (the axis sphere's bin spacing is 2°); instance masks agree on
≥ 95 % of the points (a membership count near ``contrib_thresh`` flips with
the pairs that moved).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cppf_tpu.config import load_config as jax_load_config
from cppf_tpu.data import native
from cppf_tpu.data.shapenet import TRAIN_INTRINSICS
from cppf_tpu.eval import anchor as jax_anchor
from cppf_tpu.eval import zero_shot as jz
from cppf_tpu.ops import ransac as jax_ransac
from cppf_tpu.ops import voting as jv
from cppf_tpu_torch.config import load_config
from cppf_tpu_torch.core.geometry import backproject, fibonacci_sphere
from cppf_tpu_torch.eval import anchor
from cppf_tpu_torch.eval import zero_shot as tz
from cppf_tpu_torch.ops import quantize, ransac
from cppf_tpu_torch.ops import voting as tv
from test_zero_shot import _box_surface, _oracle_predict, _two_object_depth

torch.set_num_threads(1)

RES = 4e-3


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _frame_cloud():
    depth, _, _ = _two_object_depth()
    pc, _ = backproject(depth, TRAIN_INTRINSICS, depth > 0)
    return depth, (pc / 1000.0).astype(np.float32)


def test_backproject_matches():
    depth, _, _ = _two_object_depth()
    mask = depth > 0
    got, (rows, cols) = backproject(depth, TRAIN_INTRINSICS, mask)
    from cppf_tpu.core.geometry import backproject as jax_backproject

    want, (rows_j, cols_j) = jax_backproject(depth, TRAIN_INTRINSICS, mask)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rows, rows_j)
    np.testing.assert_array_equal(cols, cols_j)


@pytest.mark.parametrize("res", [RES, 4 * RES])
def test_voxel_downsample_host_equals_native(res):
    _, pc = _frame_cloud()
    want = native.voxel_downsample_host(pc, res)
    got = quantize.voxel_downsample_host(pc, res)
    assert got.dtype == np.int32 and len(got) > 100
    np.testing.assert_array_equal(got, want)


def _pairs(seed=0, n=300, p=4000):
    """A cloud with pair predictions that vote for one center, plus a few
    degenerate pairs."""
    rng = np.random.default_rng(seed)
    pc = (rng.normal(size=(n, 3)) * 0.05 + [0.1, -0.05, 1.2]).astype(np.float32)
    idxs = rng.integers(0, n, (p, 2)).astype(np.int32)
    idxs[:5, 1] = idxs[:5, 0]
    center = np.float32([0.11, -0.04, 1.21])
    a, b = pc[idxs[:, 0]], pc[idxs[:, 1]]
    d = (a - b) / (np.linalg.norm(a - b, axis=-1, keepdims=True) + 1e-7)
    proj = np.sum((a - center) * d, -1)
    odist = np.linalg.norm(a - center - proj[:, None] * d, axis=-1)
    noise = rng.normal(size=(2, p)) * 0.01
    preds_tr = np.stack([proj + noise[0], odist + noise[1]], -1).astype(np.float32)
    return pc, idxs, preds_tr, center


@pytest.mark.parametrize("tol", [RES, 3 * RES])
def test_circle_support_equal(tol):
    pc, idxs, preds_tr, center = _pairs()
    want = np.asarray(jv.circle_support(*(jnp.asarray(a) for a in (pc, preds_tr, idxs, center)),
                                        tol))
    got = tv.circle_support(*_t(pc, preds_tr, idxs, center), tol, chunk=1000).numpy()
    assert 0.05 < want.mean() < 0.95
    np.testing.assert_array_equal(got, want)


def test_rot_vote_and_sphere_bin_count():
    """Candidate axes agree to float32 rounding (XLA's and PyTorch's tan and
    sin/cos differ in the last bit).  Counts are equal but for candidates
    whose cosine lies within 1e-5 of the threshold."""
    pc, idxs, _, _ = _pairs(1, p=600)
    rng = np.random.default_rng(1)
    angles = rng.uniform(0, np.pi, len(idxs)).astype(np.float32)
    want = np.asarray(jv.rot_vote(jnp.asarray(pc), jnp.asarray(angles), jnp.asarray(idxs),
                                  n_rots=36))
    got = tv.rot_vote(*_t(pc, angles, idxs), n_rots=36, chunk=250).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert np.all(got[:5] == 0)

    sphere = fibonacci_sphere(int(4 * np.pi / np.deg2rad(2.0))).astype(np.float32)
    cos_tol = np.cos(np.deg2rad(2.0))
    cands = want.reshape(-1, 3)
    c_j = np.asarray(jv.sphere_bin_count(jnp.asarray(cands), jnp.asarray(sphere), cos_tol))
    c_t = tv.sphere_bin_count(*_t(cands, sphere), cos_tol, chunk=5000).numpy()
    assert c_j.sum() > 1000
    near = np.abs(cands.astype(np.float64) @ sphere.T.astype(np.float64) - cos_tol) < 1e-5
    assert np.all(np.abs(c_t - c_j) <= near.sum(0))
    assert np.mean(c_t == c_j) > 0.98


def _scene(rng):
    """tests/test_zero_shot.py's table and cylinder."""
    table = np.stack([rng.uniform(-0.5, 0.5, 3000),
                      np.full(3000, 0.0) + rng.normal(0, 0.002, 3000),
                      rng.uniform(0.8, 1.8, 3000)], -1).astype(np.float32)
    theta = rng.uniform(0, 2 * np.pi, 800)
    cyl = np.stack([0.08 * np.cos(theta), rng.uniform(0.0, 0.2, 800),
                    1.2 + 0.08 * np.sin(theta)], -1).astype(np.float32)
    return np.concatenate([table, cyl]), cyl


def _jax_uniforms(seed, rounds=2):
    return np.stack([np.asarray(jax.random.uniform(jax.random.PRNGKey(seed + k), (200, 3)))
                     for k in range(rounds)])


@pytest.mark.parametrize("seed", [0, 3])
def test_segment_plane_matches(rng, seed):
    pc, _ = _scene(rng)
    plane_j, mask_j = jax_ransac.segment_plane(jax.random.PRNGKey(seed), jnp.asarray(pc), 0.008,
                                               num_iterations=200)
    plane_t, mask_t = ransac.segment_plane(torch.from_numpy(_jax_uniforms(seed, 1)[0]),
                                           torch.from_numpy(pc), 0.008)
    np.testing.assert_allclose(plane_t.numpy(), np.asarray(plane_j), atol=1e-5)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))


def test_scene_planes_match(rng):
    scene, cyl = _scene(rng)
    for pc in (scene, cyl):
        want = jz.scene_planes(pc)
        got = tz.scene_planes(torch.from_numpy(pc), uniforms=_jax_uniforms(0))
        np.testing.assert_array_equal(got, want)
    # the default draws are JAX's: the same mask as JAX's
    got = tz.scene_planes(torch.from_numpy(scene))
    np.testing.assert_array_equal(got, jz.scene_planes(scene))
    assert got[:3000].mean() > 0.9 and got[3000:].mean() < 0.3


def test_extract_proposals_host_matches(rng):
    grid = rng.random((40, 36, 30)).astype(np.float32)
    grid[10, 10, 10] += 5000.0
    grid[30, 25, 20] += 4500.0
    grid[22, 5, 25] += 4000.0
    corner = np.float32([0.1, -0.2, 1.0])
    want = jz.extract_proposals_host(grid, corner, 0.01, thresh=10.0, margin=5)
    got = tz.extract_proposals_host(grid, corner, 0.01, thresh=10.0, margin=5)
    assert len(want) == 3
    assert len(got) == len(want)
    for (cg, dg), (cw, dw) in zip(got, want):
        np.testing.assert_array_equal(cg, cw)
        assert dg == dw


def test_filter_degenerate_pairs_matches(rng):
    pc = rng.uniform(-1, 1, (60, 3)).astype(np.float32)
    pc[:30, 2] = 0.0
    nrm = rng.normal(size=(60, 3)).astype(np.float32)
    nrm[:30] = [0, 0, 1]
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    idxs = rng.integers(0, 60, (500, 2))
    want = jz.filter_degenerate_pairs(pc, nrm, idxs)
    got = tz.filter_degenerate_pairs(*_t(pc, nrm, idxs)).numpy()
    assert 0 < len(want) < 500
    np.testing.assert_array_equal(got, want)


def test_anchor_box_t_matches(rng):
    center = np.array([0.1, -0.2, 1.2])
    th = 0.4
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
    scale = np.array([0.16, 0.05, 0.14])
    pts = _box_surface(center, R, scale, rng=rng)
    front = pts[pts[:, 2] <= center[2]]
    T = center + np.array([0.02, -0.025, 0.018])
    for points in (pts, front, front[front[:, 0] >= center[0] - 0.02], np.zeros((3, 3))):
        np.testing.assert_array_equal(anchor.anchor_box_t(T, R, scale * 0.9, points),
                                      jax_anchor.anchor_box_t(T, R, scale * 0.9, points))


def _assert_detections_close(got, want, res, min_mask=0.95):
    assert len(got) == len(want) >= 1, (len(got), len(want))
    for g, w in zip(got, want):
        assert np.linalg.norm(g.T - w.T) <= res, (g.T, w.T)
        up = float(np.degrees(np.arccos(np.clip(g.R[:, 1] @ w.R[:, 1], -1, 1))))
        assert up <= 2.0, up
        assert np.mean(g.mask == w.mask) >= min_mask
        np.testing.assert_allclose(g.scale, w.scale, rtol=0.02)


def _heatmap_from_jax(hm):
    return tz.HeatmapState(*_t(hm.pc, hm.pc_normal, hm.point_idxs,
                               np.asarray(hm.preds, np.float32)), hm.grid, hm.corner, hm.dims)


def test_oracle_frame_slice_matches():
    """The whole slice with the oracle network on the two-can frame, 50 000
    pairs, 36 rotations."""
    cfg_j = jax_load_config("can")
    cfg_t = load_config("can")
    depth, centers, _ = _two_object_depth()
    kw = dict(intrinsics=TRAIN_INTRINSICS, n_pairs=50000, num_rots=36, seed=0)
    predict = _oracle_predict(centers, cfg_j)
    hm_j = jz.zero_shot_heatmap(depth, None, cfg_j, predict_fn=predict, **kw)
    hm_t = tz.zero_shot_heatmap(depth, None, cfg_t, predict_fn=predict, device="cpu", **kw)

    # stage 1: the same clouds (the voxel downsample is exact) and draws
    np.testing.assert_array_equal(hm_t.pc.numpy(), hm_j.pc)
    normal_ok = np.abs(np.sum(hm_t.pc_normal.numpy() * hm_j.pc_normal, -1)) > 1 - 1e-4
    assert normal_ok.mean() > 0.98
    assert abs(len(hm_t.point_idxs) - len(hm_j.point_idxs)) <= 0.001 * len(hm_j.point_idxs)

    # stage 3 on the JAX stage's pairs and predictions
    grid, corner, dims = tz.frame_heatmap(*_t(hm_j.pc, np.asarray(hm_j.preds[:, :2]),
                                              hm_j.point_idxs), cfg_t.res, 36, pair_chunk=20000)
    np.testing.assert_array_equal(corner, hm_j.corner)
    np.testing.assert_array_equal(dims, hm_j.dims)
    np.testing.assert_allclose(grid, hm_j.grid, atol=1e-4 * hm_j.grid.max(), rtol=0)

    # stage 4 on the JAX heatmap, then the whole slice
    plane_u = _jax_uniforms(0)
    det_kw = dict(num_rots=36, prop_thresh=5.0, seed=0)
    want = jz.detect_from_heatmap(hm_j, cfg_j, **det_kw)
    assert len(want) >= 2
    _assert_detections_close(tz.detect_from_heatmap(_heatmap_from_jax(hm_j), cfg_t,
                                                    plane_u=plane_u, **det_kw), want, cfg_t.res)
    got = tz.detect_from_heatmap(hm_t, cfg_t, plane_u=plane_u, **det_kw)
    _assert_detections_close(got, want, cfg_t.res)


def test_sparse_heatmap_matches_jax_and_dense(rng):
    """The sparse route on tests/test_zero_shot.py's fixture: its grid equals
    JAX's sparse grid (interpret-mode Pallas) to 1e-4 of the maximum, and
    its proposals equal the dense route's at that test's tolerances."""
    cfg = jax_load_config("can")
    res = 16e-3
    depth, centers, _ = _two_object_depth()
    pc_full, _ = backproject(depth, TRAIN_INTRINSICS, depth > 0)
    pc_full = pc_full / 1000.0
    pc_full[:, :2] = -pc_full[:, :2]
    pc = pc_full[rng.choice(len(pc_full), 1500, replace=False)].astype(np.float32)
    n = len(pc)
    idxs = rng.integers(0, n, (4000, 2)).astype(np.int32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    preds_tr = _oracle_predict(centers, cfg)(pc, nrm, idxs)[:, :2].astype(np.float32)
    corner = pc.min(0)
    dims = ((pc.max(0) - corner) / res).astype(np.int32) + 1
    kw = dict(num_rots=12, n_cands=6, window=16, coarse_pool=4, pair_budget=4096)
    want = jz._sparse_frame_grid(pc, preds_tr, idxs, corner, dims, res, **kw)
    got = tz._sparse_frame_grid(*_t(pc, preds_tr, idxs), corner, dims, res, pair_chunk=1000,
                                **kw)
    np.testing.assert_allclose(got, want, atol=1e-4 * want.max(), rtol=0)

    dense, _, _ = tz.frame_heatmap(*_t(pc, preds_tr, idxs), res, 12)
    p_dense = tz.extract_proposals_host(dense, corner, res, thresh=10.0)
    p_sparse = tz.extract_proposals_host(got, corner, res, thresh=10.0)
    assert len(p_dense) == len(p_sparse) >= 2
    for (cd, dd), (cs, ds) in zip(p_dense, p_sparse):
        np.testing.assert_allclose(cd, cs, atol=2 * res)
        np.testing.assert_allclose(dd, ds, rtol=0.05)
