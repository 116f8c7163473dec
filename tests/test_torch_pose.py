"""The port's bowl slice as a whole against cppf_tpu's estimate_pose, the
port's PoseConfig against the JAX one, and oracle pose recovery.

Both pipelines get the same cloud, neighbours and weights, and the same
random draws (``torch_slices``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from cppf_tpu.config import load_config as load_config_j
from cppf_tpu.data.synthetic import PRIMITIVES, mesh_bounds, oracle_pair_predictions, sample_surface
from cppf_tpu.pipeline.pose import PoseConfig as PoseConfigJ
from cppf_tpu_torch.config import load_config
from cppf_tpu_torch.pipeline.pose import PoseConfig, PoseDraws, vote_pose
from cppf_tpu_torch.pipeline.preprocess import preprocess_cloud
from torch_slices import assert_slices_match, run_slice, runner_configs

torch.set_num_threads(1)

CATEGORIES = ("bowl", "bottle", "can", "camera", "mug", "laptop", "sofa", "chair", "bed",
              "bathtub", "bookshelf", "table")


def test_pose_config_matches_jax():
    """Every category's config, built as the runners build it, gives the
    JAX PoseConfig's values for every field the port has."""
    grids = {}
    for cat in CATEGORIES:
        cfg_j, cfg_t = runner_configs(cat)
        pj, pt = PoseConfigJ.from_config(cfg_j), PoseConfig.from_config(cfg_t)
        for f in dataclasses.fields(pt):
            assert getattr(pt, f.name) == getattr(pj, f.name), (cat, f.name)
        np.testing.assert_array_equal(pt.sphere_points(), pj.sphere_points())
        grids[cat] = pt.grid_shape[0]
    assert grids["bottle"] == 120 and grids["can"] == 56 and grids["bookshelf"] == 152
    assert len(PoseConfig.from_config(load_config("bowl")).sphere_points()) == 480
    # the gravity prior: off in every config, set by the SUN driver alone
    names = {f.name for f in dataclasses.fields(PoseConfig)}
    assert {"up_prior_deg", "up_prior_dir"} <= names
    assert (pt.up_prior_deg, pt.up_prior_dir) == (pj.up_prior_deg, pj.up_prior_dir) == (
        0.0, (0.0, 1.0, 0.0))
    sun_t = dataclasses.replace(pt, scale_multiplier=1.0, up_prior_deg=30.0)
    sun_j = dataclasses.replace(pj, scale_multiplier=1.0, up_prior_deg=30.0)
    for f in dataclasses.fields(sun_t):
        assert getattr(sun_t, f.name) == getattr(sun_j, f.name), f.name


@pytest.mark.parametrize("flag,value", [("coplanar_halfspace", True), ("subvoxel_refine", True)])
def test_flag_config_and_slice(flag, value):
    """Two flags that no config turns on, which the port once refused:
    from_config takes each on mug's runner config as JAX's does (every
    field equal), and mug's slice with it on view 0 matches JAX's (T the
    same voxel, or with subvoxel_refine within 2e-6; axes 1e-6)."""
    cfg_j, cfg = runner_configs("mug")
    setattr(cfg, flag, value)
    setattr(cfg_j, flag, value)
    pj, pt = PoseConfigJ.from_config(cfg_j), PoseConfig.from_config(cfg)
    assert getattr(pt, flag) == value
    for f in dataclasses.fields(pt):
        assert getattr(pt, f.name) == getattr(pj, f.name), f.name
    out_j, out_t, sphere, draws = run_slice("mug", 0, 7, flags={flag: value})
    assert_slices_match(out_j, out_t, sphere, draws, regress_right=True,
                        subvoxel=flag == "subvoxel_refine")


@pytest.mark.parametrize("view,seed", [(0, 7), (2, 11)])
def test_bowl_slice_matches_jax(view, seed):
    """Bowl checkpoint at a small size (512 points, knn 16, 2048 pairs) on a
    committed rendered view: T to 1e-6 (the same voxel), the same up sphere
    point, scale to rtol 1e-5, back-vote survivors within 0.1 %."""
    assert_slices_match(*run_slice("bowl", view, seed))


def _posed_instance(rng, category, n=4000):
    """As tests/test_pipeline.py::_posed_instance."""
    mesh = PRIMITIVES[category]()
    pc_canon = sample_surface(mesh, n, rng)
    ang = np.deg2rad(40.0)
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]],
                 np.float32) @ np.array([[1, 0, 0], [0, np.cos(0.5), -np.sin(0.5)],
                                         [0, np.sin(0.5), np.cos(0.5)]], np.float32)
    T = np.array([0.15, -0.08, 0.75], np.float32)
    return mesh, (pc_canon @ R.T + T).astype(np.float32), R, T


@pytest.mark.parametrize("category", ["bottle", "bowl"])
def test_oracle_pose_recovery(category):
    """vote_pose with ground-truth pair predictions recovers T within the
    voxel tolerance, the up axis within the sphere tolerance, and the scale
    (mirrors tests/test_pipeline.py::test_oracle_pose_recovery)."""
    rng = np.random.default_rng(0)
    cfg_j = load_config_j(category)
    cfg = load_config(category)
    mesh, pc_cam, R_true, T_true = _posed_instance(rng, category)
    lo, hi = mesh_bounds(mesh)
    bound = (hi - lo).copy()
    bound[[0, 2]] = bound[[2, 0]]  # NOCS x/z swap

    pad = np.zeros((4096, 3), np.float32)
    pad[:4000] = pc_cam
    pre = preprocess_cloud(torch.from_numpy(pad), 4000, cfg.res, npoint_pad=2048, knn=cfg.knn,
                           jitter=False)
    n = int(pre.n_valid)
    pcfg = PoseConfig.from_config(cfg, n_pairs=20000)
    idxs = rng.integers(0, n, size=(20000, 2)).astype(np.int32)
    preds = oracle_pair_predictions(pre.pc.numpy(), pre.normals.numpy(), idxs, T_true, R_true,
                                    bound, 1.0, cfg_j)
    draws = PoseDraws.sample(pcfg, torch.Generator().manual_seed(2), "cpu")
    res = vote_pose(pre.pc, pre.normals, torch.from_numpy(idxs), torch.from_numpy(preds),
                    pre.n_valid, torch.from_numpy(pcfg.sphere_points()), pcfg, draws)
    T_err = np.linalg.norm(res.T.numpy() - T_true)
    assert T_err < 2.5 * cfg.res, f"T err {T_err}"
    cos_up = float(res.up.numpy() @ (R_true @ np.array([0, 1.0, 0])))
    if cfg.up_sym:
        cos_up = abs(cos_up)
    assert cos_up > np.cos(np.deg2rad(5)), f"up axis cos {cos_up}"
    np.testing.assert_allclose(res.scale.numpy(), bound, rtol=0.05)
    assert int(res.n_filtered) > 0.3 * 20000
