"""bench.py's main cell in the port (cppf_tpu_torch/scripts/bench_cell.py)
against the JAX package: the cloud, its preprocessing, the draws of the
bench's keys, and the poses at the network's full width, against live JAX
at 20 000 pairs and against JAX's stored estimates at the bench's 100 000
(assets/bench_cell.npz, from scripts/export_torch_bench_cell.py), each
held by phase 21's rule (chip_smoke.hold_bench_pose).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cppf_tpu.config import load_config as load_config_j
from cppf_tpu.data.synthetic import PRIMITIVES as PRIMITIVES_J
from cppf_tpu.data.synthetic import sample_surface as sample_surface_j
from cppf_tpu.pipeline.pose import PoseConfig as PoseConfigJ
from cppf_tpu.pipeline.pose import estimate_pose as estimate_pose_j
from cppf_tpu.pipeline.preprocess import preprocess_cloud as preprocess_j
from cppf_tpu.train.checkpoints import load_params
from cppf_tpu_torch.core import threefry
from cppf_tpu_torch.models.convert import ASSETS
from cppf_tpu_torch.pipeline.pose import estimate_pose
from cppf_tpu_torch.scripts import bench_cell as bc
from torch_slices import ROOT, jax_draws

torch.set_num_threads(1)

LIVE_PAIRS = 20000
DRAW_PAIRS = 2048  # the draws' hash is elementwise: a prefix of the bench's own


@pytest.fixture(scope="module")
def stored():
    return np.load(os.path.join(ASSETS, "bench_cell.npz"))


@pytest.fixture(scope="module")
def inputs():
    """The port's cell on the CPU at LIVE_PAIRS pairs."""
    return bc.bench_inputs("cpu", LIVE_PAIRS)


@pytest.fixture(scope="module")
def jax_cell():
    """bench.py's own cloud, preprocess and weights in the JAX package:
    (config, preprocessed cloud, params, sphere)."""
    cfg = load_config_j("bottle")
    pad, n_raw = bc.bench_cloud()
    pre = preprocess_j(jax.random.PRNGKey(0), jnp.array(pad), n_raw, cfg.res, npoint_pad=4096,
                       knn=cfg.knn)
    params = load_params(os.path.join(ROOT, "checkpoints", "bottle"), name="params_best")
    sphere = jnp.array(PoseConfigJ.from_config(cfg).sphere_points())
    return cfg, pre, params, sphere


def test_cell_needs_cuda_unless_told_cpu():
    """``python -m cppf_tpu_torch.scripts.bench_cell`` runs on the card
    unless ``--device cpu`` is given, and never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bc.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        bc.bench_inputs()


def test_bench_cloud_is_bench_pys():
    """bench.py:222-225 with the JAX package's sampler, to the bit."""
    rng = np.random.default_rng(0)
    pc_cam = sample_surface_j(PRIMITIVES_J["bottle"](), 8000, rng) + np.float32([0.1, -0.05, 0.7])
    pad = np.zeros((8192, 3), np.float32)
    pad[:8000] = pc_cam
    got, n_raw = bc.bench_cloud()
    assert n_raw == 8000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, pad)


def test_preprocessed_cloud_matches_jax(inputs, jax_cell):
    """JAX's preprocess_cloud(PRNGKey(0), ...) at npoint_pad 4096, knn 60:
    the same points kept, their coordinates within 1e-6 (the jitter's
    erfinv may round otherwise in the last bit), normals within 1e-4."""
    _, pre_j, _, _ = jax_cell
    pre = inputs.pre
    assert int(pre.n_valid) == int(pre_j.n_valid) == 3171
    np.testing.assert_array_equal(pre.raw_idx.numpy(), np.asarray(pre_j.raw_idx))
    np.testing.assert_allclose(pre.pc.numpy(), np.asarray(pre_j.pc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pre.normals.numpy(), np.asarray(pre_j.normals), rtol=0,
                               atol=1e-4)


def test_batch_draws_are_jax_draws(inputs, stored):
    """The bench's keys remade in torch: the jitter of the cloud and of the
    batch's rows (split(PRNGKey(3), 8)[:4]) and the pose draws of the
    batch's first dispatch (split(PRNGKey(200), 4)) equal jax.random's
    (uniforms to the bit; the Gumbel and normal transforms within 1e-6);
    the batch's rows keep JAX's point counts."""
    pre_keys = jax.random.split(jax.random.PRNGKey(3), 8)[:4]
    want = [jax.random.normal(jax.random.PRNGKey(0), (8192, 3))]
    want += [jax.random.normal(k, (8192, 3)) for k in pre_keys]
    keys = [threefry.key(0)] + threefry.split(threefry.key(3), 8)[:4]
    for got, w in zip(bc._jitter(keys, "cpu"), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    pcfg = dataclasses.replace(bc.mode_config(inputs, "nearest"), n_pairs=DRAW_PAIRS)
    pose_keys = jax.random.split(jax.random.PRNGKey(200), 4)
    for k_t, k_j in zip(threefry.split(threefry.key(200), 4), pose_keys):
        assert k_t == tuple(int(w) for w in jax.random.key_data(k_j))
        got, want = bc.pose_draws(pcfg, k_t, "cpu"), jax_draws(k_j, pcfg)
        np.testing.assert_array_equal(got.pair_u.numpy(), want.pair_u.numpy())
        np.testing.assert_array_equal(got.up.sub_u.numpy(), want.up.sub_u.numpy())
        for a, b in ((got.tr_gumbel, want.tr_gumbel), (got.up.gumbel, want.up.gumbel),
                     (got.fallback_normal, want.fallback_normal)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
    assert bc.batch_cloud(torch.device("cpu")).n_valid.tolist() == \
        stored["batch_n_valid"].tolist()


def _tie_record(jax_cell, pcfg_j, key, T_j):
    """A pose's fields as ``hold_bench_pose`` reads them from the stored
    file, with JAX's grid read off live (scripts/export_torch_bench_cell.py)."""
    import sys

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from export_torch_bench_cell import center_grid

    _, pre, params, _ = jax_cell
    grid, corner = center_grid(key, params, pre.pc, pre.normals, pre.n_valid, pre.nbr_idx,
                               pcfg_j)
    voxel = np.rint((T_j - corner) / np.float32(pcfg_j.res)).astype(np.int32)
    return dict(voxel=voxel, grid_peak=np.float32(grid.max()),
                voxel_value=np.float32(grid[tuple(voxel)]),
                n_ties=np.int32((grid == grid.max()).sum()),
                ties=np.argwhere(grid == grid.max()).astype(np.int32)[:64])


@pytest.mark.parametrize("mode", bc.MODES)
def test_pose_matches_live_jax(inputs, jax_cell, mode):
    """The cell at the network's full width with 20 000 pairs, ``mode``
    splat, on the draws of PRNGKey(10): the port's pose_cell against JAX's
    estimate_pose by phase 21's rule (T the same voxel or a tie, up within
    1° up to sign or a near tie, scale within 1e-4)."""
    cfg, pre, params, sphere = jax_cell
    pcfg_j = dataclasses.replace(PoseConfigJ.from_config(cfg, n_pairs=LIVE_PAIRS), splat=mode)
    key = jax.random.PRNGKey(10)
    out_j = estimate_pose_j(key, params["point"], params["ppf"], pre.pc, pre.normals,
                            pre.n_valid, sphere, pcfg_j, nbr_idx=pre.nbr_idx)
    z = {f"live_{f}": np.asarray(getattr(out_j, f))
         for f in ("T", "up", "scale", "n_filtered", "grid_max")}
    (out,) = bc.pose_cell(mode, [threefry.key(10)], inputs=inputs)
    if np.abs(out.T.numpy() - z["live_T"]).max() > chip_smoke.BENCH_T_TOL:
        z.update({f"live_{k}": v for k, v in
                  _tie_record(jax_cell, pcfg_j, key, z["live_T"]).items()})
    else:  # JAX's grid is read only where T parts
        pc = np.asarray(pre.pc)[: int(pre.n_valid)]
        z.update(live_voxel=np.rint((z["live_T"] - pc.min(0)) / np.float32(pcfg_j.res))
                 .astype(np.int32),
                 live_n_ties=np.int32(0))
    parts = {"ties": [], "near_ties": []}
    chip_smoke.hold_bench_pose(f"{mode} live", out, z, "live", inputs, mode, threefry.key(10),
                               parts)


@pytest.mark.parametrize("mode", bc.MODES)
def test_full_width_pose_matches_stored(inputs, stored, mode):
    """The bench's own pose at 100 000 pairs, PRNGKey(10), ``mode`` splat
    (the draws made by jax.random, which the port's threefry remakes, as
    test_batch_draws_are_jax_draws holds) against JAX's stored estimate by
    phase 21's rule."""
    full = inputs._replace(pcfg=dataclasses.replace(inputs.pcfg, n_pairs=bc.N_PAIRS))
    pcfg = bc.mode_config(full, mode)
    draws = jax_draws(jax.random.PRNGKey(10), pcfg)
    point, ppf = full.encoders
    pre = full.pre
    out = estimate_pose(point, ppf, pre.pc, pre.normals, pre.n_valid, full.sphere, pcfg,
                        nbr_idx=pre.nbr_idx, draws=draws)
    parts = {"ties": [], "near_ties": []}
    row = chip_smoke.hold_bench_pose(f"{mode} PRNGKey(10)", out, stored, f"{mode}_0", full,
                                     mode, threefry.key(10), parts)
    assert row["voxel"] == stored[f"{mode}_0_voxel"].tolist()
