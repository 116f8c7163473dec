"""Shared setup of the port's pose-slice tests: the same cloud, neighbours,
weights and random draws through cppf_tpu's estimate_pose and the port's.

The draws are the JAX ones, made with estimate_pose's own key splits
(pipeline/pose.py:794, :533, :544, :315) and handed to the port.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cppf_tpu.config import load_config as load_config_j
from cppf_tpu.pipeline.pose import PoseConfig as PoseConfigJ
from cppf_tpu.pipeline.pose import estimate_pose as estimate_pose_j
from cppf_tpu.pipeline.preprocess import preprocess_cloud as preprocess_j
from cppf_tpu.train.checkpoints import load_params
from cppf_tpu_torch.config import load_config
from cppf_tpu_torch.core.geometry import orthonormal_right
from cppf_tpu_torch.eval.nocs_inference import OVERLAY
from cppf_tpu_torch.models.convert import ASSETS, load_encoders, load_npz_params
from cppf_tpu_torch.pipeline.pose import AxisDraws, PoseConfig, PoseDraws, estimate_pose

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(knn=16, rot_subsample=2048)
N_PAIRS = 2048
N_POINTS = 512


def t(a):
    return torch.from_numpy(np.array(a))


def runner_configs(category):
    """(JAX Config, port Config) as each package's CategoryRunner builds
    them: the training-time snapshot with the repo config's inference flags
    overlaid."""
    snap = os.path.join(ROOT, "checkpoints", category, "config.yaml")
    cfg_j, cfg_t = load_config_j(category, snapshot=snap), load_config(category, snapshot=snap)
    repo_j, repo_t = load_config_j(category), load_config(category)
    for k in OVERLAY:
        setattr(cfg_j, k, getattr(repo_j, k))
        setattr(cfg_t, k, getattr(repo_t, k))
    return cfg_j, cfg_t


def _axis_draws(key, pcfg):
    rng_bin, rng_sub = jax.random.split(key)
    return AxisDraws(t(jax.random.uniform(rng_sub, (pcfg.rot_subsample,))),
                     t(jax.random.gumbel(rng_bin, (pcfg.rot_subsample, pcfg.rot_num_bins))))


def jax_draws(key, pcfg):
    """The draws estimate_pose makes from ``key``, as a PoseDraws."""
    rng_pairs, rng_vote = jax.random.split(key)
    pair_u = jax.random.uniform(rng_pairs, (pcfg.n_pairs, 2))
    rng_tr, rng_up, rng_right, rng_fallback = jax.random.split(rng_vote, 4)
    rng_tr0, rng_tr1 = jax.random.split(rng_tr)
    tr = [jax.random.gumbel(k, (pcfg.n_pairs, pcfg.tr_num_bins)) for k in (rng_tr0, rng_tr1)]
    return PoseDraws(
        pair_u=t(pair_u), tr_gumbel=t(jnp.stack(tr)), up=_axis_draws(rng_up, pcfg),
        fallback_normal=t(jax.random.normal(rng_fallback, (3,), jnp.float32)),
        right=_axis_draws(rng_right, pcfg) if pcfg.regress_right else None)


def view(category, i):
    """(raw cloud, the view's npz) of committed view ``i``."""
    z = np.load(os.path.join(ASSETS, f"{category}_views.npz"))
    return z[f"pc_{i}"], z


def preprocess(raw, res, n_points=N_POINTS, n_max=10000):
    pad = np.zeros((max(n_max, len(raw)), 3), np.float32)
    pad[: len(raw)] = raw
    return preprocess_j(jax.random.PRNGKey(0), jnp.asarray(pad), len(raw), res,
                        npoint_pad=n_points, knn=SMALL["knn"], jitter=False)


def small_configs(category):
    """(JAX PoseConfig, port PoseConfig, port Config) at the test size."""
    cfg_j, cfg_t = runner_configs(category)
    pcfg_j = dataclasses.replace(PoseConfigJ.from_config(cfg_j, n_pairs=N_PAIRS), **SMALL)
    pcfg_t = dataclasses.replace(PoseConfig.from_config(cfg_t, n_pairs=N_PAIRS), **SMALL)
    return pcfg_j, pcfg_t, cfg_t


def run_slice(category, i, seed, laptop_up=None, eager=False, n_points=N_POINTS, flags=None):
    """Committed view ``i`` of ``category`` at the test size through both
    pipelines on identical draws: (JAX PoseResult, port PoseResult, sphere,
    the draws).  ``eager`` runs the JAX pipeline op by op (``disable_jit``)
    instead of as one compiled program; ``flags`` are set on both
    PoseConfigs."""
    raw, _ = view(category, i)
    pcfg_j, pcfg_t, cfg = small_configs(category)
    if flags:
        pcfg_j = dataclasses.replace(pcfg_j, **flags)
        pcfg_t = dataclasses.replace(pcfg_t, **flags)
    pre = preprocess(raw, cfg.res, n_points)
    sphere = pcfg_t.sphere_points()
    params = load_params(os.path.join(ROOT, "checkpoints", category), "params_best")
    key = jax.random.PRNGKey(seed)
    kw_j, kw_t = {}, {}
    if laptop_up is not None:
        kw_j = dict(laptop_up=jnp.asarray(laptop_up), laptop_up_valid=jnp.asarray(True))
        kw_t = dict(laptop_up=torch.from_numpy(laptop_up), laptop_up_valid=True)
    with jax.disable_jit(eager):
        out_j = estimate_pose_j(key, params["point"], params["ppf"], pre.pc, pre.normals,
                                pre.n_valid, jnp.asarray(sphere), pcfg_j, nbr_idx=pre.nbr_idx,
                                **kw_j)
    weights = load_npz_params(os.path.join(ASSETS, f"{category}_params_best.npz"))
    point, ppf = load_encoders(weights, cfg.out_dim, "cpu")
    draws = jax_draws(key, pcfg_t)
    out_t = estimate_pose(point, ppf, t(pre.pc), t(pre.normals), t(pre.n_valid),
                          torch.from_numpy(sphere), pcfg_t, nbr_idx=t(pre.nbr_idx),
                          draws=draws, **kw_t)
    return out_j, out_t, sphere, draws


def on_sphere(v, sphere, tol=1e-6):
    """Whether ``v`` is ± a sphere direction."""
    near = np.all(np.abs(sphere - v) < tol, -1) | np.all(np.abs(sphere + v) < tol, -1)
    return bool(np.any(near))


def right_from_sphere(right, up, sphere, fallback, tol=1e-6):
    """Whether ``right`` is ± a sphere direction made orthonormal to ``up``
    (by the port's own float32 ``orthonormal_right``: near ``up`` the
    projection is ill-conditioned), or, where the voted right was ± up, the
    fallback normal made orthonormal to it."""
    up = torch.from_numpy(up)
    cands = [torch.from_numpy(sign * d) for d in sphere for sign in (1, -1)] + [fallback]
    return any(np.all(np.abs(orthonormal_right(up, c).numpy() - right) < tol) for c in cands)


# a sub-voxel T (subvoxel_refine) is continuous: its Gauss-Newton sums run
# in another order than XLA's
SUBVOXEL_T_TOL = 2e-6


def assert_slices_match(out_j, out_t, sphere, draws, regress_right=False, laptop_up=None,
                        min_survivors=100, subvoxel=False):
    """T to 1e-6 (the same voxel; with ``subvoxel``, to
    ``SUBVOXEL_T_TOL``), up and right to 1e-6, scale to rtol 1e-5,
    back-vote survivors within 0.1 % (and at least ``min_survivors``).
    The up axis is a sphere direction (or the plane override's
    ``laptop_up``), and a regressed right axis one made orthonormal to it
    (or the override's)."""
    np.testing.assert_allclose(out_t.T.numpy(), np.asarray(out_j.T),
                               atol=SUBVOXEL_T_TOL if subvoxel else 1e-6)
    np.testing.assert_allclose(out_t.up.numpy(), np.asarray(out_j.up), atol=1e-6)
    np.testing.assert_allclose(out_t.right.numpy(), np.asarray(out_j.right), atol=1e-6)
    np.testing.assert_allclose(out_t.R.numpy(), np.asarray(out_j.R), atol=1e-6)
    np.testing.assert_allclose(out_t.scale.numpy(), np.asarray(out_j.scale), rtol=1e-5)
    up = out_t.up.numpy()
    if laptop_up is None or not np.allclose(up, laptop_up, atol=1e-6):
        assert on_sphere(up, sphere)
        if regress_right:
            assert right_from_sphere(out_t.right.numpy(), up, sphere, draws.fallback_normal)
    n_j = int(out_j.n_filtered)
    assert n_j >= min_survivors
    assert abs(int(out_t.n_filtered) - n_j) <= 0.001 * n_j
