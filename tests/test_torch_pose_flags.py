"""The pose flags that no category config turns on, against cppf_tpu, at
the pose slices' size (512 points, knn 16, 2048 pairs) on committed views
and JAX's draws (``torch_slices``): ``coplanar_halfspace``,
``pair_balance``, ``pair_sep_power``, ``sharp_axis_votes``,
``aux_align_weight``, ``subvoxel_refine`` and ``center_mode="grid"``, each
alone and in the two sets that ``chip_smoke.py`` phase 16 runs; and their
pieces: the half-space gate of the vote (tests/test_voting.py:364-430),
``center_refine`` (its oracle, tests/test_voting.py:298), the stratified
pair sample and the weighted sphere count.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_slices as ts
from cppf_tpu.ops import voting as jv
from cppf_tpu.pipeline import pose as pose_j
from cppf_tpu_torch.config import load_config
from cppf_tpu_torch.ops import voting as tv
from cppf_tpu_torch.pipeline import pose
from cppf_tpu_torch.pipeline.pose import PoseConfig

torch.set_num_threads(1)

# the flag sets of chip_smoke.py phase 16 and scripts/export_torch_assets.py
# --flags: (name, category, flags)
ALONE = [
    ("halfspace", "sofa", dict(coplanar_halfspace=True)),
    ("balance", "sofa", dict(pair_balance=1.0)),
    ("sep", "sofa", dict(pair_sep_power=2.0)),
    ("grid_halfspace", "sofa", dict(center_mode="grid", coplanar_halfspace=True)),
    ("sharp", "mug", dict(sharp_axis_votes=True)),
    ("align", "mug", dict(aux_align_weight=True)),
    ("subvoxel", "bowl", dict(subvoxel_refine=True)),
    ("grid", "bowl", dict(center_mode="grid")),
]
SETS = [
    ("sofa_set", "sofa", dict(coplanar_halfspace=True, pair_sep_power=2.0, pair_balance=1.0,
                              subvoxel_refine=True)),
    ("mug_set", "mug", dict(sharp_axis_votes=True, aux_align_weight=True,
                            subvoxel_refine=True)),
]
SEED = 7


def assert_flag_slice(category, view, flags):
    """The view through both pipelines with ``flags``
    (``torch_slices.run_slice``), held by ``assert_slices_match``: T the
    same voxel (sub-voxel T to ``SUBVOXEL_T_TOL``), axes to 1e-6, scale
    rtol 1e-5, survivors within 0.1 %."""
    out_j, out_t, sphere, draws = ts.run_slice(category, view, SEED, flags=flags)
    ts.assert_slices_match(out_j, out_t, sphere, draws,
                           regress_right=ts.small_configs(category)[1].regress_right,
                           subvoxel=flags.get("subvoxel_refine", False))


@pytest.mark.parametrize("name,category,flags", ALONE, ids=[a[0] for a in ALONE])
def test_flag_alone_matches_jax(name, category, flags):
    """Each flag alone (and the grid center mode) on view 0
    (``assert_flag_slice``)."""
    assert_flag_slice(category, 0, flags)


@pytest.mark.parametrize("name,category,flags", SETS, ids=[a[0] for a in SETS])
@pytest.mark.parametrize("view", [1, 3])
def test_flag_sets_match_jax(name, category, flags, view):
    """The two combined sets of phase 16 on two more views, as above."""
    assert_flag_slice(category, view, flags)


def test_flags_from_config():
    """PoseConfig.from_config copies every flag as JAX's does; an unknown
    center mode raises."""
    cfg = load_config("mug")
    for k, v in dict(coplanar_halfspace=True, pair_balance=0.5, pair_sep_power=1.5,
                     sharp_axis_votes=True, aux_align_weight=True,
                     subvoxel_refine=True).items():
        setattr(cfg, k, v)
        assert getattr(PoseConfig.from_config(cfg), k) == v
    assert PoseConfig(center_mode="grid").center_mode == "grid"
    with pytest.raises(ValueError, match="center_mode"):
        PoseConfig(center_mode="dense")


# ---- pieces ------------------------------------------------------------------

def _plane_mirror_scene(rng, n=240, p=3000):
    """tests/test_voting.py's table-top scene: every point on the plane
    z = 1 (outward normals -z), the center behind it at z = 1.15, so every
    pair's vote circle also passes the mirror at z = 0.85."""
    xy = rng.uniform(-0.15, 0.15, size=(n, 2)).astype(np.float32)
    pc = np.concatenate([xy, np.ones((n, 1), np.float32)], -1)
    center = np.array([0.0, 0.0, 1.15], np.float32)
    mirror = np.array([0.0, 0.0, 0.85], np.float32)
    idxs = rng.integers(0, n, size=(p, 2)).astype(np.int32)
    a, b = pc[idxs[:, 0]], pc[idxs[:, 1]]
    u = (a - b) / (np.linalg.norm(a - b, axis=-1, keepdims=True) + 1e-7)
    proj = np.sum((a - center) * u, -1)
    odist = np.linalg.norm(a - center - proj[:, None] * u, axis=-1)
    preds_tr = np.stack([proj, odist], -1).astype(np.float32)
    res = 0.01
    corner = np.array([-0.2, -0.2, 0.7], np.float32)
    dims = np.array([41, 41, 61], np.int32)
    n_out = np.tile(np.float32([0.0, 0.0, -1.0]), (p, 1))
    return pc, idxs, preds_tr, corner, res, dims, center, mirror, n_out


def _ball_mass(grid, corner, res, loc, r=3):
    i = np.round((loc - corner) / res).astype(int)
    sl = tuple(slice(max(0, i[k] - r), i[k] + r + 1) for k in range(3))
    return float(grid[sl].sum())


def _hs(pc, idxs, n_out, gate, margin, lib):
    return ((jnp.asarray(pc[idxs[:, 0]]), jnp.asarray(n_out), jnp.asarray(gate), margin)
            if lib is jnp else
            (ts.t(pc[idxs[:, 0]]), ts.t(n_out), ts.t(gate), torch.tensor(margin)))


@pytest.mark.parametrize("dense", [False, True])
def test_halfspace_suppresses_mirror(dense):
    """The gate kills the mirror peak and keeps the true center's mass
    (tests/test_voting.py:364-389), in ppf_vote and in ppf_vote_dense (the
    grid mode's votes front end); the gated grid equals JAX's to 1e-5 of
    its maximum."""
    pc, idxs, preds_tr, corner, res, dims, center, mirror, n_out = \
        _plane_mirror_scene(np.random.default_rng(0))
    gshape = (48, 48, 64)
    args_t = (ts.t(pc), ts.t(preds_tr), torch.ones(pc.shape[0]), ts.t(idxs), ts.t(corner), res,
              ts.t(dims), gshape)
    vote = tv.ppf_vote_dense if dense else tv.ppf_vote
    kw = dict(pair_chunk=1000) if dense else {}
    base = vote(*args_t, n_rots=72, **kw).numpy()
    m_true, m_mirror = (_ball_mass(base, corner, res, c) for c in (center, mirror))
    assert m_mirror > 0.5 * m_true
    gate = np.ones(idxs.shape[0], bool)
    gated = vote(*args_t, n_rots=72, halfspace=_hs(pc, idxs, n_out, gate, 2.0 * res, torch),
                 **kw).numpy()
    assert _ball_mass(gated, corner, res, mirror) < 0.02 * m_mirror
    assert _ball_mass(gated, corner, res, center) > 0.95 * m_true
    t_est = tv.grid_argmax(torch.from_numpy(gated), ts.t(corner), res).numpy()
    assert np.linalg.norm(t_est - center) < 2 * res
    want = np.asarray(jv.ppf_vote(jnp.asarray(pc), jnp.asarray(preds_tr), jnp.ones(pc.shape[0]),
                                  jnp.asarray(idxs), jnp.asarray(corner), res,
                                  jnp.asarray(dims), gshape, n_rots=72, chunk=512,
                                  halfspace=_hs(pc, idxs, n_out, gate, 2.0 * res, jnp)))
    np.testing.assert_allclose(gated, want, atol=1e-5 * want.max())


def test_halfspace_ungated_is_noop():
    """Pairs with the gate off, or a margin of 1e3, vote as without the
    gate, to the bit (tests/test_voting.py:392-410)."""
    pc, idxs, preds_tr, corner, res, dims, *_ = _plane_mirror_scene(np.random.default_rng(1),
                                                                    p=600)
    args = (ts.t(pc), ts.t(preds_tr), torch.ones(pc.shape[0]), ts.t(idxs), ts.t(corner), res,
            ts.t(dims), (48, 48, 64))
    n_ref = np.tile(np.float32([0, 0, -1]), (idxs.shape[0], 1))
    base = tv.ppf_vote(*args, n_rots=24)
    for gate, margin in ((np.zeros(idxs.shape[0], bool), 0.0),
                         (np.ones(idxs.shape[0], bool), 1e3)):
        hs = _hs(pc, idxs, n_ref, gate, margin, torch)
        assert torch.equal(tv.ppf_vote(*args, n_rots=24, halfspace=hs), base)
        assert torch.equal(tv.ppf_vote_dense(*args, n_rots=24, halfspace=hs),
                           tv.ppf_vote_dense(*args, n_rots=24))


@pytest.mark.parametrize("splat", ["trilinear", "nearest"])
def test_peak_under_halfspace_matches_grid(splat):
    """The branch-and-bound peak under the gate is the gated grid's
    maximum, as JAX's is (tests/test_voting.py:413-430): the value to rtol
    2e-5, the voxel holding it."""
    pc, idxs, preds_tr, corner, res, dims, center, _, n_out = \
        _plane_mirror_scene(np.random.default_rng(2), n=120, p=1500)
    gshape = (48, 48, 64)
    hs = _hs(pc, idxs, n_out, np.ones(idxs.shape[0], bool), 2.0 * res, torch)
    args = (ts.t(pc), ts.t(preds_tr), torch.ones(pc.shape[0]), ts.t(idxs), ts.t(corner), res,
            ts.t(dims), gshape)
    grid = tv.ppf_vote(*args, n_rots=24, splat=splat, halfspace=hs).numpy()
    idx, val = tv.ppf_vote_peak(*args, n_rots=24, splat=splat, halfspace=hs)
    np.testing.assert_allclose(float(val), grid.max(), rtol=2e-5)
    np.testing.assert_allclose(grid[tuple(idx.long().numpy())], grid.max(), rtol=2e-5)
    idx_j, val_j = jv.ppf_vote_peak(*(jnp.asarray(np.asarray(a)) for a in args[:5]), res,
                                    jnp.asarray(dims), gshape, n_rots=24, vchunk=8192,
                                    splat=splat, halfspace=_hs(pc, idxs, n_out, np.ones(
                                        idxs.shape[0], bool), 2.0 * res, jnp))
    np.testing.assert_allclose(float(val), float(val_j), rtol=2e-5)
    np.testing.assert_allclose(grid[tuple(np.asarray(idx_j))], grid.max(), rtol=2e-5)


def _oracle_scene(rng):
    """tests/test_voting.py:298's clean circle constraints about o."""
    o = np.array([0.1, -0.05, 0.8], np.float32)
    pc = (rng.standard_normal((1024, 3)) * 0.08 + o).astype(np.float32)
    idxs = rng.integers(0, 1024, size=(8000, 2)).astype(np.int32)
    a, b = pc[idxs[:, 0]], pc[idxs[:, 1]]
    ab = a - b
    abu = ab / (np.linalg.norm(ab, axis=-1, keepdims=True) + 1e-9)
    proj = np.sum((a - o) * abu, -1)
    od = np.linalg.norm((a - o) - proj[:, None] * abu, axis=-1)
    return o, pc, idxs, np.stack([proj, od], -1).astype(np.float32)


def test_center_refine_oracle_and_jax():
    """center_refine recovers the exact center from clean constraints
    (1e-5), stays under 5e-4 with bin-level noise, is the identity below
    min_pairs, and equals JAX's center_refine on each input to 1e-6; the
    chunked sums equal one chunk's to 1e-6 (H) and 1e-5 (g, whose terms cancel) of
    their maxima."""
    rng = np.random.default_rng(0)
    o, pc, idxs, preds_tr = _oracle_scene(rng)
    res = 0.004
    T0 = (o + np.array([0.6, -0.4, 0.5], np.float32) * res).astype(np.float32)
    noise = rng.standard_normal(preds_tr.shape).astype(np.float32) * 0.0019
    few = np.zeros(8000, bool)
    few[:8] = True
    ones = np.ones(8000, bool)
    for tr, mask, tol in ((preds_tr, ones, 1e-5), (preds_tr + noise, ones, 5e-4),
                          (preds_tr, few, None)):
        got = tv.center_refine(ts.t(pc), ts.t(tr), ts.t(idxs), ts.t(T0), ts.t(mask), res).numpy()
        want = np.asarray(jv.center_refine(jnp.asarray(pc), jnp.asarray(tr), jnp.asarray(idxs),
                                           jnp.asarray(T0), jnp.asarray(mask), res))
        np.testing.assert_allclose(got, want, atol=1e-6)
        if tol is None:
            np.testing.assert_allclose(got, T0, atol=1e-7)
        else:
            assert np.linalg.norm(got - o) < tol
    H1, g1, w1 = tv.center_refine_terms(ts.t(pc), ts.t(preds_tr + noise), ts.t(idxs), ts.t(T0),
                                        torch.ones(8000), 3 * res)
    H2, g2, w2 = tv.center_refine_terms(ts.t(pc), ts.t(preds_tr + noise), ts.t(idxs), ts.t(T0),
                                        torch.ones(8000), 3 * res, chunk=1000)
    assert float(w1) == float(w2) > 64
    np.testing.assert_allclose(H2.numpy(), H1.numpy(), atol=1e-6 * float(H1.abs().max()))
    np.testing.assert_allclose(g2.numpy(), g1.numpy(), atol=1e-5 * float(g1.abs().max()))


def test_center_refine_clamp_and_singular():
    """The 2·res trust region, and a singular system (no pair survives)
    leaves the center where it was instead of raising."""
    T0 = torch.tensor([0.1, 0.2, 0.3])
    far = torch.tensor([0.2, 0.2, 0.3])
    np.testing.assert_allclose(tv.center_refine_clamp(far, T0, 0.004).numpy(),
                               [0.108, 0.2, 0.3], atol=1e-7)
    nan = torch.tensor([float("nan"), 0.2, 0.3])
    assert torch.equal(tv.center_refine_clamp(nan, T0, 0.004), T0)
    c = tv.center_refine_solve(torch.zeros(3, 3), torch.zeros(3), torch.tensor(0.0), T0, 64.0)
    assert torch.equal(c, T0)


# the indices of a full-width stratified sample (sofa: 4096 points, 100 000
# pairs) that differ from JAX's.  The CDF is summed in XLA's order
# (pose.cumsum_xla); a running float32 sum rounds its steps otherwise and
# sends 991 of the 200 000 indices to a neighbour point, a float64 sum 5
BALANCE_DIFF_FULL = 0


@pytest.mark.parametrize("n", [1, 15, 16, 17, 255, 257, 4096, 5003, 100_000])
def test_cumsum_xla_matches_jax(n):
    """cumsum_xla equals jnp.cumsum's float32 prefix sums on the CPU to the
    bit, at lengths on and off XLA's 16-element blocks and across three
    levels of them, on uniforms and on sparse 1/count weights."""
    rng = np.random.default_rng(n)
    for x in (rng.uniform(0, 1, n).astype(np.float32),
              ((rng.uniform(0, 1, n) < 0.3) / rng.integers(1, 400, n)).astype(np.float32)):
        np.testing.assert_array_equal(pose.cumsum_xla(torch.from_numpy(x)).numpy(),
                                      np.asarray(jax.jit(jnp.cumsum)(x)))


def test_pair_balance_indices():
    """sample_pair_indices with pair_balance 1 against JAX's on the same
    uniforms and normals: at the test size equal; at sofa's full width
    ``BALANCE_DIFF_FULL`` of the 200 000 indices differ.
    Uniform sampling (0) is the old draw to the bit, and the strata count
    sign-folded orientations (a plane's points share one)."""
    for n_points, knn, n_pairs, want_diff in ((512, 16, 2048, 0),
                                              (4096, 60, 100000, BALANCE_DIFF_FULL)):
        raw, _ = ts.view("sofa", 0)
        cfg_j, _ = ts.runner_configs("sofa")
        pad = np.zeros((cfg_j.npoint_max, 3), np.float32)
        pad[: len(raw)] = raw
        pre = ts.preprocess_j(jax.random.PRNGKey(0), jnp.asarray(pad), len(raw), cfg_j.res,
                              npoint_pad=n_points, knn=knn, jitter=False)
        key = jax.random.PRNGKey(0)
        pcfg_j = pose_j.PoseConfig(n_pairs=n_pairs, pair_balance=1.0)
        got_j = np.asarray(pose_j.sample_pair_indices(key, pre.pc, pre.normals, pre.n_valid,
                                                      pcfg_j))
        u = ts.t(jax.random.uniform(key, (n_pairs, 2)))
        got = pose.sample_pair_indices(u, ts.t(pre.n_valid), ts.t(pre.normals), 1.0).numpy()
        diff = got != got_j
        assert int(diff.sum()) == want_diff
        assert np.all(np.abs(got.astype(int) - got_j)[diff] == 1)
        assert got.max() < int(pre.n_valid)
        uniform = pose.sample_pair_indices(u, ts.t(pre.n_valid)).numpy()
        np.testing.assert_array_equal(uniform, np.asarray(pose_j.sample_pair_indices(
            key, pre.pc, pre.normals, pre.n_valid, pose_j.PoseConfig(n_pairs=n_pairs))))
    # a plane of 800 points (one stratum, either sign) and a leg of 100
    rng = np.random.default_rng(0)
    nrm = np.zeros((1024, 3), np.float32)
    nrm[:800, 1] = 1.0
    th = rng.uniform(0, 2 * np.pi, 100)
    nrm[800:900, 0], nrm[800:900, 2] = np.cos(th), np.sin(th)
    nrm *= (rng.integers(0, 2, 1024) * 2 - 1).astype(np.float32)[:, None]
    idx = pose.sample_pair_indices(torch.rand((20000, 2), generator=torch.Generator()
                                              .manual_seed(0)), 900, torch.from_numpy(nrm), 1.0)
    assert np.mean(idx.numpy() >= 800) > 0.5


def test_rot_vote_sphere_count_weights():
    """weights= scales each pair's cone votes: ones give the unweighted
    counts, halves half of them (to the bit), and random weights JAX's
    counts within one pair's weight a bin, on 98 % of the bins exactly to
    1e-5 (the unweighted test's tan/sin/cos rule)."""
    from cppf_tpu_torch.core.geometry import fibonacci_sphere

    rng = np.random.default_rng(5)
    pc = (rng.normal(size=(64, 3)) * 0.1).astype(np.float32)
    idxs = rng.integers(0, 64, size=(200, 2)).astype(np.int32)
    angles = (rng.integers(0, 36, 200) / 35 * np.pi).astype(np.float32)
    sphere = fibonacci_sphere(120).astype(np.float32)
    cos_tol = float(np.cos(np.deg2rad(np.float32(5.0))))
    args = (ts.t(pc), ts.t(angles), ts.t(idxs), ts.t(sphere), cos_tol)
    base = tv.rot_vote_sphere_count(*args, n_rots=24, chunk=64)
    assert torch.equal(tv.rot_vote_sphere_count(*args, n_rots=24, weights=torch.ones(200)), base)
    assert torch.equal(tv.rot_vote_sphere_count(*args, n_rots=24, weights=torch.full((200,), 0.5)),
                       base * 0.5)
    w = rng.uniform(size=200).astype(np.float32)
    got = tv.rot_vote_sphere_count(*args, n_rots=24, chunk=64, weights=ts.t(w)).numpy()
    want = np.asarray(jv.rot_vote_sphere_count(jnp.asarray(pc), jnp.asarray(angles),
                                               jnp.asarray(idxs), jnp.asarray(sphere), cos_tol,
                                               n_rots=24, weights=jnp.asarray(w)))
    assert want.sum() > 100
    assert np.all(np.abs(got - want) <= w.max() + 1e-4)
    assert np.mean(np.abs(got - want) <= 1e-5 * max(want.max(), 1.0)) > 0.98


def test_sharp_weights_match_jax():
    """sharp_weights of random logits equal JAX's confidence rescaling to
    1e-6; a flat row weighs 0, a peaked one near 1."""
    logits = np.random.default_rng(0).normal(size=(300, 36)).astype(np.float32) * 3
    logits[0] = 0.0
    logits[1, 5] = 100.0
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    want = np.clip((np.asarray(jnp.max(probs, -1)) - 1 / 36) / (1 - 1 / 36), 0, 1)
    got = pose.sharp_weights(ts.t(logits)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert got[0] == 0.0 and got[1] > 0.999


def test_separation_weights_match_jax():
    """pair_sep_power's center weights: quantile_linear is jnp.quantile's
    to the bit, and so are the weights (with and without the coplanar
    filter under them)."""
    raw, _ = ts.view("sofa", 0)
    pcfg_j, pcfg_t, cfg = ts.small_configs("sofa")
    pre = ts.preprocess(raw, cfg.res)
    idxs = np.random.default_rng(0).integers(0, int(pre.n_valid), (2048, 2)).astype(np.int32)
    pc = np.asarray(pre.pc)
    sep = np.linalg.norm(pc[idxs[:, 0]] - pc[idxs[:, 1]], axis=-1).astype(np.float32)
    for q in (0.75, 0.5, 0.1):
        assert float(pose.quantile_linear(ts.t(sep), q)) == float(jnp.quantile(sep, q))
    for filt in (False, True):
        p = dataclasses.replace(pcfg_t, pair_sep_power=2.0, filter_coplanar=filt)
        got = pose.center_vote_masks(ts.t(pre.pc), ts.t(pre.normals), ts.t(idxs), p)[0].numpy()
        # as the pipeline computes them, in one XLA program (eager, x ** 2.0
        # is XLA's pow; compiled, it is x * x, as torch's)
        sep_j = jnp.linalg.norm(pre.pc[idxs[:, 0]] - pre.pc[idxs[:, 1]], axis=-1)
        w = jax.jit(lambda s: jnp.clip(s / jnp.maximum(jnp.quantile(s, 0.75), 1e-6), 0.0,
                                       1.0) ** 2.0)(sep_j)
        if filt:
            keep = pose.coplanar_center_mask(ts.t(pre.pc), ts.t(pre.normals), ts.t(idxs)).numpy()
            w = jnp.asarray(keep) * w
        np.testing.assert_array_equal(got, np.asarray(w))
