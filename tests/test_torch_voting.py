"""The port's voting ops against cppf_tpu.ops.voting on identical inputs."""
from functools import partial

import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings

from cppf_tpu.core.geometry import fibonacci_sphere
from cppf_tpu.ops import voting as jv
from cppf_tpu_torch.core.geometry import cross
from cppf_tpu_torch.ops import vote_hist
from cppf_tpu_torch.ops import voting as tv

torch.set_num_threads(1)

RES = 4e-3
GSHAPE = (64, 64, 64)
N_ROTS = 72


def _instance(seed=0, n=128, p=512):
    """Random cloud and pair predictions whose vote circles cross near one
    center, so the grid has a real peak."""
    rng = np.random.default_rng(seed)
    pc = (rng.normal(size=(n, 3)) * 0.04).astype(np.float32)
    idxs = rng.integers(0, n, (p, 2)).astype(np.int32)
    idxs[:4, 1] = idxs[:4, 0]  # a few degenerate pairs
    center = np.float32([0.01, -0.005, 0.0])
    a, b = pc[idxs[:, 0]], pc[idxs[:, 1]]
    d = (a - b) / (np.linalg.norm(a - b, axis=-1, keepdims=True) + 1e-7)
    rel = a - center
    proj = np.sum(rel * d, -1)
    odist = np.linalg.norm(rel - proj[:, None] * d, axis=-1)
    noise = rng.normal(size=(2, p)) * 0.004
    preds_tr = np.stack([proj + noise[0], np.abs(odist + noise[1])], -1).astype(np.float32)
    corner = (pc.min(0) - 0.01).astype(np.float32)
    dims = (((pc.max(0) - corner) / RES).astype(np.int32) + 1)
    probs = np.ones(n, np.float32)
    return pc, preds_tr, probs, idxs, corner, dims


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(*arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("halfspace", [False, True])
def test_vote_coords_elementwise(adaptive, halfspace):
    pc, preds_tr, probs, idxs, corner, dims = _instance()
    p = idxs.shape[0]
    mask = np.ones(p, bool)
    mask[5:9] = False
    hs_np = None
    if halfspace:
        rng = np.random.default_rng(3)
        nrm = rng.normal(size=(p, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        hs_np = (pc[idxs[:, 0]], nrm, rng.random(p) < 0.5, np.float32(2 * RES))
    fn = jax.jit(partial(jv._vote_coords, grid_shape=GSHAPE, n_rots=N_ROTS, adaptive=adaptive))
    f_j, r_j, w_j = fn(*_j(pc, preds_tr, probs, idxs, corner), jnp.float32(RES),
                       jnp.asarray(dims, jnp.float32), pair_mask=jnp.asarray(mask),
                       halfspace=None if hs_np is None else tuple(_j(*hs_np)))
    f_t, r_t, w_t = tv._vote_coords(*_t(pc, preds_tr, probs, idxs, corner), RES,
                                    torch.from_numpy(dims).float(), GSHAPE, N_ROTS, adaptive,
                                    torch.from_numpy(mask),
                                    halfspace=None if hs_np is None else tuple(_t(*hs_np)))
    w_j = np.asarray(w_j)
    np.testing.assert_array_equal(w_t.numpy(), w_j)
    live = w_j > 0
    assert live.mean() > 0.3
    for fj, rj, ft, rt in zip(f_j, r_j, f_t, r_t):
        np.testing.assert_array_equal(ft.numpy()[live], np.asarray(fj)[live])
        np.testing.assert_allclose(rt.numpy()[live], np.asarray(rj)[live], atol=2e-5)


def _mask(kind, p, seed=7):
    rng = np.random.default_rng(seed)
    if kind == "bool":
        return rng.random(p) < 0.8
    return rng.random(p).astype(np.float32)


@pytest.mark.parametrize("adaptive", [False, True])
def test_vote_coords_float_mask_matches_jax(adaptive):
    """A float pair_mask scales the weights; as test_vote_coords_elementwise
    otherwise: weights and live floors exactly, live fractions to 2e-5."""
    pc, preds_tr, probs, idxs, corner, dims = _instance(6)
    probs = np.random.default_rng(6).random(len(probs)).astype(np.float32)
    mask = _mask("float", idxs.shape[0])
    fn = jax.jit(partial(jv._vote_coords, grid_shape=GSHAPE, n_rots=N_ROTS, adaptive=adaptive))
    f_j, r_j, w_j = fn(*_j(pc, preds_tr, probs, idxs, corner), jnp.float32(RES),
                       jnp.asarray(dims, jnp.float32), pair_mask=jnp.asarray(mask))
    f_t, r_t, w_t = tv._vote_coords(*_t(pc, preds_tr, probs, idxs, corner), RES,
                                    torch.from_numpy(dims).float(), GSHAPE, N_ROTS, adaptive,
                                    torch.from_numpy(mask))
    w_j = np.asarray(w_j)
    np.testing.assert_array_equal(w_t.numpy(), w_j)
    live = w_j > 0
    assert live.mean() > 0.3
    for fj, rj, ft, rt in zip(f_j, r_j, f_t, r_t):
        np.testing.assert_array_equal(ft.numpy()[live], np.asarray(fj)[live])
        np.testing.assert_allclose(rt.numpy()[live], np.asarray(rj)[live], atol=2e-5)


def _vote_coords_unsplit(pc, preds_tr, probs, point_idxs, corner, res, dims_f, grid_shape,
                         n_rots, adaptive, pair_mask):
    """_vote_coords as one function, as it was before it became
    pair_vote_params followed by votes_from_pair_params: the reference for
    bit equality."""
    res = tv._scalar(res, pc)
    a, ab_unit, degenerate, co_unit = tv.pair_frames(pc, point_idxs)
    proj_len, odist = preds_tr[:, 0], preds_tr[:, 1]
    m = tv._adaptive_rots(odist, res, n_rots, adaptive)
    c = a - ab_unit * proj_len[:, None]
    x = co_unit * odist[:, None]
    y = cross(x, ab_unit)
    cos_a, sin_a, rot_valid = tv._circle(m, n_rots, pc)
    idx = point_idxs.long()
    w = torch.maximum(probs[idx[:, 0]], probs[idx[:, 1]])
    valid = rot_valid & (~degenerate)[:, None]
    if pair_mask.dtype == torch.bool:
        valid = valid & pair_mask[:, None]
    else:
        w = w * pair_mask
    fcomp, rcomp = [], []
    for k in range(3):
        gk = (c[:, k, None] + cos_a * x[:, k, None] + sin_a * y[:, k, None]
              - corner[k]) / res
        dk = torch.clamp(dims_f[k], max=grid_shape[k])
        valid = valid & (gk >= 0.01) & (gk < dk - 1.01)
        fk = torch.clamp(torch.floor(gk).to(torch.int32), 0, grid_shape[k] - 2)
        fcomp.append(fk)
        rcomp.append(gk - fk)
    return fcomp, rcomp, torch.where(valid, w[:, None], 0.0)


@pytest.mark.parametrize("n_rots,grid", [(8, 64), (72, 120)])
@pytest.mark.parametrize("mask_kind", ["bool", "float"])
@pytest.mark.parametrize("adaptive", [False, True])
def test_pair_params_votes_bit_equal(adaptive, mask_kind, n_rots, grid):
    """votes_from_pair_params(pair_vote_params(...)) is the unsplit
    _vote_coords bit for bit: floors, fractions and weights."""
    pc, preds_tr, probs, idxs, corner, dims = _instance(8, n=160, p=1500)
    probs = np.random.default_rng(8).random(len(probs)).astype(np.float32)
    mask = torch.from_numpy(_mask(mask_kind, idxs.shape[0]))
    gshape = (grid,) * 3
    t = _t(pc, preds_tr, probs, idxs, corner)
    dims_f = torch.from_numpy(dims).float()
    expect = _vote_coords_unsplit(*t, RES, dims_f, gshape, n_rots, adaptive, mask)
    params = tv.pair_vote_params(t[0], t[1], t[2], t[3], RES, n_rots, adaptive, mask)
    assert params.shape == (idxs.shape[0], 12) and params.is_contiguous()
    got = tv.votes_from_pair_params(params, t[4], RES, dims_f, gshape, n_rots)
    assert (expect[2] > 0).float().mean() > 0.2
    for e, g in zip((*expect[0], *expect[1], expect[2]), (*got[0], *got[1], got[2])):
        assert e.dtype == g.dtype
        assert torch.equal(e.view(torch.int32), g.view(torch.int32))
    again = tv._vote_coords(*t, RES, dims_f, gshape, n_rots, adaptive, mask)
    assert torch.equal(again[2], expect[2])


def test_pair_params_keep_float64():
    """The split keeps _vote_coords usable in float64 (the kernels take
    float32 only): same votes as the unsplit function."""
    pc, preds_tr, probs, idxs, corner, dims = _instance(9, n=64, p=200)
    t = [x.double() if x.dtype == torch.float32 else x
         for x in _t(pc, preds_tr, probs, idxs, corner)]
    mask = torch.ones(idxs.shape[0], dtype=torch.bool)
    dims_f = torch.from_numpy(dims).double()
    expect = _vote_coords_unsplit(*t, RES, dims_f, GSHAPE, N_ROTS, True, mask)
    got = tv._vote_coords(*t, RES, dims_f, GSHAPE, N_ROTS, True, mask)
    assert got[2].dtype == torch.float64 and float(got[2].sum()) > 0
    for e, g in zip((*expect[0], *expect[1], expect[2]), (*got[0], *got[1], got[2])):
        assert torch.equal(e, g)


@settings(max_examples=40, deadline=None, database=None, derandomize=True)
@given(seed=st.integers(0, 5), adaptive=st.booleans(),
       o=st.tuples(*[st.integers(-8, 56)] * 3), w8=st.sampled_from([8, 16]))
def test_window_cull_keeps_every_pair_with_a_vote_in_the_window(seed, adaptive, o, w8):
    """No pair that window_cull_plain drops has a live vote whose splat can
    reach the window (a floor in [o-1, o+w8) on every axis)."""
    pc, preds_tr, probs, idxs, corner, dims = _instance(seed, n=96, p=600)
    t = _t(pc, preds_tr, probs, idxs, corner)
    mask = torch.ones(idxs.shape[0], dtype=torch.bool)
    params = tv.pair_vote_params(t[0], t[1], t[2], t[3], RES, N_ROTS, adaptive, mask)
    dims_f = torch.from_numpy(dims).float()
    f, _, w = tv.votes_from_pair_params(params, t[4], RES, dims_f, GSHAPE, N_ROTS)
    reaches = w != 0
    for k in range(3):
        reaches = reaches & (f[k] >= o[k] - 1) & (f[k] < o[k] + w8)
    keep = vote_hist.window_cull_plain(params, vote_hist.vote_frame(t[4], RES, dims_f),
                                       torch.tensor(o, dtype=torch.int32), w8)
    assert not bool((reaches.any(1) & ~keep).any())


def test_window_cull_drops_far_pairs():
    """The cull is not vacuous: a window in a far corner of the grid drops
    pairs, and one on the vote center keeps most."""
    pc, preds_tr, probs, idxs, corner, dims = _instance(1)
    t = _t(pc, preds_tr, probs, idxs, corner)
    params = tv.pair_vote_params(t[0], t[1], t[2], t[3], RES, N_ROTS, False,
                                 torch.ones(idxs.shape[0], dtype=torch.bool))
    frame = vote_hist.vote_frame(t[4], RES, torch.from_numpy(dims).float())
    center = ((np.float32([0.01, -0.005, 0.0]) - corner) / RES).astype(np.int32) - 8
    near = vote_hist.window_cull_plain(params, frame, torch.from_numpy(center), 16)
    far = vote_hist.window_cull_plain(params, frame, torch.tensor([48, 48, 48],
                                                                  dtype=torch.int32), 16)
    assert near.float().mean() > 0.9
    assert far.float().mean() < 0.5


@pytest.mark.parametrize("splat", ["trilinear", "nearest"])
def test_ppf_vote_grid_matches(splat):
    pc, preds_tr, probs, idxs, corner, dims = _instance(1)
    g_j = jv.ppf_vote(*_j(pc, preds_tr, probs, idxs, corner), RES, jnp.asarray(dims), GSHAPE,
                      n_rots=N_ROTS, splat=splat)
    g_t = tv.ppf_vote(*_t(pc, preds_tr, probs, idxs, corner), RES, torch.from_numpy(dims),
                      GSHAPE, n_rots=N_ROTS, splat=splat)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-4)


@pytest.mark.parametrize("max_rounds", [0, 2])
@pytest.mark.parametrize("splat", ["trilinear", "nearest"])
@pytest.mark.parametrize("seed", [0, 2])
def test_ppf_vote_peak_matches_xla_path(seed, splat, max_rounds):
    pc, preds_tr, probs, idxs, corner, dims = _instance(seed)
    args_j = (*_j(pc, preds_tr, probs, idxs, corner), RES, jnp.asarray(dims), GSHAPE)
    grid = np.asarray(jv.ppf_vote(*args_j, n_rots=N_ROTS, splat=splat))
    idx_j, peak_j = jv.ppf_vote_peak(*args_j, n_rots=N_ROTS, splat=splat, vchunk=8192,
                                     max_rounds=max_rounds, use_pallas=False,
                                     bound_dtype="float32")
    idx_t, peak_t = tv.ppf_vote_peak(*_t(pc, preds_tr, probs, idxs, corner), RES,
                                     torch.from_numpy(dims), GSHAPE, n_rots=N_ROTS,
                                     splat=splat, max_rounds=max_rounds)
    # equal up to float32 summation order: the returned voxel holds the JAX
    # peak's mass, and both peaks agree to rtol 1e-5
    np.testing.assert_allclose(grid[tuple(idx_t.numpy())], float(peak_j), rtol=1e-5)
    np.testing.assert_allclose(float(peak_t), float(peak_j), rtol=1e-5)
    if max_rounds == 0:
        np.testing.assert_allclose(grid[tuple(idx_t.numpy())], grid.max(), rtol=1e-6)


def test_ppf_vote_peak_rejects_reduced_bounds():
    pc, preds_tr, probs, idxs, corner, dims = _instance()
    with pytest.raises(ValueError):
        tv.ppf_vote_peak(*_t(pc, preds_tr, probs, idxs, corner), RES, torch.from_numpy(dims),
                         GSHAPE, bound_dtype="bfloat16")


def test_backvote_masks_equal():
    pc, preds_tr, probs, idxs, corner, dims = _instance(4)
    center = np.float32([0.012, -0.004, 0.0])
    off_j, m_j = jv.backvote(*_j(pc, preds_tr, idxs, corner), RES, jnp.asarray(dims),
                             jnp.asarray(center), RES, n_rots=N_ROTS)
    off_t, m_t = tv.backvote(*_t(pc, preds_tr, idxs, corner), RES, torch.from_numpy(dims),
                             torch.from_numpy(center), RES, n_rots=N_ROTS)
    m_j = np.asarray(m_j)
    assert 0.05 < m_j.mean() < 0.95
    np.testing.assert_array_equal(m_t.numpy(), m_j)
    np.testing.assert_allclose(off_t.numpy(), np.asarray(off_j), atol=1e-6)


def _cone_cosines(pc, angles, idxs, sphere, n_rots):
    """float64 cosines [P·R, S] between every cone candidate and every
    sphere direction (the math of rot_vote_sphere_count, in numpy)."""
    a, b = pc[idxs[:, 0]].astype(np.float64), pc[idxs[:, 1]].astype(np.float64)
    ab = (a - b) / (np.linalg.norm(a - b, axis=-1, keepdims=True) + 1e-7)
    co = np.stack([np.zeros(len(ab)), -ab[:, 2], ab[:, 1]], -1)
    small = np.linalg.norm(co, axis=-1) < 1e-7
    co[small] = np.stack([-ab[small, 1], ab[small, 0], np.zeros(small.sum())], -1)
    co /= np.linalg.norm(co, axis=-1, keepdims=True) + 1e-7
    y = np.cross(co, ab)
    ang = np.arange(n_rots) * (2 * np.pi / n_rots)
    t = np.tan(angles.astype(np.float64))[:, None, None]
    u = (t * (np.cos(ang)[None, :, None] * co[:, None] + np.sin(ang)[None, :, None] * y[:, None])
         + np.where(t > 0, 1.0, -1.0) * ab[:, None])
    u /= np.linalg.norm(u, axis=-1, keepdims=True) + 1e-30
    return u.reshape(-1, 3) @ sphere.astype(np.float64).T


def test_rot_vote_sphere_count_counts_equal():
    """Counts are equal, except that a candidate whose cosine to a sphere
    direction lies within 1e-5 of the cone threshold may fall on either side:
    XLA's and PyTorch's float32 tan/sin/cos differ in the last bit for ~5% of
    arguments (3 of the 36 bin angles' tangents)."""
    pc, _, _, idxs, _, _ = _instance(5)
    rng = np.random.default_rng(5)
    angles = (rng.integers(0, 36, idxs.shape[0]) / 35 * np.pi).astype(np.float32)
    sphere = fibonacci_sphere(480).astype(np.float32)
    cos_tol = float(np.cos(np.deg2rad(np.float32(1.5))))
    c_j = np.asarray(jv.rot_vote_sphere_count(*_j(pc, angles, idxs, sphere), cos_tol,
                                              n_rots=N_ROTS))
    c_t = tv.rot_vote_sphere_count(*_t(pc, angles, idxs, sphere), cos_tol, n_rots=N_ROTS,
                                   chunk=100).numpy()
    assert c_j.sum() > 1000
    near = np.abs(_cone_cosines(pc, angles, idxs, sphere, N_ROTS) - cos_tol) < 1e-5
    assert np.all(np.abs(c_t - c_j) <= near.sum(0))
    assert np.mean(c_t == c_j) > 0.98


def test_grid_argmax_first_maximum():
    grid = np.zeros((4, 5, 6), np.float32)
    grid[1, 2, 3] = grid[2, 0, 1] = 5.0
    corner = np.float32([0.1, 0.2, 0.3])
    np.testing.assert_allclose(
        tv.grid_argmax(torch.from_numpy(grid), torch.from_numpy(corner), RES).numpy(),
        np.asarray(jv.grid_argmax(jnp.asarray(grid), jnp.asarray(corner), RES)))
