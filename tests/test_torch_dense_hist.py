"""The port's dense vote histogram against the JAX package.

On the CPU ``dense_hist`` runs its plain version (an ``index_add_`` over
the pooled taps); it is held against the Pallas ``dense_hist`` in
interpret mode on identical numpy votes, and the port's chunked
``ppf_vote_dense`` against JAX's ``ppf_vote_dense``.  Tolerance: 1e-4 of
the grid's maximum — the same float32 terms summed in another order (a
one-hot matrix product against ``index_add_``).  The pairs front end,
``dense_hist_pairs``, is on the CPU ``votes_from_pair_params`` followed by
the plain version, and equals them bit for bit.  The CUDA kernels are held
against the plain version on the card in tests/test_torch_cuda_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf_tpu.ops import voting as jv
from cppf_tpu.ops.pallas import vote_hist as pallas_vh
from cppf_tpu_torch.ops import vote_hist
from cppf_tpu_torch.ops import voting as tv

torch.set_num_threads(1)

V = 2048
RES = 4e-3
# (fine grid, pool): unpooled, pooled evenly, pooled with ragged edges
SHAPES = [((24, 20, 16), (1, 1, 1)), ((32, 24, 16), (4, 4, 4)), ((37, 29, 21), (4, 4, 4)),
          ((70, 45, 33), (8, 8, 8)), ((37, 29, 21), (2, 4, 8))]


def _votes(g, seed=0):
    """Floors clipped to [0, g-2] per axis (a quarter at the edges), 20 % of
    the votes masked."""
    rng = np.random.default_rng(seed)
    f = np.stack([np.clip(rng.normal(gk / 2, gk / 5, V), 0, gk - 2) for gk in g]).astype(np.int32)
    n = V // 4
    f[:, :n] = np.stack([np.where(rng.random(n) < 0.5, 0, gk - 2) for gk in g])
    r = rng.random((3, V)).astype(np.float32)
    w = (rng.random(V) < 0.8).astype(np.float32) * rng.random(V).astype(np.float32)
    return [*f, *r, w]


def _close(got, expect):
    expect = np.asarray(expect)
    assert expect.max() > 0
    np.testing.assert_allclose(got, expect, atol=1e-4 * expect.max(), rtol=0)


@pytest.mark.parametrize("splat", ["trilinear", "nearest"])
@pytest.mark.parametrize("g,pool", SHAPES)
def test_dense_hist_plain_matches_pallas(g, pool, splat):
    votes = _votes(g)
    c = dict(zip(("cx", "cy", "cz"), (-(-gk // p) for gk, p in zip(g, pool))))
    p = dict(zip(("px", "py", "pz"), pool))
    expect = pallas_vh.dense_hist(*(jnp.asarray(a) for a in votes), **c, **p, splat=splat,
                                  chunk=512, interpret=True)
    got = vote_hist.dense_hist(*(torch.from_numpy(a) for a in votes), **c, **p, splat=splat)
    assert got.shape == tuple(c.values())
    _close(got.numpy(), expect)


def test_dense_hist_accumulates_into_out():
    votes = [torch.from_numpy(a) for a in _votes((24, 20, 16))]
    kw = dict(cx=24, cy=20, cz=16)
    once = vote_hist.dense_hist(*votes, **kw)
    out = vote_hist.dense_hist(*votes, **kw)
    assert vote_hist.dense_hist(*votes, **kw, out=out) is out
    torch.testing.assert_close(out, 2 * once)
    with pytest.raises(ValueError):
        vote_hist.dense_hist(*votes, **kw, out=torch.zeros(24, 20, 15))
    with pytest.raises(ValueError):
        vote_hist.dense_hist(*votes, **kw, px=0)
    with pytest.raises(ValueError):
        vote_hist.dense_hist(*votes[:6], votes[6].double(), **kw)


def _instance(seed=0, n=96, p=256):
    """A small cloud whose pair predictions vote for one center."""
    rng = np.random.default_rng(seed)
    pc = (rng.normal(size=(n, 3)) * 0.02).astype(np.float32)
    idxs = rng.integers(0, n, (p, 2)).astype(np.int32)
    idxs[:3, 1] = idxs[:3, 0]   # degenerate pairs
    a, b = pc[idxs[:, 0]], pc[idxs[:, 1]]
    d = (a - b) / (np.linalg.norm(a - b, axis=-1, keepdims=True) + 1e-7)
    proj = np.sum(a * d, -1)
    odist = np.linalg.norm(a - proj[:, None] * d, axis=-1)
    preds_tr = np.stack([proj, odist], -1).astype(np.float32)
    corner = (pc.min(0) - 0.01).astype(np.float32)
    dims = ((pc.max(0) - corner) / RES).astype(np.int32) + 1
    gshape = tuple(int(np.ceil(x / 8) * 8) for x in dims)
    return pc, preds_tr, np.ones(n, np.float32), idxs, corner, dims, gshape


@pytest.mark.parametrize("pool", [(1, 1, 1), (4, 4, 4)])
def test_ppf_vote_dense_chunked_matches_jax(pool):
    pc, preds_tr, probs, idxs, corner, dims, gshape = _instance()
    mask = np.ones(len(idxs), bool)
    mask[10:20] = False
    expect = jv.ppf_vote_dense(*(jnp.asarray(a) for a in (pc, preds_tr, probs, idxs, corner)),
                               RES, jnp.asarray(dims), gshape, n_rots=36, adaptive=True,
                               pair_mask=jnp.asarray(mask), pool=pool)
    got = tv.ppf_vote_dense(*(torch.from_numpy(a) for a in (pc, preds_tr, probs, idxs, corner)),
                            RES, torch.from_numpy(dims), gshape, n_rots=36, adaptive=True,
                            pair_mask=torch.from_numpy(mask), pool=pool, pair_chunk=100)
    _close(got.numpy(), expect)


def test_ppf_vote_dense_unpooled_is_ppf_vote():
    """Pool (1,1,1): the grid of ppf_vote, whatever the pair chunk."""
    pc, preds_tr, probs, idxs, corner, dims, gshape = _instance(1)
    args = [torch.from_numpy(a) for a in (pc, preds_tr, probs, idxs, corner)]
    grid = tv.ppf_vote(*args, RES, torch.from_numpy(dims), gshape, n_rots=36, adaptive=True)
    for chunk in (64, 1 << 20):
        dense = tv.ppf_vote_dense(*args, RES, torch.from_numpy(dims), gshape, n_rots=36,
                                  adaptive=True, pair_chunk=chunk)
        _close(dense.numpy(), grid.numpy())


def _pairs(g, n_rots, adaptive, seed=0, n=128, p=600):
    """A pair-parameter block and grid frame whose vote circles spread over a
    g grid (x, y, z sizes), a tenth of the pairs masked and a few
    degenerate; with ``adaptive`` the short circles vote sparsely."""
    rng = np.random.default_rng(seed)
    res = 0.3 / max(g)
    pc = (rng.normal(size=(n, 3)) * 0.06).astype(np.float32)
    idxs = rng.integers(0, n, (p, 2)).astype(np.int32)
    idxs[:3, 1] = idxs[:3, 0]
    a, b = pc[idxs[:, 0]], pc[idxs[:, 1]]
    d = (a - b) / (np.linalg.norm(a - b, axis=-1, keepdims=True) + 1e-7)
    proj = np.sum(a * d, -1)
    odist = np.linalg.norm(a - proj[:, None] * d, axis=-1)
    odist[::4] *= 0.1
    preds_tr = np.stack([proj, odist], -1).astype(np.float32)
    corner = torch.from_numpy((-0.15 * np.array(g) / max(g)).astype(np.float32))
    dims = torch.tensor([g[0] - 3.0, g[1] - 1.0, g[2] + 4.0])
    mask = torch.from_numpy(rng.random(p) < 0.9)
    params = tv.pair_vote_params(torch.from_numpy(pc), torch.from_numpy(preds_tr),
                                 torch.from_numpy(rng.random(n).astype(np.float32)),
                                 torch.from_numpy(idxs), res, n_rots, adaptive, mask)
    return params, vote_hist.vote_frame(corner, res, dims)


def _cells(g, pool):
    return dict(zip(("cx", "cy", "cz"), (-(-gk // p) for gk, p in zip(g, pool))),
                **dict(zip(("px", "py", "pz"), pool)))


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("splat", ["trilinear", "nearest"])
@pytest.mark.parametrize("g,pool", SHAPES)
def test_dense_hist_pairs_is_votes_then_plain(g, pool, splat, adaptive):
    """On the CPU the pairs front end is votes_from_pair_params and the plain
    version, bit for bit; masked pairs and rotations past m add nothing."""
    params, frame = _pairs(g, 36, adaptive)
    f, r, w = tv.votes_from_pair_params(params, frame[:3], frame[3], frame[4:], g, 36)
    votes = [t.reshape(-1) for t in (*f, *r, w)]
    kw = dict(**_cells(g, pool), splat=splat)
    expect = vote_hist.dense_hist_plain(*votes, **kw)
    assert float(expect.max()) > 0
    got = vote_hist.dense_hist_pairs(params, frame, n_rots=36, grid_shape=g, **kw)
    assert torch.equal(got, expect)
    assert vote_hist.dense_hist_pairs(params, frame, n_rots=36, grid_shape=g, **kw,
                                      out=got) is got
    assert torch.equal(got, vote_hist.dense_hist_plain(*votes, **kw, out=expect.clone()))


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("g,pool", [((24, 20, 16), (1, 1, 1)), ((37, 29, 21), (2, 4, 8))])
def test_dense_hist_pairs_matches_jax(g, pool, adaptive):
    """The plain version against JAX's ppf_vote_dense (the Pallas dense_hist
    in interpret mode) on the same pairs."""
    pc, preds_tr, probs, idxs, corner, dims, _ = _instance(2)
    mask = np.ones(len(idxs), bool)
    mask[5:15] = False
    gshape = tuple(int(np.ceil(x / 8) * 8) for x in dims) if pool == (1, 1, 1) else g
    expect = jv.ppf_vote_dense(*(jnp.asarray(a) for a in (pc, preds_tr, probs, idxs, corner)),
                               RES, jnp.asarray(dims), gshape, n_rots=36, adaptive=adaptive,
                               pair_mask=jnp.asarray(mask), pool=pool)
    params = tv.pair_vote_params(*(torch.from_numpy(a) for a in (pc, preds_tr, probs, idxs)), RES,
                                 36, adaptive, torch.from_numpy(mask))
    frame = vote_hist.vote_frame(torch.from_numpy(corner), RES, torch.from_numpy(dims).float())
    got = vote_hist.dense_hist_pairs(params, frame, n_rots=36, grid_shape=gshape,
                                     **_cells(gshape, pool))
    _close(got.numpy(), expect)


BAD_DENSE_PAIRS = {
    "params dtype": lambda p, f, kw: (p.double(), f, kw),
    "params width": lambda p, f, kw: (p[:, :11].contiguous(), f, kw),
    "params strided": lambda p, f, kw: (torch.cat([p, p], 1)[:, :12], f, kw),
    "frame shape": lambda p, f, kw: (p, f[:6], kw),
    "frame device": lambda p, f, kw: (p, f.to("meta"), kw),
    "pool zero": lambda p, f, kw: (p, f, {**kw, "py": 0}),
    "cells short of the pooled grid": lambda p, f, kw: (p, f, {**kw, "px": 2, "cx": 11}),
    "out shape": lambda p, f, kw: (p, f, {**kw, "out": torch.zeros(24, 20, 15)}),
    "out dtype": lambda p, f, kw: (p, f, {**kw, "out": torch.zeros(24, 20, 16,
                                                                    dtype=torch.float64)}),
    "out strided": lambda p, f, kw: (p, f, {**kw, "out": torch.zeros(16, 20, 24).permute(2, 1, 0)}),
    "splat": lambda p, f, kw: (p, f, {**kw, "splat": "cubic"}),
    "rotations beyond the circle table": lambda p, f, kw: (p, f, {**kw, "n_rots": 300}),
}


@pytest.mark.parametrize("what", sorted(BAD_DENSE_PAIRS))
def test_dense_hist_pairs_checks_inputs(what):
    params, frame = _pairs((24, 20, 16), 8, False, p=50)
    kw = dict(n_rots=8, grid_shape=(24, 20, 16), cx=24, cy=20, cz=16)
    params, frame, kw = BAD_DENSE_PAIRS[what](params, frame, kw)
    with pytest.raises(ValueError):
        vote_hist.dense_hist_pairs(params, frame, **kw)
