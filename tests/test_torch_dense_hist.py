"""The port's dense vote histogram against the JAX package.

On the CPU ``dense_hist`` runs its plain version (an ``index_add_`` over
the pooled taps); it is held against the Pallas ``dense_hist`` in
interpret mode on identical numpy votes, and the port's chunked
``ppf_vote_dense`` against JAX's ``ppf_vote_dense``.  Tolerance: 1e-4 of
the grid's maximum — the same float32 terms summed in another order (a
one-hot matrix product against ``index_add_``).  The CUDA kernel is held
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
