"""The port's vote-hist kernels against the Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions; these are held
against cppf_tpu's Pallas kernels in interpret mode on identical numpy
votes (atol 1e-4: float32 sums of ~1e3 terms in another order).  The CUDA
kernels are held against the plain versions on the card in
tests/test_torch_cuda_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf_tpu.ops.pallas import vote_hist as pallas_vh
from cppf_tpu_torch.ops import vote_hist
from cppf_tpu_torch.ops import voting

torch.set_num_threads(1)

V = 2048
W8 = 16


def _votes(g, seed=0):
    rng = np.random.default_rng(seed)
    # floors concentrated in the middle of the grid, like a real vote ring,
    # plus a quarter near the grid's low and high edges
    f = np.clip(rng.normal(g / 2, g / 5, (3, V)), 0, g - 2).astype(np.int32)
    n = V // 4
    f[:, :n] = np.where(rng.random((3, n)) < 0.5, rng.integers(0, 18, (3, n)),
                        rng.integers(g - 18, g - 1, (3, n)))
    r = rng.random((3, V)).astype(np.float32)
    w = (rng.random(V) < 0.8).astype(np.float32) * rng.random(V).astype(np.float32)
    return [*f, *r, w]


def _torch(arrs, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrs]


def _bound_kw(g, pf):
    bn = -(-g // pf)
    return dict(gx=g, gy=g, by_n=bn, bz_n=bn, pfy=pf, pfz=pf)


GRIDS = [(64, 1), (120, 2)]


@pytest.mark.parametrize("splat", ["trilinear", "nearest"])
@pytest.mark.parametrize("g,pf", GRIDS)
def test_bound_projections_plain_matches_pallas(g, pf, splat):
    votes = _votes(g)
    kw = _bound_kw(g, pf)
    expect = pallas_vh.bound_projections(*(jnp.asarray(a) for a in votes), **kw, splat=splat,
                                         chunk=512, interpret=True)
    got = vote_hist.bound_projections(*_torch(votes), **kw, splat=splat)
    for e, t in zip(expect, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(e), atol=1e-4)


@pytest.mark.parametrize("splat", ["trilinear", "nearest"])
@pytest.mark.parametrize("g,pf", GRIDS)
@pytest.mark.parametrize("where", ["zero", "middle", "end"])
def test_refine_window_plain_matches_pallas(g, pf, splat, where):
    votes = _votes(g, seed=1)
    start = {"zero": 0, "middle": g // 2 // W8 * W8, "end": g - W8}[where]
    o = np.full(3, start, np.int32)
    expect = pallas_vh.refine_window(jnp.asarray(o), *(jnp.asarray(a) for a in votes),
                                     w8=W8, splat=splat, chunk=512, interpret=True)
    got = vote_hist.refine_window(torch.from_numpy(o), *_torch(votes), w8=W8, splat=splat)
    assert np.asarray(expect).sum() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=1e-4)


@pytest.mark.parametrize("splat", ["trilinear", "nearest"])
def test_plain_versions_sum_in_the_weights_dtype(splat):
    """Float64 fractions and weights give the float64 sums that the card's
    tests hold the kernels to; they agree with the float32 sums."""
    fx, fy, fz, rx, ry, rz, w = _torch(_votes(64, seed=2))
    votes64 = [fx, fy, fz, rx.double(), ry.double(), rz.double(), w.double()]
    kw = _bound_kw(64, 1)
    o = torch.full((3,), 16, dtype=torch.int32)
    exact = [*vote_hist.bound_projections_plain(*votes64, **kw, splat=splat),
             vote_hist.refine_window_plain(o, *votes64, w8=W8, splat=splat)]
    plain = [*vote_hist.bound_projections_plain(fx, fy, fz, rx, ry, rz, w, **kw, splat=splat),
             vote_hist.refine_window_plain(o, fx, fy, fz, rx, ry, rz, w, w8=W8, splat=splat)]
    for e, t in zip(exact, plain):
        assert e.dtype == torch.float64 and t.dtype == torch.float32
        assert float(e.max()) > 0
        np.testing.assert_allclose(t.numpy(), e.numpy(), atol=1e-5)


def test_wrappers_check_inputs():
    votes = _torch(_votes(64))
    with pytest.raises(ValueError):
        vote_hist.bound_projections(*votes[:6], votes[6].double(), **_bound_kw(64, 1))
    with pytest.raises(ValueError):
        vote_hist.refine_window(torch.zeros(3, dtype=torch.int64), *votes, w8=W8)
    with pytest.raises(ValueError):
        vote_hist.bound_projections(*votes, **_bound_kw(64, 1), splat="cubic")


def _pairs(g, n_rots, adaptive, seed=0, n=128, p=700):
    """A pair-parameter block and grid frame whose vote circles cross near
    one center of a g³ grid at 4 mm, with some pairs masked."""
    rng = np.random.default_rng(seed)
    res = 4e-3
    pc = (rng.normal(size=(n, 3)) * 0.04).astype(np.float32)
    idxs = rng.integers(0, n, (p, 2)).astype(np.int32)
    idxs[:3, 1] = idxs[:3, 0]
    a, b = pc[idxs[:, 0]], pc[idxs[:, 1]]
    d = (a - b) / (np.linalg.norm(a - b, axis=-1, keepdims=True) + 1e-7)
    proj = np.sum(a * d, -1)
    odist = np.linalg.norm(a - proj[:, None] * d, axis=-1)
    preds_tr = np.stack([proj, odist], -1).astype(np.float32)
    corner = torch.from_numpy((pc.min(0) - 0.02).astype(np.float32))
    dims = torch.tensor([g - 3.0, g - 1.0, g + 4.0])
    mask = torch.from_numpy(rng.random(p) < 0.9)
    params = voting.pair_vote_params(torch.from_numpy(pc), torch.from_numpy(preds_tr),
                                     torch.from_numpy(rng.random(n).astype(np.float32)),
                                     torch.from_numpy(idxs), res, n_rots, adaptive, mask)
    f, r, w = voting.votes_from_pair_params(params, corner, res, dims, (g, g, g), n_rots)
    votes = [t.reshape(-1) for t in (*f, *r, w)]
    return params, vote_hist.vote_frame(corner, res, dims), votes


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("splat", ["trilinear", "nearest"])
@pytest.mark.parametrize("g,pf,n_rots", [(64, 1, 72), (120, 2, 8)])
def test_pairs_front_ends_equal_votes_front_ends(g, pf, n_rots, splat, adaptive):
    """On the CPU the pairs wrappers are votes_from_pair_params and the plain
    versions, so they equal the votes wrappers on the same votes exactly;
    the window's cull changes nothing."""
    params, frame, votes = _pairs(g, n_rots, adaptive)
    kw = dict(by_n=-(-g // pf), bz_n=-(-g // pf), pfy=pf, pfz=pf, splat=splat)
    pkw = dict(n_rots=n_rots, grid_shape=(g, g, g))
    expect = vote_hist.bound_projections(*votes, gx=g, gy=g, **kw)
    got = vote_hist.bound_projections_pairs(params, frame, **pkw, **kw)
    assert float(expect[0].sum()) > 0
    for e, t in zip(expect, got):
        assert torch.equal(e, t)
    for start in (0, 8, g // 2 // W8 * W8, g - W8):
        o = torch.full((3,), start, dtype=torch.int32)
        assert torch.equal(vote_hist.refine_window_pairs(o, params, frame, **pkw, w8=W8,
                                                         splat=splat),
                           vote_hist.refine_window(o, *votes, w8=W8, splat=splat))


def test_pairs_front_end_matches_pallas():
    """The pairs wrapper on the CPU against the Pallas kernel (interpret
    mode) on the votes of the same pairs, as the votes wrapper is held; the
    cells here sum ~1e4 terms to several hundred, hence rtol 1e-5 beside the
    atol."""
    params, frame, votes = _pairs(64, 72, False, seed=3, p=512)  # V = 72 chunks of 512
    kw = _bound_kw(64, 1)
    expect = pallas_vh.bound_projections(*(jnp.asarray(v.numpy()) for v in votes), **kw,
                                         chunk=512, interpret=True)
    got = vote_hist.bound_projections_pairs(params, frame, n_rots=72, grid_shape=(64,) * 3,
                                            by_n=64, bz_n=64, pfy=1, pfz=1)
    for e, t in zip(expect, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(e), rtol=1e-5, atol=1e-4)


BAD_PAIRS = {
    "params dtype": lambda p, f, o: (p.double(), f, o),
    "params width": lambda p, f, o: (p[:, :11].contiguous(), f, o),
    "params rank": lambda p, f, o: (p.reshape(-1), f, o),
    "params strided": lambda p, f, o: (torch.cat([p, p], 1)[:, :12], f, o),
    "params device": lambda p, f, o: (p.to("meta"), f, o),
    "frame shape": lambda p, f, o: (p, f[:6], o),
    "frame dtype": lambda p, f, o: (p, f.double(), o),
    "frame device": lambda p, f, o: (p, f.to("meta"), o),
    "origin dtype": lambda p, f, o: (p, f, o.long()),
    "origin shape": lambda p, f, o: (p, f, o[:2]),
}


@pytest.mark.parametrize("what", sorted(BAD_PAIRS))
def test_pairs_wrappers_check_inputs(what):
    params, frame, _ = _pairs(64, 8, False, p=50)
    o = torch.zeros(3, dtype=torch.int32)
    params, frame, o = BAD_PAIRS[what](params, frame, o)
    pkw = dict(n_rots=8, grid_shape=(64, 64, 64))
    with pytest.raises(ValueError):
        vote_hist.refine_window_pairs(o, params, frame, **pkw, w8=W8)
    if not what.startswith("origin"):
        with pytest.raises(ValueError):
            vote_hist.bound_projections_pairs(params, frame, **pkw, by_n=64, bz_n=64, pfy=1,
                                              pfz=1)


def test_pairs_wrappers_check_options():
    params, frame, _ = _pairs(64, 8, False, p=50)
    with pytest.raises(ValueError):
        vote_hist.bound_projections_pairs(params, frame, n_rots=8, grid_shape=(64, 64, 64),
                                          by_n=64, bz_n=64, pfy=1, pfz=1, splat="cubic")
    with pytest.raises(ValueError):
        vote_hist.bound_projections_pairs(params, frame, n_rots=0, grid_shape=(64, 64, 64),
                                          by_n=64, bz_n=64, pfy=1, pfz=1)
    with pytest.raises(ValueError):
        vote_hist.refine_window_pairs(torch.zeros(3, dtype=torch.int32), params, frame,
                                      n_rots=8, grid_shape=(64, 64))


@pytest.mark.parametrize("what", ["strided", "device", "shape"])
def test_votes_wrappers_check_layout(what):
    votes = _torch(_votes(64))
    if what == "strided":
        votes[0] = torch.stack([votes[0], votes[0]], 1)[:, 0]
    elif what == "device":
        votes[3] = votes[3].to("meta")
    else:
        votes[5] = votes[5][:-1]
    with pytest.raises(ValueError):
        vote_hist.bound_projections(*votes, **_bound_kw(64, 1))
    with pytest.raises(ValueError):
        vote_hist.refine_window(torch.zeros(3, dtype=torch.int32), *votes, w8=W8)
