"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc (``cuda`` marker) and skip
elsewhere.  They import only torch and the port, so they also run where
JAX is not installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_kernels.py``.  Tolerances, of the largest cell:
kernel and plain version sum in another order (atomics), 1e-5 where cells
hold some thousand terms.  On votes made from pairs, whose cells hold tens
of thousands of terms, the plain version's float32 ``index_add_`` is itself
off by ~1e-4, so there the peak kernels, which sum in fixed point inside a
block, are held to the plain version summed in float64: both front ends,
both splats.  The window kernels round a tap to the nearest fixed-point
unit: 1e-5 either way, as are both front ends of ``dense_hist`` on every
route (fixed point in shared memory, float atomics in device memory).  The
bound kernels round every tap up, so that their
sums stay upper bounds: a cell of n taps lies above the exact sum by up to
n units (1.4e-5 of the maximum was measured at these sizes: up to 1e-4),
and below it by no more than the float rounding of the blocks' flush
(1e-6).  Only the pairs front ends under adaptive rotations are held to 1e-3
instead: their angles i·2π/m come from a table of cosf and sinf, and a
last-bit difference from torch.cos can move one vote across a validity or
nearest-tap step.

The axis vote's sphere count makes every test as the plain version does,
one rounded float32 operation at a time, and sums whole numbers in int32:
its counts equal the plain version's to the bit, and the poses of the
benchmark's pools with it equal those without it.  Its weighted sums are
int64 fixed point: the same bits every run, within 1e-6 of each float64 sum.
"""
import os

import numpy as np
import pytest
import torch

import torch_sphere as tsph
from cppf_tpu_torch.ops import vote_hist
from cppf_tpu_torch.ops import voting

W8 = 16
GRIDS = [(56, 1), (64, 1), (88, 2), (120, 2), (152, 4)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _votes(g, v, device, seed=0):
    """Floors clustered mid-grid plus a spread to every edge; 20 % masked."""
    rng = np.random.default_rng(seed)
    f = np.clip(rng.normal(g / 2, g / 6, (3, v)), 0, g - 2).astype(np.int32)
    f[:, : v // 4] = rng.integers(0, g - 1, (3, v // 4))
    r = rng.random((3, v)).astype(np.float32)
    w = (rng.random(v) < 0.8).astype(np.float32) * rng.random(v).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (*f, *r, w)]


def _close(got, expect, rel=1e-5):
    scale = max(float(e.abs().max()) for e in expect)
    assert scale > 0
    for g, e in zip(got, expect):
        torch.testing.assert_close(g, e, atol=rel * scale, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("splat", ["trilinear", "nearest"])
@pytest.mark.parametrize("g,pf", GRIDS)
def test_kernels_match_plain(cuda, g, pf, splat):
    # an odd vote count: the kernels mask the tail instead of asking for a
    # multiple of a block
    votes = _votes(g, 1_000_003, cuda)
    bn = -(-g // pf)
    kw = dict(gx=g, gy=g, by_n=bn, bz_n=bn, pfy=pf, pfz=pf, splat=splat)
    before = dict(vote_hist.LAUNCHES)
    _close(vote_hist.bound_projections(*votes, **kw),
           vote_hist.bound_projections_plain(*votes, **kw))
    for start in (0, g // 2 // W8 * W8, g - W8):
        o = torch.full((3,), start, dtype=torch.int32, device=cuda)
        _close([vote_hist.refine_window(o, *votes, w8=W8, splat=splat)],
               [vote_hist.refine_window_plain(o, *votes, w8=W8, splat=splat)])
    assert vote_hist.LAUNCHES["bound_projections"] == before["bound_projections"] + 1
    assert vote_hist.LAUNCHES["refine_window"] == before["refine_window"] + 3


@pytest.mark.cuda
@pytest.mark.parametrize("g,pf", GRIDS)
def test_nearest_unit_votes_count_exactly(cuda, g, pf):
    """Nearest splat with unit weights, as the bench cell's fast mode votes
    (phase 21): every tap is a whole fixed-point unit, so both peak kernels
    give whole counts, the plain version's to the bit (the bound pass's
    rounding up adds nothing to a whole unit)."""
    votes = _votes(g, 1_000_003, cuda)
    votes[-1] = (votes[-1] > 0).float()
    bn = -(-g // pf)
    kw = dict(gx=g, gy=g, by_n=bn, bz_n=bn, pfy=pf, pfz=pf, splat="nearest")
    for got, want in zip(vote_hist.bound_projections(*votes, **kw),
                         vote_hist.bound_projections_plain(*votes, **kw)):
        assert torch.equal(got, want)
        assert torch.equal(got, got.round())
    for start in (0, g // 2 // W8 * W8, g - W8):
        o = torch.full((3,), start, dtype=torch.int32, device=cuda)
        got = vote_hist.refine_window(o, *votes, w8=W8, splat="nearest")
        assert torch.equal(got, vote_hist.refine_window_plain(o, *votes, w8=W8,
                                                              splat="nearest"))


def _pair_inputs(g, device, adaptive, p=20_003, keep=0.9, seed=1):
    """Pairs whose vote circles cross near one center of a g³ grid at 4 mm:
    (pc, preds_tr, probs, idxs, corner, dims, pair_mask) on ``device``.  The
    pair count is odd, so no multiple of a warp or a 16-byte load."""
    rng = np.random.default_rng(seed)
    n, res = 256, 4e-3
    pc = (rng.normal(size=(n, 3)) * 0.04).astype(np.float32)
    idxs = rng.integers(0, n, (p, 2)).astype(np.int32)
    idxs[:5, 1] = idxs[:5, 0]
    a, b = pc[idxs[:, 0]], pc[idxs[:, 1]]
    d = (a - b) / (np.linalg.norm(a - b, axis=-1, keepdims=True) + 1e-7)
    proj = np.sum(a * d, -1)
    odist = np.linalg.norm(a - proj[:, None] * d, axis=-1)
    preds_tr = np.stack([proj, odist], -1).astype(np.float32)
    if adaptive:  # short circles too, which adaptive voting samples sparsely
        preds_tr[::3, 1] *= 0.1
    corner = (pc.min(0) - 0.02).astype(np.float32)
    dims = np.float32([g - 3, g - 1, g + 4])
    arrs = (pc, preds_tr, rng.random(n).astype(np.float32), idxs, corner, dims,
            rng.random(p) < keep)
    return [torch.from_numpy(x).to(device) for x in arrs]


def _double(votes):
    """The votes with float64 fractions and weight: the plain versions then
    sum in float64."""
    return [*votes[:3], *(t.double() for t in votes[3:])]


def _float(tensors):
    return [t.float() for t in tensors]


def _bounds(got, exact, under=1e-6, over=1e-4):
    """The bound pass's sums against the exact ones: above by the taps'
    round-up at most, below by float rounding at most."""
    scale = max(float(e.max()) for e in exact)
    assert scale > 0
    for g, e in zip(got, exact):
        diff = g - e
        assert float(diff.min()) >= -under * scale, float(diff.min()) / scale
        assert float(diff.max()) <= over * scale, float(diff.max()) / scale


@pytest.mark.cuda
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("splat", ["trilinear", "nearest"])
@pytest.mark.parametrize("g,pf", GRIDS)
def test_front_ends_match_plain(cuda, g, pf, splat, adaptive):
    """Both front ends of both peak kernels against the plain version summed
    in float64, on votes made from the same pair parameters."""
    res, n_rots = 4e-3, 72
    pc, preds_tr, probs, idxs, corner, dims, mask = _pair_inputs(g, cuda, adaptive)
    params = voting.pair_vote_params(pc, preds_tr, probs, idxs, res, n_rots, adaptive, mask)
    frame = vote_hist.vote_frame(corner, res, dims)
    f, r, w = voting.votes_from_pair_params(params, corner, res, dims, (g, g, g), n_rots)
    votes = [t.reshape(-1).contiguous() for t in (*f, *r, w)]
    bn = -(-g // pf)
    kw = dict(by_n=bn, bz_n=bn, pfy=pf, pfz=pf, splat=splat)
    pkw = dict(n_rots=n_rots, grid_shape=(g, g, g))
    pairs_rel = 1e-3 if adaptive else 1e-5
    before = dict(vote_hist.LAUNCHES)
    exact = _float(vote_hist.bound_projections_plain(*_double(votes), gx=g, gy=g, **kw))
    _bounds(vote_hist.bound_projections(*votes, gx=g, gy=g, **kw), exact)
    got = vote_hist.bound_projections_pairs(params, frame, **pkw, **kw)
    if adaptive:
        _close(got, exact, rel=pairs_rel)
    else:
        _bounds(got, exact)
    peak = torch.argmax(exact[0]) // bn
    for start in (0, int(peak) // W8 * W8, g - W8):
        o = torch.tensor([start, int(peak) // W8 * W8, start], dtype=torch.int32, device=cuda)
        exact_w = vote_hist.refine_window_plain(o, *_double(votes), w8=W8, splat=splat).float()
        if float(exact_w.max()) == 0:
            assert float(vote_hist.refine_window_pairs(o, params, frame, **pkw, w8=W8,
                                                       splat=splat).abs().max()) == 0
            continue
        _close([vote_hist.refine_window(o, *votes, w8=W8, splat=splat)], [exact_w])
        _close([vote_hist.refine_window_pairs(o, params, frame, **pkw, w8=W8, splat=splat)],
               [exact_w], rel=pairs_rel)
    assert vote_hist.LAUNCHES["bound_projections_pairs"] == before["bound_projections_pairs"] + 1
    assert vote_hist.LAUNCHES["refine_window_pairs"] == before["refine_window_pairs"] + 3


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["peaked point weights", "half the pairs masked"])
def test_front_ends_weights_and_mask(cuda, case):
    """Both front ends of both peak kernels against float64 sums on the
    pooled 152³ grid (pool 4), with the weights of a second center pass
    (0.05 + 0.95·score, most points near the floor) or with a bool pair
    mask that drops about half the pairs."""
    g, pf, res, n_rots = 152, 4, 4e-3, 72
    pc, preds_tr, probs, idxs, corner, dims, mask = _pair_inputs(g, cuda, False)
    gen = torch.Generator(device="cpu").manual_seed(2)
    if case == "peaked point weights":
        score = torch.clamp(torch.rand(probs.shape[0], generator=gen) * 4 - 3, 0, 1)
        probs = (0.05 + 0.95 * score).to(cuda)
        mask = torch.ones_like(mask)
    else:
        probs = torch.ones_like(probs)
        mask = (torch.rand(mask.shape[0], generator=gen) < 0.5).to(cuda)
    params = voting.pair_vote_params(pc, preds_tr, probs, idxs, res, n_rots, False, mask)
    frame = vote_hist.vote_frame(corner, res, dims)
    f, r, w = voting.votes_from_pair_params(params, corner, res, dims, (g, g, g), n_rots)
    votes = [t.reshape(-1).contiguous() for t in (*f, *r, w)]
    bn = -(-g // pf)
    kw = dict(by_n=bn, bz_n=bn, pfy=pf, pfz=pf)
    pkw = dict(n_rots=n_rots, grid_shape=(g, g, g))
    exact = _float(vote_hist.bound_projections_plain(*_double(votes), gx=g, gy=g, **kw))
    _bounds(vote_hist.bound_projections(*votes, gx=g, gy=g, **kw), exact)
    _bounds(vote_hist.bound_projections_pairs(params, frame, **pkw, **kw), exact)
    ix, iy = divmod(int(torch.argmax(exact[0])), bn)
    iz = int(torch.argmax(exact[1])) % bn
    o = torch.tensor([min(v // W8 * W8, g - W8) for v in (ix, iy * pf, iz * pf)],
                     dtype=torch.int32, device=cuda)
    exact_w = [vote_hist.refine_window_plain(o, *_double(votes), w8=W8).float()]
    assert float(exact_w[0].max()) > 0
    _close([vote_hist.refine_window(o, *votes, w8=W8)], exact_w)
    _close([vote_hist.refine_window_pairs(o, params, frame, **pkw, w8=W8)], exact_w)


@pytest.mark.cuda
@pytest.mark.parametrize("gain", [1e-20, 1e-6, 1e4])
def test_fixed_point_scale_follows_the_weights(cuda, gain):
    """The blocks' fixed-point scale comes from their own vote mass, so
    weights of any magnitude keep the kernels within their tolerance."""
    g, res, n_rots = 64, 4e-3, 72
    pc, preds_tr, probs, idxs, corner, dims, mask = _pair_inputs(g, cuda, False, p=5001)
    params = voting.pair_vote_params(pc, preds_tr, probs, idxs, res, n_rots, False,
                                     mask.float() * gain)
    frame = vote_hist.vote_frame(corner, res, dims)
    f, r, w = voting.votes_from_pair_params(params, corner, res, dims, (g, g, g), n_rots)
    votes = [t.reshape(-1).contiguous() for t in (*f, *r, w)]
    kw = dict(by_n=g, bz_n=g, pfy=1, pfz=1)
    pkw = dict(n_rots=n_rots, grid_shape=(g, g, g))
    exact = _float(vote_hist.bound_projections_plain(*_double(votes), gx=g, gy=g, **kw))
    _bounds(vote_hist.bound_projections(*votes, gx=g, gy=g, **kw), exact)
    _bounds(vote_hist.bound_projections_pairs(params, frame, **pkw, **kw), exact)
    live = votes[6] != 0  # a window that holds the median live vote
    o = torch.stack([v[live].median() for v in votes[:3]]).to(torch.int32) // W8 * W8
    exact_w = [vote_hist.refine_window_plain(o, *_double(votes), w8=W8).float()]
    _close([vote_hist.refine_window(o, *votes, w8=W8)], exact_w)
    _close([vote_hist.refine_window_pairs(o, params, frame, **pkw, w8=W8)], exact_w)


@pytest.mark.cuda
def test_all_masked_gives_zeros(cuda):
    g, res, n_rots = 64, 4e-3, 72
    pc, preds_tr, probs, idxs, corner, dims, _ = _pair_inputs(g, cuda, False, p=1001)
    mask = torch.zeros(idxs.shape[0], dtype=torch.bool, device=cuda)
    params = voting.pair_vote_params(pc, preds_tr, probs, idxs, res, n_rots, False, mask)
    frame = vote_hist.vote_frame(corner, res, dims)
    f, r, w = voting.votes_from_pair_params(params, corner, res, dims, (g, g, g), n_rots)
    votes = [t.reshape(-1).contiguous() for t in (*f, *r, w)]
    assert float(w.abs().max()) == 0
    kw = dict(by_n=g, bz_n=g, pfy=1, pfz=1)
    o = torch.full((3,), 16, dtype=torch.int32, device=cuda)
    outs = [*vote_hist.bound_projections(*votes, gx=g, gy=g, **kw),
            *vote_hist.bound_projections_pairs(params, frame, n_rots=n_rots,
                                               grid_shape=(g, g, g), **kw),
            vote_hist.refine_window(o, *votes, w8=W8),
            vote_hist.refine_window_pairs(o, params, frame, n_rots=n_rots,
                                          grid_shape=(g, g, g), w8=W8)]
    for t in outs:
        assert float(t.abs().max()) == 0


@pytest.mark.cuda
def test_peak_on_card_matches_cpu(cuda):
    """ppf_vote_peak through the pairs kernels returns a voxel that is a
    maximum of the CPU ppf_vote grid (to rtol 1e-5: sums in another order),
    and that grid's peak value."""
    res = 4e-3
    pc, preds_tr, probs, idxs, corner, dims, mask = _pair_inputs(64, "cpu", False, p=4096)
    args = (pc, preds_tr, probs, idxs, corner)
    grid = voting.ppf_vote(*args, res, dims.int(), (64, 64, 64), pair_mask=mask)
    before = dict(vote_hist.LAUNCHES)
    idx, peak = voting.ppf_vote_peak(*(t.to(cuda) for t in args), res, dims.int().to(cuda),
                                     (64, 64, 64), pair_mask=mask.to(cuda), max_rounds=0)
    assert vote_hist.LAUNCHES["bound_projections_pairs"] == before["bound_projections_pairs"] + 1
    assert vote_hist.LAUNCHES["refine_window_pairs"] > before["refine_window_pairs"]
    assert vote_hist.LAUNCHES["bound_projections"] == before["bound_projections"]
    torch.testing.assert_close(grid[tuple(idx.cpu().tolist())], grid.max(), rtol=1e-5, atol=0)
    torch.testing.assert_close(peak.cpu(), grid.max(), rtol=1e-5, atol=0)


# (fine grid, pool): the sparse route's pool-8 coarse grid (shared-memory
# path), a 48³ window and the unpooled whole-frame grid (global atomics)
DENSE = [((320, 256, 192), (8, 8, 8)), ((48, 48, 48), (1, 1, 1)), ((320, 224, 168), (1, 1, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("splat", ["trilinear", "nearest"])
@pytest.mark.parametrize("g,pool", DENSE)
def test_dense_hist_matches_plain(cuda, g, pool, splat):
    rng = np.random.default_rng(2)
    v = 1_000_003
    f = np.stack([np.clip(rng.normal(gk / 2, gk / 6, v), 0, gk - 2) for gk in g]).astype(np.int32)
    r = rng.random((3, v)).astype(np.float32)
    w = (rng.random(v) < 0.8).astype(np.float32) * rng.random(v).astype(np.float32)
    votes = [torch.from_numpy(a).to(cuda) for a in (*f, *r, w)]
    kw = dict(cx=-(-g[0] // pool[0]), cy=-(-g[1] // pool[1]), cz=-(-g[2] // pool[2]),
              px=pool[0], py=pool[1], pz=pool[2], splat=splat)
    before = vote_hist.LAUNCHES["dense_hist"]
    got = vote_hist.dense_hist(*votes, **kw)
    _close([got], [vote_hist.dense_hist_plain(*votes, **kw)])
    # a second launch adds into the first one's grid
    _close([vote_hist.dense_hist(*votes, **kw, out=got)],
           [2 * vote_hist.dense_hist_plain(*votes, **kw)])
    assert vote_hist.LAUNCHES["dense_hist"] == before + 2


# dense_hist's three routes on pairs whose votes spread over the grid:
# (fine grid, pool, res, pairs).  The sparse route's pool-8 coarse grid
# (shared memory, fixed point), a 48³ window and the zero-shot frame's
# unpooled 320×224×168 grid (global float atomics).
DENSE_PAIRS = [((320, 256, 192), (8, 8, 8), 1e-3, 50_003), ((48, 48, 48), (1, 1, 1), 6e-3, 5_003),
               ((320, 224, 168), (1, 1, 1), 1e-3, 20_003)]


def _dense_pairs(g, res, device, adaptive, p=50_003, gain=1.0, keep=0.9):
    """A pair block whose circles cover most of a g grid at ``res``, its
    frame, and its votes (plain votes_from_pair_params)."""
    pc, preds_tr, probs, idxs, _, _, mask = _pair_inputs(64, device, adaptive, p=p, keep=keep)
    s = 0.8 * max(g) * res / 0.25  # the cloud, ~0.25 m across, to 80 % of the grid
    pc, preds_tr = pc * s, preds_tr * s
    # circles through one center would pile ~1e4 terms into a cell, where
    # float32 sums in any order stray ~1e-5 from float64: spread the centers
    shift = np.random.default_rng(3).normal(0, 0.1 * max(g) * res, p).astype(np.float32)
    preds_tr[:, 0] += torch.from_numpy(shift).to(device)
    corner = pc.min(0).values
    dims = torch.tensor(g, dtype=torch.float32, device=device) - 1
    params = voting.pair_vote_params(pc, preds_tr, probs, idxs, res, 72, adaptive,
                                     mask.float() * gain)
    frame = vote_hist.vote_frame(corner, res, dims)
    f, r, w = voting.votes_from_pair_params(params, corner, res, dims, g, 72)
    return params, frame, [t.reshape(-1).contiguous() for t in (*f, *r, w)]


@pytest.mark.cuda
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("splat", ["trilinear", "nearest"])
@pytest.mark.parametrize("g,pool,res,p", DENSE_PAIRS)
def test_dense_front_ends_match_plain(cuda, g, pool, res, p, splat, adaptive):
    """Both front ends of dense_hist against the plain version summed in
    float64 on the same votes, once into a zeroed grid and once added into
    that grid."""
    params, frame, votes = _dense_pairs(g, res, cuda, adaptive, p=p)
    kw = dict(cx=-(-g[0] // pool[0]), cy=-(-g[1] // pool[1]), cz=-(-g[2] // pool[2]),
              px=pool[0], py=pool[1], pz=pool[2], splat=splat)
    exact = vote_hist.dense_hist_plain(*_double(votes), **kw).float()
    assert float((votes[6] != 0).sum()) > 10 * p
    before = dict(vote_hist.LAUNCHES)
    got = vote_hist.dense_hist(*votes, **kw)
    _close([got], [exact])
    _close([vote_hist.dense_hist(*votes, **kw, out=got)], [2 * exact])
    pairs_rel = 1e-3 if adaptive else 1e-5
    got = vote_hist.dense_hist_pairs(params, frame, n_rots=72, grid_shape=g, **kw)
    _close([got], [exact], rel=pairs_rel)
    _close([vote_hist.dense_hist_pairs(params, frame, n_rots=72, grid_shape=g, **kw, out=got)],
           [2 * exact], rel=pairs_rel)
    assert vote_hist.LAUNCHES["dense_hist"] == before["dense_hist"] + 2
    assert vote_hist.LAUNCHES["dense_hist_pairs"] == before["dense_hist_pairs"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("gain", [1e-20, 1e-6, 1e4])
@pytest.mark.parametrize("g,pool,res,p", DENSE_PAIRS[:2])
def test_dense_fixed_point_scale_follows_the_weights(cuda, g, pool, res, p, gain):
    """The shared route's fixed-point scale comes from each block's vote
    mass, so weights of any magnitude keep both front ends within 1e-5; the
    global route beside it."""
    params, frame, votes = _dense_pairs(g, res, cuda, False, p=p, gain=gain)
    kw = dict(cx=-(-g[0] // pool[0]), cy=-(-g[1] // pool[1]), cz=-(-g[2] // pool[2]),
              px=pool[0], py=pool[1], pz=pool[2])
    exact = [vote_hist.dense_hist_plain(*_double(votes), **kw).float()]
    _close([vote_hist.dense_hist(*votes, **kw)], exact)
    _close([vote_hist.dense_hist_pairs(params, frame, n_rots=72, grid_shape=g, **kw)], exact)


@pytest.mark.cuda
@pytest.mark.parametrize("g,pool,res,p", DENSE_PAIRS)
def test_dense_all_masked_gives_zeros(cuda, g, pool, res, p):
    params, frame, votes = _dense_pairs(g, res, cuda, True, p=5001, keep=0.0)
    assert float(votes[6].abs().max()) == 0
    kw = dict(cx=-(-g[0] // pool[0]), cy=-(-g[1] // pool[1]), cz=-(-g[2] // pool[2]),
              px=pool[0], py=pool[1], pz=pool[2])
    assert float(vote_hist.dense_hist(*votes, **kw).abs().max()) == 0
    assert float(vote_hist.dense_hist_pairs(params, frame, n_rots=72, grid_shape=g,
                                            **kw).abs().max()) == 0


# (pairs, rotations, sphere directions, degenerate pairs): the cells' vote,
# with degenerate pairs, a count that fills no block evenly, none, 24
# rotations, and spheres of one warp and of two slices of blocks
SPHERE_CASES = [(10_000, 72, 480, 0), (10_000, 72, 480, 25), (1001, 72, 480, 3), (0, 72, 480, 0),
                (10_000, 24, 480, 0), (2000, 72, 12, 0), (2000, 72, 4000, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_pairs,n_rots,n_sphere,degenerate", SPHERE_CASES)
def test_sphere_count_equals_plain(cuda, n_pairs, n_rots, n_sphere, degenerate):
    pc, angles, idxs, sphere, cos_tol = tsph.instance(n_pairs, n_sphere, seed=n_pairs + n_rots,
                                                      degenerate=degenerate, device=cuda)
    before = vote_hist.LAUNCHES["sphere_count"]
    got = voting.rot_vote_sphere_count(pc, angles, idxs, sphere, cos_tol, n_rots=n_rots)
    torch.cuda.synchronize()
    assert vote_hist.LAUNCHES["sphere_count"] == before + (n_pairs > 0)
    want = voting.rot_vote_sphere_count_plain(pc, angles, idxs, sphere, cos_tol, n_rots=n_rots)
    assert got.dtype == torch.float32 and got.shape == (n_sphere,)
    assert torch.equal(got, want)
    assert n_pairs == 0 or want.sum() > 0


@pytest.mark.cuda
def test_weighted_sphere_count_is_fixed_point(cuda):
    """The same bits every run, within 1e-6 of the float64 sum of each
    direction's hits; unit weights give the unweighted counts."""
    pc, angles, idxs, sphere, cos_tol = tsph.instance(seed=7, degenerate=10, device=cuda)
    w = torch.rand(idxs.shape[0], generator=torch.Generator().manual_seed(7))
    w[::9] = 0.0
    w = w.to(cuda)
    runs = [voting.rot_vote_sphere_count(pc, angles, idxs, sphere, cos_tol, weights=w)
            for _ in range(3)]
    assert all(torch.equal(r, runs[0]) for r in runs)
    exact = tsph.block_counts(voting.sphere_pair_params(pc, angles, idxs, w),
                              voting.cone_table(72, pc), sphere, cos_tol, float64_weights=True)
    assert float(exact.max()) > 10
    assert bool(((runs[0].double() - exact).abs() <= 1e-6 * exact.abs()).all())
    ones = voting.rot_vote_sphere_count(pc, angles, idxs, sphere, cos_tol,
                                        weights=torch.ones_like(w))
    assert torch.equal(ones, voting.rot_vote_sphere_count(pc, angles, idxs, sphere, cos_tol))


@pytest.mark.cuda
@pytest.mark.parametrize("workload,n_poses,votes", [("bottle.stream", 8, 1), ("mug.stream", 4, 2)])
def test_pool_poses_equal_with_the_plain_sphere_count(cuda, monkeypatch, workload, n_poses,
                                                      votes):
    """The benchmark's pool poses, with the kernel and with the plain
    version put in its place: T, R, scales, both axes and the back-vote
    survivors equal.  (The peak's mass, ``grid_max``, may move in its last
    bit from one run to the next by itself: the center vote's blocks add
    their sums with float atomics.)"""
    from portbench import run as R

    from cppf_tpu_torch.pipeline import pose as pose_mod

    bench = R.load_benchmark(os.path.join(os.path.dirname(R.ROOT), "BENCHMARK.json"))
    cell = {w["name"]: w for w in bench["workloads"]}[workload]
    mix = {**R.load_json("traffic", cell["traffic"]), "pool": n_poses}
    ctx = R.Ctx(cell, R.load_json("configs", cell["config"]), mix, 4_400_000_021, cuda, {})
    driver = R.load_module("drivers", mix["driver"])
    served = driver.make(ctx)
    before = vote_hist.LAUNCHES["sphere_count"]
    rows = [driver.unpack(served._pose(k)) for k in range(n_poses)]
    assert vote_hist.LAUNCHES["sphere_count"] == before + votes * n_poses
    monkeypatch.setattr(pose_mod, "rot_vote_sphere_count", voting.rot_vote_sphere_count_plain)
    plain = [driver.unpack(served._pose(k)) for k in range(n_poses)]
    assert vote_hist.LAUNCHES["sphere_count"] == before + votes * n_poses
    for k, (a, b) in enumerate(zip(rows, plain)):
        for name in ("T", "R", "scale", "up", "right", "n_filtered"):
            np.testing.assert_array_equal(a[name], b[name], err_msg=f"{workload} pose {k} {name}")
