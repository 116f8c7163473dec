"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc (``cuda`` marker) and skip
elsewhere.  They import only torch and the port, so they also run where
JAX is not installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_kernels.py``.  Tolerances: atomics reorder the float
sums, so kernel and plain version agree to rounding (rtol 1e-5 of the
largest cell).
"""
import numpy as np
import pytest
import torch

from cppf_tpu_torch.ops import vote_hist
from cppf_tpu_torch.ops import voting

W8 = 16
GRIDS = [(64, 1), (120, 2)]


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


def _close(got, expect):
    scale = max(float(e.abs().max()) for e in expect)
    for g, e in zip(got, expect):
        torch.testing.assert_close(g, e, atol=1e-5 * scale, rtol=0)


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
def test_peak_on_card_matches_cpu(cuda):
    """ppf_vote_peak through the kernels finds the CPU path's peak."""
    rng = np.random.default_rng(1)
    n, p, res = 256, 4096, 4e-3
    pc = (rng.normal(size=(n, 3)) * 0.04).astype(np.float32)
    idxs = rng.integers(0, n, (p, 2)).astype(np.int32)
    a, b = pc[idxs[:, 0]], pc[idxs[:, 1]]
    d = (a - b) / (np.linalg.norm(a - b, axis=-1, keepdims=True) + 1e-7)
    proj = np.sum(a * d, -1)
    odist = np.linalg.norm(a - proj[:, None] * d, axis=-1)
    preds_tr = np.stack([proj, odist], -1).astype(np.float32)
    corner = (pc.min(0) - 0.01).astype(np.float32)
    dims = ((pc.max(0) - corner) / res).astype(np.int32) + 1
    args = [pc, preds_tr, np.ones(n, np.float32), idxs, corner]
    out = {}
    for dev in ("cpu", cuda):
        t = [torch.from_numpy(x).to(dev) for x in args]
        out[str(dev)] = voting.ppf_vote_peak(*t, res, torch.from_numpy(dims).to(dev),
                                             (64, 64, 64), max_rounds=0)
    idx_c, peak_c = out["cpu"]
    idx_g, peak_g = out["cuda"]
    assert torch.equal(idx_c, idx_g.cpu())
    torch.testing.assert_close(peak_g.cpu(), peak_c, rtol=1e-5, atol=0)


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
