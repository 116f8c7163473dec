"""The axis vote's sphere count on the CPU: the route each device takes,
what the kernel's wrapper refuses, and the arithmetic the kernel does
(``tests/torch_sphere.py::block_counts``, the kernel's operation order in
plain PyTorch) against the plain version, to the bit.  The kernel itself is
held to the plain version on the card in tests/test_torch_cuda_kernels.py."""
from fractions import Fraction

import numpy as np
import pytest
import torch

import torch_sphere as tsph
from cppf_tpu_torch.ops import vote_hist
from cppf_tpu_torch.ops import voting

torch.set_num_threads(1)


def _weights(n, seed=1):
    rng = np.random.default_rng(seed)
    w = rng.uniform(size=n).astype(np.float32)
    w[::7] = 0.0
    return torch.from_numpy(w)


@pytest.mark.parametrize("weighted", [False, True])
def test_cpu_tensors_take_the_plain_route(weighted):
    pc, angles, idxs, sphere, cos_tol = tsph.instance(300, seed=2, degenerate=3)
    w = _weights(300) if weighted else None
    before = dict(vote_hist.LAUNCHES)
    got = voting.rot_vote_sphere_count(pc, angles, idxs, sphere, cos_tol, chunk=64, weights=w)
    want = voting.rot_vote_sphere_count_plain(pc, angles, idxs, sphere, cos_tol, chunk=64,
                                              weights=w)
    assert torch.equal(got, want)
    assert got.sum() > 0
    assert vote_hist.LAUNCHES == before


@pytest.mark.parametrize("n_pairs,n_rots,degenerate", [(500, 72, 0), (333, 24, 7), (257, 72, 40),
                                                       (0, 72, 0)])
def test_block_arithmetic_equals_the_plain_counts(n_pairs, n_rots, degenerate):
    """The kernel's arithmetic on ``sphere_pair_params``' block gives the
    plain version's counts to the bit: the block holds what each axis
    derives from, and the order of operations is the plain version's."""
    pc, angles, idxs, sphere, cos_tol = tsph.instance(n_pairs, seed=3, degenerate=degenerate)
    pairs = voting.sphere_pair_params(pc, angles, idxs)
    assert pairs.shape == (n_pairs, 12) and pairs.dtype == torch.float32
    assert pairs.is_contiguous()
    assert int(pairs[:, 7].sum()) == degenerate
    got = tsph.block_counts(pairs, voting.cone_table(n_rots, pc), sphere, cos_tol, chunk=100)
    want = voting.rot_vote_sphere_count_plain(pc, angles, idxs, sphere, cos_tol, n_rots=n_rots,
                                              chunk=128)
    assert torch.equal(got, want)
    assert n_pairs == 0 or want.sum() > 100


def test_block_carries_the_weights():
    pc, angles, idxs, sphere, cos_tol = tsph.instance(200, seed=4)
    w = _weights(200)
    pairs = voting.sphere_pair_params(pc, angles, idxs, w)
    assert torch.equal(pairs[:, 11], w)
    assert torch.equal(voting.sphere_pair_params(pc, angles, idxs)[:, 11], torch.zeros(200))
    got = tsph.block_counts(pairs, voting.cone_table(72, pc), sphere, cos_tol,
                            float64_weights=True)
    want = voting.rot_vote_sphere_count_plain(pc, angles, idxs, sphere, cos_tol, weights=w)
    assert got.sum() > 10
    torch.testing.assert_close(got.to(torch.float32), want, atol=1e-5 * float(want.max()),
                               rtol=0)


def _wrapper_args():
    pc, angles, idxs, sphere, cos_tol = tsph.instance(50, seed=5)
    return voting.sphere_pair_params(pc, angles, idxs), voting.cone_table(72, pc), sphere


@pytest.mark.parametrize("what", ["float64 pairs", "float64 sphere", "table on another device",
                                  "sphere on another device", "strided pairs", "pairs of 11",
                                  "sphere of 4", "table of 3 rows", "cpu tensors"])
def test_wrapper_refuses(what):
    """The kernel's wrapper raises on what the kernel does not take, before
    anything launches; CPU tensors, whose route is the plain version, too."""
    pairs, table, sphere = _wrapper_args()
    change = {
        "float64 pairs": lambda: (pairs.double(), table, sphere),
        "float64 sphere": lambda: (pairs, table, sphere.double()),
        "table on another device": lambda: (pairs, table.to("meta"), sphere),
        "sphere on another device": lambda: (pairs, table, sphere.to("meta")),
        "strided pairs": lambda: (torch.cat([pairs, pairs], 1)[:, ::2], table, sphere),
        "pairs of 11": lambda: (pairs[:, :11].contiguous(), table, sphere),
        "sphere of 4": lambda: (pairs, table, torch.cat([sphere, sphere[:, :1]], 1)),
        "table of 3 rows": lambda: (pairs, torch.cat([table, table[:1]]), sphere),
        "cpu tensors": lambda: (pairs, table, sphere),
    }[what]
    before = dict(vote_hist.LAUNCHES)
    with pytest.raises(ValueError):
        vote_hist.sphere_count(*change(), 0.99)
    assert vote_hist.LAUNCHES == before


@pytest.mark.parametrize("max_w,n_terms", [(1.0, 720_000), (0.37, 720_000), (3e-30, 7),
                                           (5e20, 1 << 20), (0.0, 720_000), (1.0, 1)])
def test_fixed_shift_keeps_the_sums_inside_int64(max_w, n_terms):
    w = torch.tensor([0.5 * max_w, -max_w, 0.0], dtype=torch.float32)
    k = vote_hist.fixed_shift(w, n_terms)
    assert k.dtype == torch.int32 and k.dim() == 0
    k = int(k)
    if max_w == 0.0:
        assert k == 62 - n_terms.bit_length()
        return
    top = Fraction(float(w.abs().max())) * Fraction(2) ** k * n_terms
    assert Fraction(2) ** 60 <= top < Fraction(2) ** 62
