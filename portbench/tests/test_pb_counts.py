"""The operation and byte counts on toy shapes, counted by hand."""
import pytest

from portbench import counts

TOY = {"npoint_pad": 4, "knn": 2, "n_pairs": 3, "rank": 2, "feat_dim": 4,
       "spfcs": [3], "ppffcs": [10, 5, 5], "out_dim": 7, "vote_grid": 16, "num_rots": 2}


def test_encoder_flops_by_hand():
    n, k, p = 4, 2, 3
    kernel = 2 * n * k * (6 * 3 + 3 * 2)          # 6 -> 3 -> rank 2
    contraction = 2 * n * k * 2 * 2                # nkr,nki->nri, i = 2
    outnet = 2 * n * (2 * 2) * 4                   # rank * 2 -> feat_dim
    glob = 2 * n * 4 * 1                           # feat_dim -> feat_dim // 4
    res0 = 2 * p * (10 * 5 + 5 * 5 + 10 * 5)       # fc1, fc2, fc0
    res1 = 2 * p * (5 * 5 + 5 * 5)                 # fc1, fc2
    final = 2 * p * 5 * 7
    assert counts.encoder_flops(TOY) == (kernel + contraction + outnet + glob + res0 + res1
                                         + final)


def test_vote_kernel_work_by_hand():
    # a 16^3 grid is not pooled: projections 16x16 three times
    assert counts.bound_pairs_work(TOY) == (48 * 3 + 28 + 4 * 3 * 16 * 16, 61 * 3 * 2)
    assert counts.refine_pairs_work(TOY) == (48 * 3 + 28 + 4 * 16 ** 3, 20 * 3)
    # 120 voxels pool by 2 to 60 columns
    assert counts.bound_pairs_work({**TOY, "vote_grid": 120})[0] == 48 * 3 + 28 + 4 * 3 * 120 * 60


def test_roofline_picks_its_limit():
    t, by = counts.bound_seconds(3.35e12, 1.0)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = counts.bound_seconds(1.0, 2 * 67e12)
    assert t == pytest.approx(2.0) and by == "operations"
