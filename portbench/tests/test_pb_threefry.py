"""The reference's threefry and the frames driver's key schedule against
the program's (``cppf_tpu_torch.core.threefry``, ``PoseDraws``)."""
import dataclasses

import pytest
import torch

from portbench import draws as D
from portbench.reference import threefry as tf
from portbench.tests.helpers import small_cell

KEYS = [(0, 0), (0, 42), (0x12345678, 0x9ABCDEF0), tf.key_of_seed(3_000_000_017)]


@pytest.mark.parametrize("key", KEYS)
def test_threefry_matches_the_program(key):
    from cppf_tpu_torch.core import threefry as prog

    assert tf.split(key, 5) == prog.split(key, 5)
    u, g, n = prog.draw_many([("uniform", key, (7, 3)), ("gumbel", key, (11,)),
                              ("normal", key, (5, 3))], "cpu")
    assert torch.equal(tf.uniform(key, (7, 3), "cpu"), u)
    assert torch.equal(tf.gumbel(key, (11,), "cpu"), g)
    assert torch.equal(tf.normal(key, (5, 3), "cpu"), n)


@pytest.mark.parametrize("workload,n_crops", [("bottle.frames", 1), ("bottle.frames", 3),
                                              ("mug.stream", 2), ("mug.stream", 6)])
def test_frame_draws_follow_the_driver(workload, n_crops):
    """A frame's draws as ``infer_frame`` derives them: a lone crop on
    ``runner.draws`` of its key, a chunk on ``estimate_batch``'s split."""
    from cppf_tpu_torch.core import threefry as prog
    from cppf_tpu_torch.eval.nocs_inference import CategoryRunner
    from cppf_tpu_torch.pipeline.pose import PoseDraws

    _, cfg, _ = small_cell(workload)
    runner = CategoryRunner(cfg["category"], device="cpu")
    pcfg = dataclasses.replace(runner.pcfg, n_pairs=cfg["n_pairs"],
                               rot_subsample=cfg["rot_subsample"])
    frame_key = prog.key(1234)
    ours = D.frame_draws(cfg, frame_key, n_crops, 4, "cpu")
    rng, theirs = frame_key, []
    if n_crops == 1:
        rng, r_inst, _ = prog.split(rng, 3)
        theirs.append(PoseDraws.from_jax_key(pcfg, r_inst, "cpu", n_raw=cfg["npoint_max"]))
    else:
        for k in range(0, n_crops, 4):
            n = min(4, n_crops - k)
            rng, r_chunk = prog.split(rng)
            pad = 1 << (n - 1).bit_length()
            keys = prog.split(r_chunk, 2 * pad)
            theirs += [PoseDraws.from_jax_keys(pcfg, keys[i], keys[pad + i], "cpu",
                                               n_raw=cfg["npoint_max"]) for i in range(n)]
    assert len(ours) == len(theirs)
    for d, t in zip(ours, theirs):
        assert torch.equal(d["pair_u"], t.pair_u)
        assert torch.equal(d["tr_gumbel"], t.tr_gumbel)
        assert torch.equal(d["jitter"], t.jitter)
        assert torch.equal(d["fallback"], t.fallback_normal)
        assert torch.equal(d["up_sub"], t.up.sub_u) and torch.equal(d["up_gumbel"], t.up.gumbel)
        if cfg["regress_right"]:
            assert torch.equal(d["right_sub"], t.right.sub_u)
            assert torch.equal(d["right_gumbel"], t.right.gumbel)
