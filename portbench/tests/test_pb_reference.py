"""The plain reference against the program's CPU path: the same crop and
draws give the same pose, and the reference's judge reads the program's
pose as its own; the reference follows the benchmark's configurations and
refuses one that turns on a mechanism it does not implement."""
import dataclasses

import numpy as np
import pytest
import torch

from portbench import draws as D
from portbench import gen
from portbench import run as R
from portbench.drivers.stream import to_pose_draws
from portbench.reference import model
from portbench.reference import pose as ref
from portbench.tests.helpers import SMALL, small_cell

FIELDS = ("T", "R", "scale", "up", "right", "n_filtered", "grid_max")


@pytest.mark.parametrize("workload", ["bottle.stream", "mug.stream"])
def test_reference_is_the_program_on_the_cpu(workload):
    from cppf_tpu_torch.eval.nocs_inference import CategoryRunner

    torch.set_num_threads(4)
    _, cfg, mix = small_cell(workload)
    runner = CategoryRunner(cfg["category"], device="cpu")
    runner.pcfg = dataclasses.replace(runner.pcfg, n_pairs=SMALL["n_pairs"],
                                      rot_subsample=SMALL["rot_subsample"])
    runner.cfg.npoint_pad = SMALL["npoint_pad"]
    weights = model.load_weights(f"portbench/{cfg['weights']}", "cpu")
    crops = gen.make_crops(cfg["category"], mix, cfg["scale_range"], 2, np.random.default_rng(7))
    draws = D.pool_draws(cfg, 2, torch.Generator().manual_seed(7), "cpu")
    for crop, d in zip(crops, draws):
        out, pre = runner.estimate(crop, draws=to_pose_draws(d))
        p = ref.prepare(cfg, weights, crop, d)
        assert p.n_valid == int(pre.n_valid)
        est = ref.estimate(p, d)
        for k in ("T", "up", "right", "scale"):
            np.testing.assert_allclose(est[k].numpy(), getattr(out, k).numpy(), atol=1e-6)
        assert est["n_filtered"] == float(out.n_filtered)
        nums = ref.judge(p, d, {k: getattr(out, k) for k in FIELDS})
        for k, v in nums.items():
            assert v <= 1e-5, (k, v)


def test_judge_reads_a_moved_center_and_a_flipped_axis():
    torch.set_num_threads(4)
    _, cfg, mix = small_cell("bottle.stream")
    weights = model.load_weights(f"portbench/{cfg['weights']}", "cpu")
    crop = gen.make_crops("bottle", mix, cfg["scale_range"], 1, np.random.default_rng(3))[0]
    d = D.pool_draws(cfg, 1, torch.Generator().manual_seed(3), "cpu")[0]
    p = ref.prepare(cfg, weights, crop, d)
    est = ref.estimate(p, d)
    moved = dict(est, T=est["T"] + torch.tensor([0.5 * cfg["res"], 0.0, 0.0]))
    assert ref.judge(p, d, moved)["t_vox"] > 0.4
    flipped = dict(est, up=-est["up"], R=-est["R"])
    assert ref.judge(p, d, flipped)["up_sign"] > 0


@pytest.mark.parametrize("workload", ["bottle.stream", "mug.stream"])
def test_a_near_tie_decode_sent_the_other_way_reads_as_sound(workload, monkeypatch):
    """A sound program whose float32 sums run in another order may send a
    translation decode at a near tie the other way.  The reference's own
    pose with such a decode flipped, one that moves its pair across the
    back-vote's reach so that the axis votes draw another subsample, reads
    as sound while the decode lies within ``DECODE_TIE`` of its tie, and
    not once the tie is drawn tighter than the decode's margin."""
    torch.set_num_threads(4)
    _, cfg, mix = small_cell(workload)
    weights = model.load_weights(f"portbench/{cfg['weights']}", "cpu")
    crop = gen.make_crops(cfg["category"], mix, cfg["scale_range"], 1,
                          np.random.default_rng(11))[0]
    d = D.pool_draws(cfg, 1, torch.Generator().manual_seed(11), "cpu")[0]
    p = ref.prepare(cfg, weights, crop, d)
    est = ref.estimate(p, d)
    monkeypatch.setattr(ref, "DECODE_TIE", float("inf"))
    every = ref.prepare(cfg, weights, crop, d).near
    mask = ref.backvote(p, est["T"])
    reach = ref.backvote(p, est["T"], idx_all=p.idx[every.rows], tr_all=every.tr)
    moves = torch.nonzero(reach != mask[every.rows]).reshape(-1)
    k = int(moves[torch.argmin(every.margin[moves])])
    tr = p.tr.clone()
    tr[every.rows[k]] = every.tr[k]
    flipped = dataclasses.replace(p, tr=tr, near=None)
    flipped.grid1 = ref.center_grid(flipped, torch.ones(p.pc.shape[0]))
    pose = ref.estimate(flipped, d)
    assert pose["n_filtered"] != est["n_filtered"]
    margin = float(every.margin[k])
    monkeypatch.setattr(ref, "DECODE_TIE", 2 * margin)
    nums = ref.judge(ref.prepare(cfg, weights, crop, d), d, pose)
    assert max(nums.values()) <= 1e-5, nums
    monkeypatch.setattr(ref, "DECODE_TIE", margin / 2)
    nums = ref.judge(ref.prepare(cfg, weights, crop, d), d, pose)
    assert nums["survivors_rel"] > 0, nums


def test_a_right_vote_won_by_ups_line_reads_as_sound(monkeypatch):
    """Where the right vote's winner lies on up's own line, the program's
    right axis is rounding noise (or the fallback normal) and no sphere
    direction's projection.  Made so here by giving the mug's right vote the
    up vote's logits, weights and draws: the reference's own pose then reads
    as sound."""
    torch.set_num_threads(4)
    _, cfg, mix = small_cell("mug.stream")
    weights = model.load_weights(f"portbench/{cfg['weights']}", "cpu")
    logits, right_weights = ref.logits, ref._right_weights
    monkeypatch.setattr(ref, "logits", lambda p, axis: logits(p, "up"))
    monkeypatch.setattr(ref, "_right_weights", lambda p, c, u: (right_weights(p, c, u)[0], None))
    off_sphere = 0
    for seed in (1, 2, 5):
        crop = gen.make_crops("mug", mix, cfg["scale_range"], 1, np.random.default_rng(seed))[0]
        d = D.pool_draws(cfg, 1, torch.Generator().manual_seed(seed), "cpu")[0]
        d = dict(d, right_sub=d["up_sub"], right_gumbel=d["up_gumbel"])
        p = ref.prepare(cfg, weights, crop, d)
        est = ref.estimate(p, d)
        proj = p.sphere - (p.sphere @ est["up"])[:, None] * est["up"][None, :]
        proj = proj / (torch.linalg.norm(proj, dim=-1, keepdim=True) + 1e-9)
        off_sphere += float(torch.abs(proj @ est["right"]).max()) < 1 - 1e-6
        nums = ref.judge(p, d, est)
        assert max(nums.values()) <= 1e-5, (seed, nums)
    assert off_sphere >= 2


@pytest.mark.parametrize("config", ["bottle", "mug"])
def test_the_reference_follows_the_benchmarks_configurations(config):
    ref.follows(R.load_json("configs", config))


# another value of each key: one the program runs and the reference does not
OTHER = {"splat": "nearest", "center_mode": "grid", "geo_right_dir": "direct", "axis_topk": 2,
         "filter_coplanar": True, "coplanar_halfspace": True, "up_prior_deg": 30.0,
         "adaptive_voting": True, "sharp_axis_votes": True, "aux_align_weight": True,
         "subvoxel_refine": True, "pair_balance": 0.5, "pair_sep_power": 1.0, "z_right": True}


@pytest.mark.parametrize("key", sorted(ref.FOLLOWS))
def test_the_reference_refuses_a_mechanism_it_does_not_follow(key):
    """Each key of ``FOLLOWS`` at another value, or left out, is refused by
    name."""
    cfg = R.load_json("configs", "bottle")
    with pytest.raises(ValueError, match=key):
        ref.follows({**cfg, key: OTHER[key]})
    with pytest.raises(ValueError, match=f"{key}: not stated"):
        ref.follows({k: v for k, v in cfg.items() if k != key})
