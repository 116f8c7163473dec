"""The SUN RGB-D driver's spans and the center gate's device counters
(utils/prof.py) on the CPU: the span tree of a scan, the gate's span only
where a gate is on, the counters against the gate's mask, the benchmark's
readers of them where they are missing, and the runner's cached gravity
gate."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cppf_tpu_torch.data.synthetic import PRIMITIVES, sample_surface
from cppf_tpu_torch.eval import sunrgbd_inference as S
from cppf_tpu_torch.pipeline import pose as P
from cppf_tpu_torch.utils import prof

TABLE_STAGES = ["pose.preprocess", "pose.network", "pose.center_gate", "pose.center_vote",
                "pose.backvote", "pose.axis_vote", "pose.axis_vote"]


def small_table() -> S.CategoryRunner:
    runner = S.load_runner("table", S.build_parser().parse_args(["--device", "cpu"]))
    runner.pcfg = dataclasses.replace(runner.pcfg, n_pairs=2048, rot_subsample=1000)
    runner.cfg.npoint_pad = 512
    return runner


def table_cloud(seed: int, n: int = 3000) -> np.ndarray:
    """A table's surface samples 2.5 m in front of the camera, 1 m below it."""
    pts = sample_surface(PRIMITIVES["table"](), n, np.random.default_rng(seed))
    return (pts + np.float32([0.0, -1.0, 2.5])).astype(np.float32)


def profiled(fn):
    """(fn's result, the spans it recorded, the device counters) under a CPU
    profiler."""
    prof.clear_spans()
    prof.clear_device_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    spans, counters = prof.spans(), prof.device_counters()
    prof.clear_spans()
    prof.clear_device_counters()
    return out, spans, counters


def test_scan_span_tree():
    """A scan of two tables: one root ``scan`` holding each instance's
    ``draws`` and ``pose``, the stages under their pose with the gate's
    span between the network and the center vote."""
    runner = small_table()
    items = [(0, table_cloud(0)), (3, table_cloud(1, 2000))]
    (rows, _, timing), spans, _ = profiled(
        lambda: S.pose_instances(runner, items, (0, 11), S.TYPE2CLASS["table"]))
    assert len(rows) == 2 and [t[:2] for t in timing] == [(0, 3000), (3, 2000)]
    scan = spans[0]
    assert scan.name == "scan" and scan.parent is None and scan.attrs == {"instances": 2}
    assert all(s.root == scan.id for s in spans)
    assert [s.root for s in spans if s.parent is None] == [scan.id]
    top = [s for s in spans if s.parent == scan.id]
    assert [s.name for s in top] == ["draws", "pose", "draws", "pose"]
    for pose in (top[1], top[3]):
        assert [s.name for s in spans if s.parent == pose.id] == TABLE_STAGES


@pytest.mark.parametrize("flags,opens", [({}, True), ({"filter_coplanar": False}, False),
                                         ({"filter_coplanar": False, "pair_sep_power": 1.0},
                                          True),
                                         ({"filter_coplanar": False,
                                           "coplanar_halfspace": True}, True)])
def test_center_gate_span_opens_only_with_a_gate(flags, opens):
    runner = small_table()
    runner.pcfg = dataclasses.replace(runner.pcfg, **flags)
    _, spans, counters = profiled(lambda: runner.estimate(table_cloud(2)))
    assert [s.name for s in spans].count("pose.center_gate") == int(opens)
    assert ("center_pairs_gated" in counters) == opens


def _vote_inputs(runner, seed: int):
    draws = runner.draws((0, seed))
    pre = runner.preprocess(table_cloud(seed), draws)
    idx, preds = P.pair_predictions(runner.point_encoder, runner.ppf_encoder, pre.pc,
                                    pre.normals, pre.n_valid, runner.pcfg, draws.pair_u,
                                    pre.nbr_idx)
    return pre, idx, preds, draws


@pytest.mark.parametrize("flags", [{}, {"pair_sep_power": 1.0}])
def test_device_counters_are_the_masks_sums(flags, monkeypatch):
    """Under a profiler the counters add, each center pass, the pairs the
    gate reads and those of nonzero weight in its mask; they call no
    host-sync site more than the same pose unprofiled, and a pose with no
    profiler counts nothing."""
    runner = small_table()
    runner.pcfg = dataclasses.replace(runner.pcfg, **flags)
    pre, idx, preds, draws = _vote_inputs(runner, 3)
    mask = P.center_vote_masks(pre.pc, pre.normals, idx, runner.pcfg)[0]
    calls = []
    sync = prof.host_sync
    monkeypatch.setattr(prof, "host_sync", lambda *a, **k: calls.append(1) or sync(*a, **k))

    def vote():
        return P.vote_pose(pre.pc, pre.normals, idx, preds, pre.n_valid, runner.sphere,
                           runner.pcfg, draws)

    before = prof.COUNTERS["host_syncs"]
    prof.clear_device_counters()
    plain = vote()
    n_plain = len(calls)
    assert prof.device_counters() == {}
    out, _, counters = profiled(vote)
    assert len(calls) == 2 * n_plain and prof.COUNTERS["host_syncs"] == before
    assert counters == {"center_pairs_gated": idx.shape[0],
                        "center_pairs_voting": int(torch.count_nonzero(mask))}
    assert 0 < counters["center_pairs_voting"] < idx.shape[0]
    assert torch.equal(out.T, plain.T) and torch.equal(out.R, plain.R)


def test_device_count_adds_where_the_value_lives():
    prof.clear_device_counters()
    prof.device_count("x", 5)
    assert prof.device_counters() == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        prof.device_count("x", 5)
        prof.device_count("x", torch.tensor(7))
        prof.device_count("y", torch.tensor(2))
    assert prof.device_counters() == {"x": 12, "y": 2}
    prof.clear_device_counters()
    assert prof.device_counters() == {}


def _metric(name):
    from portbench import run as R

    return R.load_module("metrics", name)


NEW_METRICS = ("center_gate_ms_per_pose", "center_voting_pair_share",
               "vote_kernels_roofline_live")


def _rec(trace=None):
    from portbench import run as R

    return SimpleNamespace(poses=4, window_s=1.0, counters={}, trace=trace,
                           cfg=R.load_json("configs", "table"), mix={}, cell={})


@pytest.mark.parametrize("name", NEW_METRICS)
def test_new_metrics_read_nothing_where_nothing_was_recorded(name, monkeypatch):
    """With no span or counter recorded, and on a program without device
    counters at all (as before them), each reader returns None."""
    from portbench.trace import TraceSummary

    trace = TraceSummary(1.0, 0.5, {"bound_pairs_kernel<true>": [4, 1e-3]})
    prof.clear_spans()
    prof.clear_device_counters()
    assert _metric(name).read(_rec(trace)) is None
    monkeypatch.delattr(prof, "device_counters")
    assert _metric(name).read(_rec(trace)) is None


def test_new_metrics_read_the_counters():
    """The voting share is the counters' ratio; the live roofline counts a
    dead pair's first 16 bytes and no votes, so on the same kernels' time
    it reads below the roofline that counts every pair live."""
    from portbench import counts
    from portbench.trace import TraceSummary

    kernels = {"bound_pairs_kernel<true>": [2, 2e-4], "refine_pairs_kernel<true>": [3, 3e-4]}
    trace = TraceSummary(1.0, 0.5, kernels)
    rec = _rec(trace)
    P_ = rec.cfg["n_pairs"]
    prof.clear_device_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        prof.device_count("center_pairs_gated", 2 * P_)
        prof.device_count("center_pairs_voting", torch.tensor(P_ // 2))
    try:
        assert _metric("center_voting_pair_share").read(rec) == pytest.approx(25.0)
        live = _metric("vote_kernels_roofline_live")
        b, ops = live.live_work(rec.cfg, counts.bound_pairs_work, P_ / 4)
        b_all, ops_all = counts.bound_pairs_work(rec.cfg)
        assert ops == pytest.approx(ops_all / 4)
        assert b_all - b == pytest.approx((48 - 16) * P_ * 3 / 4)
        full = _metric("vote_kernels_roofline").read(rec)
        assert 0 < live.read(rec) < full
    finally:
        prof.clear_device_counters()


def test_runner_keeps_one_gravity_gate():
    """The runner makes its up gate once: the same tensor every pose, equal
    to ``up_prior_gate`` made afresh; made again when the prior changes,
    None with it off."""
    runner = small_table()
    gate = runner.up_gate()
    assert runner.up_gate() is gate
    assert torch.equal(gate, P.up_prior_gate(runner.sphere, runner.pcfg))
    assert int(gate.sum()) > 0
    runner.pcfg = dataclasses.replace(runner.pcfg, up_prior_deg=45.0)
    wide = runner.up_gate()
    assert torch.equal(wide, P.up_prior_gate(runner.sphere, runner.pcfg))
    assert int(wide.sum()) > int(gate.sum())
    runner.pcfg = dataclasses.replace(runner.pcfg, up_prior_deg=0.0)
    assert runner.up_gate() is None


def test_cached_gate_gives_the_pose_of_a_fresh_one():
    runner = small_table()
    pc = table_cloud(4)
    draws = runner.draws((0, 4))
    out, _ = runner.estimate(pc, draws=draws)
    pre = runner.preprocess(pc, draws)
    fresh = P.estimate_pose(runner.point_encoder, runner.ppf_encoder, pre.pc, pre.normals,
                            pre.n_valid, runner.sphere, runner.pcfg, nbr_idx=pre.nbr_idx,
                            draws=draws)
    assert torch.equal(out.T, fresh.T) and torch.equal(out.R, fresh.R)
