"""The port's span recorder and host-sync counter (utils/prof.py) on the
CPU: the span tree of a pose and of a NOCS frame, the spans against the
profiler's own ranges, a span with no profiler running, and the count."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from cppf_tpu_torch.eval.nocs_inference import CategoryRunner, infer_frame
from cppf_tpu_torch.models.convert import ASSETS
from cppf_tpu_torch.utils import prof

STAGES = ("pose.preprocess", "pose.network", "pose.center_vote", "pose.backvote",
          "pose.axis_vote")


def small_runner(category: str) -> CategoryRunner:
    runner = CategoryRunner(category, device="cpu")
    runner.pcfg = dataclasses.replace(runner.pcfg, n_pairs=2048, rot_subsample=1000)
    runner.cfg.npoint_pad = 512
    return runner


def view(category: str, i: int = 0) -> np.ndarray:
    return np.load(os.path.join(ASSETS, f"{category}_views.npz"))[f"pc_{i}"]


@pytest.fixture(scope="module")
def mug_trace(tmp_path_factory):
    """One small mug pose under ``prof.trace``: (its spans, the profiler,
    the Chrome trace's events, the cloud)."""
    import json

    runner, pc = small_runner("mug"), view("mug")
    runner.estimate(pc)
    prof.clear_spans()
    log_dir = tmp_path_factory.mktemp("mug_trace")
    with prof.trace(str(log_dir)) as p:
        runner.estimate(pc)
    spans = prof.spans()
    prof.clear_spans()
    with open(log_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    return spans, p, events, pc


def test_pose_span_tree(mug_trace):
    """Mug's pose: one root ``pose`` (the request) holding the stages in
    call order, with both center passes, both back-votes and both axes."""
    spans, _, events, pc = mug_trace
    assert [(s.name, s.attrs.get("pass"), s.attrs.get("axis")) for s in spans] == [
        ("pose", None, None), ("pose.preprocess", None, None), ("pose.network", None, None),
        ("pose.center_vote", 1, None), ("pose.backvote", None, None),
        ("pose.axis_vote", None, "up"), ("pose.center_vote", 2, None),
        ("pose.backvote", None, None), ("pose.axis_vote", None, "right")]
    root = spans[0]
    assert root.parent is None and root.root == root.id and root.attrs["points"] == len(pc)
    for s in spans[1:]:
        assert s.parent == root.id and s.root == root.id
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        assert s.device_s is None  # no CUDA events on the CPU
    for a, b in zip(spans[1:], spans[2:]):
        assert a.end_ns <= b.start_ns  # siblings follow one another
    rounds = [s.attrs["rounds"] for s in spans if s.name == "pose.center_vote"]
    assert all(1 <= r <= 2 for r in rounds)  # peak_rounds 2
    assert all(s.host_syncs == 0 for s in spans)  # nothing waits on a card here
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"pose", *STAGES} <= names


def test_spans_match_the_profilers_ranges(mug_trace):
    """Each span's host start and end lie within 5 ms of the profiler's
    ``record_function`` range of the same name (the n-th span of a name
    against the n-th range)."""
    spans, p, _, _ = mug_trace
    ranges = {}
    for e in p.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CPU") and e.name() in {"pose", *STAGES}:
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    seen = {}
    for s in spans:
        start, end = sorted(ranges[s.name])[seen.get(s.name, 0)]
        seen[s.name] = seen.get(s.name, 0) + 1
        assert abs(start - s.start_ns) < 5e6 and abs(end - s.end_ns) < 5e6, s
    assert sum(seen.values()) == sum(len(v) for v in ranges.values())


def test_frame_span_tree():
    """A NOCS frame of two bottle crops (one batched chunk): one root
    ``frame`` holding each crop's ``draws`` and ``pose``, the stages under
    their pose, every span of the frame under its request id."""
    runner = small_runner("bottle")
    crops = [view("bottle", 0), view("bottle", 1)]
    prof.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        infer_frame({"bottle": list(enumerate(crops))}, 2, {"bottle": runner}, (0, 7))
    spans = prof.spans()
    prof.clear_spans()
    frame = spans[0]
    assert frame.name == "frame" and frame.parent is None
    assert frame.attrs == {"instances": 2, "chunks": 1}
    assert all(s.root == frame.id for s in spans)
    top = [s for s in spans if s.parent == frame.id]
    assert [s.name for s in top] == ["draws", "pose", "draws", "pose"]
    for pose in (top[1], top[3]):
        kids = [s.name for s in spans if s.parent == pose.id]
        assert kids == list(STAGES)


def test_no_profiler_records_nothing(monkeypatch):
    """With no profiler running a span is one shared object: a whole pose
    stores no span and opens neither a profiler range nor a CUDA event."""
    def refuse(*args, **kwargs):
        raise AssertionError("opened while no profiler runs")

    runner, pc = small_runner("bottle"), view("bottle")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert not torch.autograd._profiler_enabled()
    assert prof.span("a", x=1) is prof.span("b")
    prof.clear_spans()
    runner.estimate(pc)
    assert prof.spans() == []


def test_host_sync_counts_into_open_spans():
    """``host_sync`` adds to the total always, and to every span open at the
    time; a CPU device counts nothing."""
    prof.clear_spans()
    before = prof.COUNTERS["host_syncs"]
    prof.host_sync()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with prof.span("root"):
            prof.host_sync()
            with prof.span("root.child"):
                prof.host_sync(n=2)
                prof.host_sync(torch.device("cpu"))
            with prof.span("root.other"):
                pass
    root, child, other = prof.spans()
    prof.clear_spans()
    assert prof.COUNTERS["host_syncs"] == before + 4
    assert (root.host_syncs, child.host_syncs, other.host_syncs) == (3, 2, 0)
    assert child.parent == root.id == child.root == other.root
