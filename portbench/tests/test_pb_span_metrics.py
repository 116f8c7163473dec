"""The per-layer metrics that read the program's spans and host-sync count
(``spans.py``, ``metrics/*_per_pose.py``): on spans made by hand, with no
spans, with a program that has no recorder, and (on the card) from a traced
run of the harness."""
from types import SimpleNamespace

import pytest
import torch

from portbench import run as R
from portbench import spans as S
from portbench.tests.helpers import SMALL

NEW = ("host_syncs_per_pose", "preprocess_ms_per_pose", "network_ms_per_pose",
       "center_vote_ms_per_pose", "axis_votes_ms_per_pose", "draws_ms_per_pose")


def span(id, name, parent=None, device_s=None, host_syncs=0):
    return SimpleNamespace(id=id, name=name, parent=parent, device_s=device_s,
                           host_syncs=host_syncs)


def read_all(monkeypatch, spans, poses):
    monkeypatch.setattr(S, "recorded", lambda: spans)
    rec = SimpleNamespace(poses=poses)
    return {m: R.load_module("metrics", m).read(rec) for m in NEW}


def stream_spans(dev=1e-3):
    """Two poses of a mug: stages of two center passes and two axes; the
    device intervals ms × ``dev`` seconds, none where ``dev`` is None (the
    CPU)."""
    out = []
    for root, syncs in ((1, 25), (20, 31)):
        out.append(span(root, "pose", None, dev and 60 * dev, syncs))
        for i, (name, ms) in enumerate((("pose.preprocess", 8), ("pose.network", 4),
                                        ("pose.center_vote", 5), ("pose.backvote", 2),
                                        ("pose.axis_vote", 12), ("pose.center_vote", 6),
                                        ("pose.backvote", 2), ("pose.axis_vote", 11))):
            out.append(span(root + 1 + i, name, root, dev and ms * dev, 1))
    return out


def test_stream_metrics_by_hand(monkeypatch):
    got = read_all(monkeypatch, stream_spans(), poses=2)
    assert got["host_syncs_per_pose"] == pytest.approx((25 + 31) / 2)  # roots only
    assert got["preprocess_ms_per_pose"] == pytest.approx(8.0)
    assert got["network_ms_per_pose"] == pytest.approx(4.0)
    assert got["center_vote_ms_per_pose"] == pytest.approx(11.0)  # both passes
    assert got["axis_votes_ms_per_pose"] == pytest.approx(2 + 12 + 2 + 11)
    assert got["draws_ms_per_pose"] is None  # the stream cells hand their draws in


def test_frame_metrics_by_hand(monkeypatch):
    """One frame of three crops: its syncs count once, at the root; the
    draws' device time over the crops."""
    spans = [span(1, "frame", None, 0.3, 70)]
    for k in range(3):
        spans += [span(2 + 3 * k, "draws", 1, 0.02, 18), span(3 + 3 * k, "pose", 1, 0.05, 20),
                  span(4 + 3 * k, "pose.network", 3 + 3 * k, 0.004, 0)]
    got = read_all(monkeypatch, spans, poses=3)
    assert got["host_syncs_per_pose"] == pytest.approx(70 / 3)
    assert got["draws_ms_per_pose"] == pytest.approx(20.0)
    assert got["network_ms_per_pose"] == pytest.approx(4.0)
    assert got["preprocess_ms_per_pose"] is None


def test_nothing_to_read(monkeypatch):
    """No spans, no poses, or spans without device intervals (the CPU):
    the metrics read nothing."""
    assert set(read_all(monkeypatch, [], poses=5).values()) == {None}
    assert set(read_all(monkeypatch, stream_spans(), poses=0).values()) == {None}
    got = read_all(monkeypatch, stream_spans(dev=None), poses=2)
    assert got.pop("host_syncs_per_pose") == pytest.approx(28.0)
    assert set(got.values()) == {None}


def test_a_program_without_the_recorder(monkeypatch):
    """A program whose ``utils/prof.py`` has no ``spans`` (the port before
    the recorder) gives no spans, and no metric raises."""
    from cppf_tpu_torch.utils import prof

    monkeypatch.delattr(prof, "spans")
    assert S.recorded() == []
    rec = SimpleNamespace(poses=3)
    assert {R.load_module("metrics", m).read(rec) for m in NEW} == {None}


def test_entries_name_the_files():
    bench = R.load_benchmark(R.os.path.join(R.os.path.dirname(R.ROOT), "BENCHMARK.json"))
    entries = {m["name"]: m for m in bench["per_layer"]}
    for m in NEW:
        assert entries[m]["moves"] == "poses_per_s" and entries[m]["better"] == "lower"
        assert entries[m]["workloads"] == ["bottle.frames"]
        assert R.os.path.exists(R.os.path.join(R.ROOT, "metrics", f"{m}.py"))
    for m in NEW[:-1]:  # the draws run in the frames cell only
        twin = entries[f"{m}.stream"]
        assert twin["moves"] == "pose_ms_p95" and twin["better"] == "lower"
        assert twin["workloads"] == ["bottle.stream", "mug.stream"]
        assert R.os.path.exists(R.os.path.join(R.ROOT, "metrics", f"{m}.stream.py"))
    assert f"{NEW[-1]}.stream" not in entries


@pytest.mark.cuda
def test_traced_small_run_reports_the_span_metrics():
    """A traced run of ``bottle.stream`` at the small sizes on the card
    reports all five of its span metrics."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from cppf_tpu_torch.utils import prof

    prof.clear_spans()
    args = R.parse(["--workload", "bottle.stream", "--seed", "3900000123", "--seconds", "3",
                    "--trace", "1"])
    code, res = R.run(args, device="cuda", small=SMALL)
    assert code == 0 and res["correct"], res
    for m in NEW[:5]:
        assert res["metrics"][m]["value"] > 0, (m, res["metrics"])
    assert "draws_ms_per_pose" not in res["metrics"]
