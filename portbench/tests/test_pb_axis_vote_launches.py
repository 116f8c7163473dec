"""``axis_vote_launches_per_pose``: the program's sphere-count launches over
the poses, and nothing where the counter is missing or 0 (a program whose
axis vote launches no kernel, as on the CPU)."""
from types import SimpleNamespace

import pytest

from portbench import run as R
from portbench.tests.helpers import run_small

NAME = "axis_vote_launches_per_pose"


def read(counters, poses):
    return R.load_module("metrics", NAME).read(SimpleNamespace(counters=counters, poses=poses))


def test_reads_the_counter_over_the_poses():
    assert read({"sphere_count": 96, "refine_window_pairs": 7}, 48) == pytest.approx(2.0)
    assert read({"sphere_count": 31}, 31) == pytest.approx(1.0)
    assert read({"bound_projections_pairs": 3}, 3) is None  # a program without the counter
    assert read({"sphere_count": 0}, 5) is None
    assert read({"sphere_count": 4}, 0) is None


def test_entry_and_a_cpu_run():
    """Its entry moves ``poses_per_s`` in the frames cell, and its
    ``.stream`` twin ``pose_ms_p95`` in the stream cells; a traced run on
    the CPU, where the axis vote takes the plain version, leaves both out."""
    bench = R.load_benchmark(R.os.path.join(R.os.path.dirname(R.ROOT), "BENCHMARK.json"))
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name, moves, cells in ((NAME, "poses_per_s", ["bottle.frames"]),
                               (NAME + ".stream", "pose_ms_p95",
                                ["bottle.stream", "mug.stream"])):
        entry = entries[name]
        assert entry["source"] == "program_counter" and entry["moves"] == moves
        assert entry["layer"] == "back-vote, axis votes, category branches"
        assert entry["workloads"] == cells
    code, res = run_small("bottle.stream", trace=1)
    assert code == 0 and not {NAME, NAME + ".stream"} & set(res["metrics"])
