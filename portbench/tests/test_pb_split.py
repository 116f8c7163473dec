"""The end-to-end metrics split by cell: ``poses_per_s`` is held to a bound
in the frames cell alone, and in the stream cells read per layer as
``poses_per_s.stream``; every per-layer metric moves an end-to-end metric
that each of its cells reports, and a ``.stream`` twin reads as its
original.  Also the window's rate by tenths that a run prints."""
import inspect
from types import SimpleNamespace

import pytest

from portbench import run as R

BENCH = R.load_benchmark(R.os.path.join(R.os.path.dirname(R.ROOT), "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
TWINS = sorted(m["name"] for m in BENCH["per_layer"]
               if m["name"].endswith(".stream") and m["name"] != "poses_per_s.stream")


def reported(metric: str, cell: str) -> bool:
    return any(m["name"] == metric and R.applies(m, cell) for m in BENCH["end_to_end"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_a_per_layer_metric_moves_what_its_cells_report(metric):
    entry = {m["name"]: m for m in BENCH["per_layer"]}[metric]
    cells = entry.get("workloads", CELLS)
    assert cells and all(reported(entry["moves"], c) for c in cells), entry


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_a_rate_or_a_latency_and_a_per_layer_metric(cell):
    e2e = {m["name"] for m in BENCH["end_to_end"] if R.applies(m, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(R.applies(m, cell) for m in BENCH["per_layer"])
    stream = cell.endswith(".stream")
    assert ("poses_per_s" in e2e) != stream
    assert R.applies({"workloads": ["bottle.stream", "mug.stream"]}, cell) == stream


@pytest.mark.parametrize("twin", TWINS)
def test_a_stream_twin_reads_as_its_original(twin):
    original = twin[:-len(".stream")]
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    assert {k: v for k, v in entries[twin].items() if k not in ("name", "moves", "workloads")} \
        == {k: v for k, v in entries[original].items()
            if k not in ("name", "moves", "workloads")}
    read = R.load_module("metrics", twin).read
    assert inspect.getfile(read) == R.os.path.join(R.ROOT, "metrics", f"{original}.py")


def test_the_stream_rate_is_poses_over_the_window():
    read = R.load_module("metrics", "poses_per_s.stream").read
    assert read(SimpleNamespace(poses=102, window_s=2.04)) == pytest.approx(50.0)
    assert read(SimpleNamespace(poses=0, window_s=2.0)) is None


def test_tenths_count_each_request_in_the_tenth_it_ended():
    ends = [(0.5, 1), (0.9, 2), (5.0, 1), (9.99, 4), (10.2, 1)]
    rates = R.tenths(ends, 10.0)
    assert rates == pytest.approx([3.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 5.0])
    assert sum(rates) * 1.0 == pytest.approx(sum(n for _, n in ends))
