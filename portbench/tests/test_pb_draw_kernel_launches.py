"""``draw_kernel_launches_per_pose``: the program's device counter of the
draws kernel's launches over the poses, and nothing where the counter is
missing or 0 (a program whose draws are plain PyTorch, as on the CPU)."""
from types import SimpleNamespace

import pytest

from portbench import counters
from portbench import run as R
from portbench.tests.helpers import run_small

NAME = "draw_kernel_launches_per_pose"


def read(monkeypatch, recorded, poses):
    monkeypatch.setattr(counters, "recorded", lambda: recorded)
    return R.load_module("metrics", NAME).read(SimpleNamespace(poses=poses, counters={}))


def test_reads_the_counter_over_the_poses(monkeypatch):
    assert read(monkeypatch, {"draw_kernel_launches": 48, "center_pairs_gated": 7},
                48) == pytest.approx(1.0)
    assert read(monkeypatch, {"draw_kernel_launches": 31}, 62) == pytest.approx(0.5)
    assert read(monkeypatch, {"center_pairs_gated": 3}, 3) is None  # a program without it
    assert read(monkeypatch, {}, 3) is None  # a program without device counters
    assert read(monkeypatch, {"draw_kernel_launches": 0}, 5) is None
    assert read(monkeypatch, {"draw_kernel_launches": 4}, 0) is None


def test_entry_and_a_cpu_run():
    """Its entry moves ``poses_per_s`` in the two cells that draw from JAX
    keys; a traced run on the CPU, where the draws take the plain version,
    leaves it out."""
    bench = R.load_benchmark(R.os.path.join(R.os.path.dirname(R.ROOT), "BENCHMARK.json"))
    entry = dict({m["name"]: m for m in bench["per_layer"]}[NAME])
    assert {"bottle.frames", "table.scans"} <= set(entry.pop("workloads"))
    assert entry == {"name": NAME, "unit": "launches/pose", "better": "lower",
                     "source": "program_counter", "layer": "JAX-key draws",
                     "moves": "poses_per_s"}
    code, res = run_small("bottle.frames", trace=1)
    assert code == 0 and NAME not in res["metrics"]
