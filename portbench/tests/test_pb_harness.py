"""The harness on the CPU at a small size: a sound run is correct; a run
whose timed path is broken underneath is not; a cell, a mix, a metric, and
a configuration's reference and runner added as files are found by name;
the run refuses a configuration its reference does not follow, and refuses
to run without a card and with JAX loaded."""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import gen
from portbench import run as R
from portbench.tests.helpers import SMALL, run_small, small_cell
from portbench.trace import summarize

REPO = os.path.dirname(R.ROOT)


def test_sound_runs_are_correct():
    """Each cell's run is correct and reports just the end-to-end metrics
    that ``BENCHMARK.json`` gives it: ``poses_per_s`` in the frames cell,
    ``pose_ms_p95`` in the stream cells."""
    bench = R.load_benchmark(os.path.join(REPO, "BENCHMARK.json"))
    for workload, rate in (("bottle.stream", False), ("mug.stream", False),
                           ("bottle.frames", True)):
        code, res = run_small(workload)
        assert code == 0 and res["correct"], (workload, res)
        assert list(res)[-1] == "checks"
        assert set(res["metrics"]) == {m["name"] for m in bench["end_to_end"]
                                       if R.applies(m, workload)}
        assert ("poses_per_s" in res["metrics"]) == rate and "setup_s" in res["metrics"]


def _altered(field, fn):
    """A hook that alters ``field`` of every pose where ``estimate``
    produces it."""
    def hook(served):
        estimate = served.runner.estimate

        def broken(*a, **k):
            out, pre = estimate(*a, **k)
            return out._replace(**{field: fn(getattr(out, field))}), pre
        served.runner.estimate = broken
    return hook


def _rt(fn):
    """An alteration of the 4x4 RT that the NOCS driver reads."""
    def alter(rt):
        rt = rt.clone()
        fn(rt)
        return rt
    return alter


# the fields each driver hands on: the stream's pose, the frames' RT
FAULTS = {
    "center moved by a voxel": {"stream": ("T", lambda t: t + 0.004),
                                "frames": ("RT", _rt(lambda rt: rt[:3, 3].add_(0.004)))},
    "up flipped": {"stream": ("up", lambda u: -u),
                   "frames": ("RT", _rt(lambda rt: rt[:3, 1:3].neg_()))},
    "scale grown": {"stream": ("scale", lambda s: s * 1.05),
                    "frames": ("RT", _rt(lambda rt: rt[:3, :3].mul_(1.05)))},
    "rotation altered": {"stream": ("R", lambda r: r[:, [2, 0, 1]]),
                         "frames": ("RT", _rt(lambda rt: rt[:3, :3].copy_(rt[:3, [2, 0, 1]])))},
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", ["bottle.stream", "mug.stream", "bottle.frames"])
def test_an_answer_altered_where_it_is_produced_is_not_correct(workload, fault):
    field, fn = FAULTS[fault][workload.split(".")[1]]
    code, res = run_small(workload, serve_hook=_altered(field, fn))
    assert code == 0 and not res["correct"], res["checks"]


def test_half_the_batch_left_out_is_not_correct():
    """The driver's batched chunks pose their first half only; the rest take
    the mean of the posed rows."""
    def hook(served):
        batch = served.runner.estimate_batch

        def broken(pc_list, key, pad_to=None):
            half = max(1, len(pc_list) // 2)
            out, pre = batch(pc_list[:half], key, pad_to=pad_to)
            mean = type(out)(*(f.float().mean(0, keepdim=True).to(f.dtype) for f in out))
            full = type(out)(*(torch.cat([f] + [m] * (len(pc_list) - half))
                               for f, m in zip(out, mean)))
            return full, pre
        served.runner.estimate_batch = broken
        # every frame batched: two or more crops
        served.frames = [f if len(f) > 1 else f + f for f in served.frames]
    code, res = run_small("bottle.frames", serve_hook=hook)
    assert code == 0 and not res["correct"], res["checks"]


def _runner_config(base: dict, category: str) -> dict:
    """``base`` with every key the runner of ``category`` states taken from
    it: what a later change writes into a new ``configs/<config>.json``."""
    from cppf_tpu_torch.eval.nocs_inference import CategoryRunner

    runner = CategoryRunner(category, device="cpu")
    cfg = {**base, "name": category, "category": category, "weights": f"weights/{category}.npz",
           "vote_grid": runner.pcfg.grid_shape[0], "out_dim": runner.cfg.out_dim}
    for k in base:
        for obj in (runner.pcfg, runner.cfg):
            if hasattr(obj, k) and k != "category":
                v = getattr(obj, k)
                cfg[k] = list(v) if isinstance(v, tuple) else v
                break
    return cfg


def _harness_with_can(tmp_path, monkeypatch, **cfg):
    """A copy of the harness, found by the run in place of the repo's, with
    a category it has no file of (can) added as new files: its
    configuration (bottle's, with the can runner's values and ``cfg``), its
    frozen weights and its mesh, and limits of a cell ``can.probe`` on a mix
    ``probe.mix``.  Returns (the copy's root, BENCHMARK.json with that cell)."""
    assert not os.path.exists(os.path.join(R.ROOT, "meshes", "can.json"))
    root = tmp_path / "portbench"
    shutil.copytree(R.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    base = json.loads((root / "configs" / "bottle.json").read_text())
    (root / "configs" / "can.json").write_text(json.dumps({**_runner_config(base, "can"), **cfg}))
    shutil.copy(os.path.join(REPO, "cppf_tpu_torch", "assets", "can_params_best.npz"),
                root / "weights" / "can.npz")
    (root / "meshes" / "can.json").write_text(json.dumps(
        {"source": "PRIMITIVES['can']", "parts": [
            {"shape": "cylinder", "radius": 0.035, "height": 0.1}]}))
    mix = json.loads((root / "traffic" / "stream.json").read_text())
    (root / "traffic" / "probe.mix.json").write_text(json.dumps(mix))
    (root / "limits" / "can.probe.json").write_text(
        (root / "limits" / "bottle.stream.json").read_text())
    bench = json.loads(open(os.path.join(REPO, "BENCHMARK.json")).read())
    bench["workloads"].append({"name": "can.probe", "config": "can",
                               "traffic": "probe.mix", "chips": 1, "why": "probe"})
    monkeypatch.setattr(R, "ROOT", str(root))
    monkeypatch.setattr(gen, "MESHES", str(root / "meshes"))
    return root, bench


def test_new_cell_mix_and_metric_are_found_by_name(tmp_path, monkeypatch):
    """A category the benchmark has no file of (can), a mix and a metric,
    each added as new files beside a copy of the harness, and a cell as a
    new entry: the run finds them all by name."""
    root, bench = _harness_with_can(tmp_path, monkeypatch)
    (root / "metrics" / "probe.count.py").write_text(
        "def read(rec):\n    return float(rec.poses) if rec.poses else None\n")
    bench["per_layer"] = [{"name": "probe.count", "unit": "poses", "better": "higher",
                           "source": "program_counter", "layer": "probe", "moves": "poses_per_s"}]
    code, res = run_small("can.probe", benchmark=bench, trace=1)
    assert code == 0 and res["correct"], res
    assert res["metrics"]["probe.count"]["value"] >= 1


PROBE_REFERENCE = """\
import os

from portbench.reference import pose

LOG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "probe.calls")


def _log(name):
    with open(LOG, "a") as f:
        f.write(name + "\\n")


def follows(cfg):
    _log("follows")
    pose.follows(cfg)


def prepare(cfg, weights, crop, draws):
    _log("prepare")
    return pose.prepare(cfg, weights, crop, draws)


def estimate(p, draws):
    _log("estimate")
    return pose.estimate(p, draws)


def judge(p, draws, out):
    _log("judge")
    return pose.judge(p, draws, out)
"""

# a driver whose runner the program's own SUN RGB-D entry builds (scale
# without the NOCS factor 2), served as the stream driver serves it
PROBE_DRIVER = """\
from types import SimpleNamespace

from portbench import run as R


def build(device):
    from cppf_tpu_torch.eval.sunrgbd_inference import load_runner

    args = SimpleNamespace(device=device, num_rots=72, angle_prec=1.5, adaptive_voting=False,
                           ckpt_path=None, up_prior_deg=0.0)
    return load_runner("can", args)


def make(ctx):
    class Ctx(type(ctx)):
        def make_runner(self, build=build):
            return super().make_runner(build)

    return R.load_module("drivers", "stream").make(Ctx(**vars(ctx)))
"""


def test_a_configuration_brings_its_reference_and_its_runner_by_name(tmp_path, monkeypatch):
    """A configuration that names a reference of its own (a probe that
    wraps ``pose`` and logs its calls) and a driver that builds its runner
    through the program's SUN RGB-D entry, all added as files: the run
    judges by the probe, on a runner with the scale the file states."""
    root, bench = _harness_with_can(tmp_path, monkeypatch, reference="probe",
                                    scale_multiplier=1.0)
    (root / "reference" / "probe.py").write_text(PROBE_REFERENCE)
    (root / "drivers" / "probe.py").write_text(PROBE_DRIVER)
    mix = json.loads((root / "traffic" / "probe.mix.json").read_text())
    (root / "traffic" / "probe.mix.json").write_text(json.dumps({**mix, "driver": "probe"}))
    runners = []
    code, res = run_small("can.probe", benchmark=bench,
                          serve_hook=lambda served: runners.append(served.runner))
    assert code == 0 and res["correct"], res
    assert runners[0].pcfg.scale_multiplier == 1.0
    calls = (root / "reference" / "probe.calls").read_text().split()
    assert calls[0] == "follows" and "prepare" in calls and "judge" in calls, calls


def test_a_flag_the_reference_does_not_follow_is_refused_at_set_up(tmp_path, monkeypatch,
                                                                    capsys):
    """A configuration with the table's three mechanisms and no reference of
    its own exits ``EXIT_CONFIG`` before a driver is loaded, naming each."""
    root, bench = _harness_with_can(tmp_path, monkeypatch, filter_coplanar=True,
                                    up_prior_deg=30.0, geo_right_dir="direct")
    loaded, load = [], R.load_module
    monkeypatch.setattr(R, "load_module",
                        lambda kind, name: loaded.append(kind) or load(kind, name))
    code, res = run_small("can.probe", benchmark=bench)
    assert code == R.EXIT_CONFIG and res is None
    assert "drivers" not in loaded
    err = capsys.readouterr().err
    for key in ("filter_coplanar", "up_prior_deg", "geo_right_dir"):
        assert key in err, err


def test_a_built_runner_is_held_to_the_configuration():
    """``make_runner(build)`` applies ``small`` and checks the runner it is
    handed as it checks its own: a gravity prior the file does not state is
    refused."""
    from cppf_tpu_torch.eval.nocs_inference import CategoryRunner

    cell, cfg, mix = small_cell("bottle.stream")
    cut = {k: v for k, v in SMALL.items() if k in cfg}
    ctx = R.Ctx(cell, cfg, mix, 1, torch.device("cpu"), cut)
    runner = CategoryRunner("bottle", device="cpu")
    assert ctx.make_runner(lambda device: runner) is runner
    assert runner.pcfg.n_pairs == SMALL["n_pairs"]
    runner.pcfg = dataclasses.replace(runner.pcfg, up_prior_deg=30.0)
    with pytest.raises(R.ConfigMismatch, match="up_prior_deg"):
        ctx.make_runner(lambda device: runner)


def test_mesh_files_copy_the_programs_primitives():
    """Each ``meshes/<category>.json`` and each shape of ``gen.SHAPES`` is
    the program's ``data/synthetic.py`` one, vertex for vertex."""
    from cppf_tpu_torch.data import synthetic

    names = [f[:-5] for f in os.listdir(gen.MESHES) if f.endswith(".json")]
    assert {"bottle", "mug"} <= set(names)
    for name in names:
        mine, theirs = gen.load_mesh(name), synthetic.PRIMITIVES[name]()
        assert np.array_equal(mine.vertices, theirs.vertices), name
        assert np.array_equal(mine.faces, theirs.faces), name
    for shape, make in gen.SHAPES.items():
        mine, theirs = make(), getattr(synthetic, f"make_{shape}")()
        assert np.array_equal(mine.vertices, theirs.vertices), shape
        assert np.array_equal(mine.faces, theirs.faces), shape


def test_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    code, res = R.run(R.parse(["--workload", "bottle.stream", "--seed", "1", "--seconds", "1"]))
    assert code == R.EXIT_NO_CHIP and res is None


def test_refuses_with_jax_loaded(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    code, res = run_small("bottle.stream")
    assert code == R.EXIT_FORBIDDEN and res is None


def test_prints_no_result_beside_only_the_benchmark(tmp_path):
    shutil.copytree(R.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "bottle.stream",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode != 0
    assert not proc.stdout.strip()


class _Event:
    def __init__(self, name, start, dur, device):
        self._n, self._s, self._d, self._dev = name, start, dur, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"


def test_trace_summary_by_hand():
    events = [_Event("k1", 0, 100, True), _Event("k2", 50, 100, True),
              _Event("Memcpy DtoH", 400, 100, True), _Event("k1", 700, 300, True),
              _Event("cudaMemcpyAsync", 200, 350, False)]
    s = summarize(events, window_s=1e-6)
    assert s.busy_s == pytest.approx((150 + 100 + 300) / 1e9)
    assert s.kernels == {"k1": [2, pytest.approx(4e-7)], "k2": [1, pytest.approx(1e-7)]}
    gaps = dict((k, v) for k, v in s.idle_gaps)
    assert gaps["cudaMemcpyAsync, then Memcpy DtoH"] == pytest.approx(250 / 1e9)
    assert gaps["host work between CUDA calls, then k1"] == pytest.approx(200 / 1e9)


def test_limits_sit_between_their_readings():
    for name in os.listdir(os.path.join(R.ROOT, "limits")):
        numbers = json.load(open(os.path.join(R.ROOT, "limits", name)))["numbers"]
        for k, spec in numbers.items():
            assert spec["lower"] < spec["limit"] < spec["upper"], (name, k)
            assert spec["upper"] >= 3 * spec["lower"], (name, k)
