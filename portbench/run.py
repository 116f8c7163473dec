"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json`` ``workloads``)
names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); the configuration names its plain reference
(``reference/<reference>.py``, by default ``pose``) and the mix its driver
(``drivers/<driver>.py``); each per-layer metric is read by
``metrics/<name>.py`` and each cell's compared numbers and limits are in
``limits/<workload>.json``: all found by name, so a cell, a configuration
with its reference, a mix, a driver or a metric is added as files and
entries.  A configuration that turns on a mechanism its reference does not
follow is refused at set-up (``EXIT_CONFIG``), before any request.

Set-up (``setup_s``) runs from the start of the process to the start of the
window: torch and the CUDA context, the runner, the pool of requests made
from the seed, and the warm-up.  The window then serves requests for
``--seconds`` (the last one started finishes); with ``--trace 1`` the whole
window runs under the profiler and the per-layer metrics are reported, else
the end-to-end ones.  After the window the peak memory is read, the
program's state is freed, and the reference judges a sample of what the
window served.  The last line of standard output is the result; the
compared numbers and their limits are the last lines of standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import List  # noqa: E402

import numpy as np  # noqa: E402

from portbench.trace import DeviceTrace  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "cppf_tpu")
EXIT_NO_CHIP, EXIT_FORBIDDEN, EXIT_CONFIG = 2, 3, 4


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots),
    entered in ``sys.modules`` as dataclasses need."""
    path = os.path.join(ROOT, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_reference(cfg: dict):
    """The plain reference ``cfg`` names, ``reference/<reference>.py``
    (default ``pose``), with ``prepare(cfg, weights, crop, draws)``,
    ``estimate(p, draws)`` and ``judge(p, draws, pose)``; its
    ``follows(cfg)`` raises ``ValueError`` here where it does not follow
    ``cfg``."""
    ref = load_module("reference", cfg.get("reference", "pose"))
    ref.follows(cfg)
    return ref


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(ROOT, kind, f"{name}.json")) as f:
        return json.load(f)


def load_benchmark(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class ConfigMismatch(RuntimeError):
    pass


def verify_runner(runner, cfg: dict) -> None:
    """Raise unless the runner runs as the configuration file states: every
    key of the file that names a field of the runner's pose or model
    config, the grid, the head's width and the sphere."""
    wrong = []
    for k, v in cfg.items():
        for obj in (runner.pcfg, runner.cfg):
            if hasattr(obj, k):
                got = getattr(obj, k)
                if (list(got) if isinstance(got, tuple) else got) != v:
                    wrong.append(f"{k}: runs {got!r}, stated {v!r}")
                break
    if tuple(runner.pcfg.grid_shape) != (cfg["vote_grid"],) * 3:
        wrong.append(f"grid: runs {runner.pcfg.grid_shape}, stated {cfg['vote_grid']}")
    if runner.cfg.out_dim != cfg["out_dim"]:
        wrong.append(f"out_dim: runs {runner.cfg.out_dim}, stated {cfg['out_dim']}")
    if runner.sphere.shape[0] != cfg["n_sphere"]:
        wrong.append(f"sphere: runs {runner.sphere.shape[0]}, stated {cfg['n_sphere']}")
    if wrong:
        raise ConfigMismatch("the program does not run as the configuration states: "
                             + "; ".join(wrong))


@dataclasses.dataclass
class Ctx:
    cell: dict
    cfg: dict
    mix: dict
    seed: int
    device: object
    small: dict

    def make_runner(self, build=None):
        """The runner ``build(device)`` makes through the program's own entry
        (by default the category's ``CategoryRunner`` with its served weights
        and snapshot, as the NOCS driver makes it), cut to ``small`` where a
        test asks, checked against the configuration file."""
        if build is None:
            from cppf_tpu_torch.eval.nocs_inference import CategoryRunner

            runner = CategoryRunner(self.cfg["category"], device=self.device)
        else:
            runner = build(self.device)
        pose_keys = {f.name for f in dataclasses.fields(runner.pcfg)}
        runner.pcfg = dataclasses.replace(
            runner.pcfg, **{k: v for k, v in self.small.items() if k in pose_keys})
        for k, v in self.small.items():
            if k not in pose_keys and hasattr(runner.cfg, k):
                setattr(runner.cfg, k, v)
        verify_runner(runner, self.cfg)
        return runner


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95))


def tenths(ends, seconds: float) -> List[float]:
    """Poses a second in each tenth of the window, from the requests'
    (end second, poses): whether a run is slow throughout or stalls."""
    bins = np.zeros(10)
    for t, n in ends:
        bins[min(int(t / seconds * 10), 9)] += n
    return (bins / (seconds / 10)).tolist()


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(args, device=None, small=None, benchmark=None, serve_hook=None):
    """One run; returns (exit code, result dict or None).  ``device``,
    ``small`` (sizes that replace the configuration's and the mix's),
    ``benchmark`` and ``serve_hook`` (called with the driver's served
    object before the warm-up) are for tests; the command line gives none
    of them and runs on ``cuda`` only."""
    import torch

    bench = benchmark or load_benchmark(os.path.join(os.path.dirname(ROOT), "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return EXIT_CONFIG, None
    cell = cells[args.workload]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"torch.cuda.is_available() is {torch.cuda.is_available()}",
                  file=sys.stderr)
            return EXIT_NO_CHIP, None
        device = torch.device("cuda")
    device = torch.device(device)
    on_cuda = device.type == "cuda"
    small = dict(small or {})
    cfg = load_json("configs", cell["config"])
    mix = load_json("traffic", cell["traffic"])
    cut = {k: v for k, v in small.items() if k in cfg}
    cfg, mix = {**cfg, **cut}, {**mix, **{k: v for k, v in small.items() if k in mix}}
    try:
        ref = load_reference(cfg)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return EXIT_CONFIG, None
    driver = load_module("drivers", mix["driver"])
    from cppf_tpu_torch.ops import vote_hist

    ctx = Ctx(cell, cfg, mix, args.seed, device, cut)
    try:
        served = driver.make(ctx)
    except ConfigMismatch as e:
        print(str(e), file=sys.stderr)
        return EXIT_CONFIG, None
    if serve_hook is not None:
        serve_hook(served)
    served.warm()
    if on_cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START

    vote_hist.reset_launches()
    latencies, ends, attempted, failed, poses = [], [], 0, 0, 0
    tracer = DeviceTrace() if args.trace and on_cuda else None
    with tracer or contextlib.nullcontext():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            try:
                dt, n = served.step()
            except Exception:  # a request that fails counts, and the run goes on
                traceback.print_exc()
                failed += 1
                attempted += 1
                continue
            latencies.append(dt)
            ends.append((time.perf_counter() - t0, n))
            attempted += n
            poses += n
        if on_cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    counters = dict(vote_hist.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0

    served.free()
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    from portbench import check
    from portbench.reference import model

    limits = check.load_limits(ROOT, cell["name"])
    items = served.judged(np.random.default_rng([args.seed, 3]))
    weights = model.load_weights(os.path.join(ROOT, cfg["weights"]), device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    judged = check.judge_items(ref, cfg, weights, items)
    nums = check.numbers(limits, judged)
    correct = check.verdict(limits, nums, attempted, failed, len(judged))

    rec = SimpleNamespace(poses=poses, window_s=window_s, counters=counters, cfg=cfg, mix=mix,
                          cell=cell, trace=tracer.summary if tracer is not None else None)
    metrics = {}
    if args.trace:
        for m in bench["per_layer"]:
            if applies(m, cell["name"]):
                value = load_module("metrics", m["name"]).read(rec)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"poses_per_s": poses / window_s, "setup_s": setup_s,
               mix["latency_metric"]: p95(latencies) * 1e3 if latencies else None}
        for m in bench["end_to_end"]:
            if applies(m, cell["name"]) and e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if on_cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if on_cuda else device.type,
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if rec.trace is not None:
        dev.update(busy_s=rec.trace.busy_s, window_s=rec.trace.window_s)
        result["breakdown"] = {"device_ops": rec.trace.device_ops,
                               "idle_gaps": rec.trace.idle_gaps}
    result["checks"] = check.lines(limits, nums)

    found = forbidden_modules()
    if found:
        print(f"modules that must not be loaded: {', '.join(found)}", file=sys.stderr)
        return EXIT_FORBIDDEN, None
    if latencies:
        lat = np.asarray(latencies) * 1e3
        print(f"window {window_s:.3f} s, {len(lat)} requests, {poses} poses; latency ms p5 "
              f"{np.percentile(lat, 5):.2f} p50 {np.percentile(lat, 50):.2f} p95 "
              f"{np.percentile(lat, 95):.2f} max {lat.max():.2f}", file=sys.stderr)
        print("poses/s by tenth of the window: " + " ".join(
            f"{r:.2f}" for r in tenths(ends, args.seconds)), file=sys.stderr)
    print(f"judged {len(judged)} poses of {len(items)} requests; correct: {correct}",
          file=sys.stderr)
    for k, (v, lim) in result["checks"].items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    return 0, result


def main(argv=None) -> int:
    # build and kernel caches at fixed paths inside the checkout (the
    # program's own nvcc builds go to cppf_tpu_torch/_build/, also inside)
    cache = os.path.join(os.path.dirname(ROOT), ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    import torch

    # one host thread for the program's CPU work: the pipeline's host side is
    # one Python thread, and a pool of spinning workers only slows set-up
    torch.set_num_threads(1)
    code, result = run(parse(argv))
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
