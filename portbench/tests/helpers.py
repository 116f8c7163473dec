"""Shared pieces of the benchmark's tests: a cell cut to a size a CPU test
run can hold, and a run of the harness on it."""
from __future__ import annotations

import copy

import numpy as np
import torch

from portbench import run as R

SMALL = {"n_pairs": 2048, "npoint_pad": 512, "rot_subsample": 1000, "pool": 3, "warm": 1,
         "judge": 2}


def small_cell(workload: str):
    """(cell, cfg, mix) of ``workload`` with the small sizes."""
    bench = R.load_benchmark(R.os.path.join(R.os.path.dirname(R.ROOT), "BENCHMARK.json"))
    cell = {w["name"]: w for w in bench["workloads"]}[workload]
    cfg, mix = R.load_json("configs", cell["config"]), R.load_json("traffic", cell["traffic"])
    return (cell, {**cfg, **{k: v for k, v in SMALL.items() if k in cfg}},
            {**mix, **{k: v for k, v in SMALL.items() if k in mix}})


def run_small(workload: str, seed: int = 5, seconds: float = 0.5, serve_hook=None,
              benchmark=None, trace: int = 0):
    """One harness run on the CPU at the small sizes and a three-request
    pool: (exit code, result)."""
    torch.set_num_threads(4)
    bench = copy.deepcopy(benchmark or R.load_benchmark(
        R.os.path.join(R.os.path.dirname(R.ROOT), "BENCHMARK.json")))
    args = R.parse(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                    "--trace", str(trace)])
    return R.run(args, device="cpu", small=SMALL, benchmark=bench, serve_hook=serve_hook)


def rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)
