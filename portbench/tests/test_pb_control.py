"""The control (the reference in TF32, in the program's place) is not
correct at each cell's own size, on three seeds.  Needs the card."""
import numpy as np
import pytest
import torch

from portbench import calibrate, check
from portbench import run as R
from portbench.reference import model


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["bottle.stream", "mug.stream", "bottle.frames"])
def test_the_control_fails(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bench = R.load_benchmark(R.os.path.join(R.os.path.dirname(R.ROOT), "BENCHMARK.json"))
    cell = {w["name"]: w for w in bench["workloads"]}[workload]
    cfg = R.load_json("configs", cell["config"])
    mix = R.load_json("traffic", cell["traffic"])
    limits = check.load_limits(R.ROOT, workload)
    weights = model.load_weights(R.os.path.join(R.ROOT, cfg["weights"]), "cuda")
    driver = R.load_module("drivers", mix["driver"])
    ref = R.load_reference(cfg)
    for seed in (3900000001, 3900000002, 3900000003):
        served = driver.make(R.Ctx(cell, cfg, mix, seed, torch.device("cuda"), {}))
        for _ in range(mix["pool"]):
            served.step()
        served.free()
        items = served.judged(np.random.default_rng([seed, 3]))
        nums = check.numbers(limits, calibrate.control_numbers(ref, cfg, weights, items))
        assert not check.verdict(limits, nums, 1, 0, len(items)), nums
