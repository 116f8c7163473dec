"""The SUN RGB-D reference (``reference/sunrgbd.py``) and the cell
``table.scans`` on the CPU at a small size: the reference follows the table
configuration and refuses what it does not implement; its coplanar gate,
gravity prior and direct right sign are the program's; a sound run of the
cell is correct, and a run whose program leaves out the gate, the prior or
the direct sign is not."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from portbench import draws as D
from portbench import gen
from portbench import run as R
from portbench.drivers.stream import to_pose_draws
from portbench.reference import model, sunrgbd, threefry
from portbench.tests.helpers import run_small, small_cell


def table_cfg() -> dict:
    return R.load_json("configs", "table")


def test_follows_the_table_configuration():
    sunrgbd.follows(table_cfg())
    for name in ("bottle", "mug"):
        sunrgbd.follows(R.load_json("configs", name))
    assert R.load_reference(table_cfg()) is not None


@pytest.mark.parametrize("key,value", [("subvoxel_refine", True), ("axis_topk", 2),
                                       ("coplanar_halfspace", True), ("up_prior_deg", -1.0),
                                       ("geo_right_dir", "up"), ("filter_coplanar", "yes"),
                                       ("filter_coplanar", None)])
def test_refuses_a_mechanism_it_does_not_implement(key, value):
    cfg = table_cfg()
    if value is None:
        del cfg[key]
    else:
        cfg[key] = value
    with pytest.raises(ValueError, match=key):
        sunrgbd.follows(cfg)


def test_the_cell_is_not_refused_at_set_up():
    """``table.scans`` loads its reference and reaches its runner: the
    configuration file states what the SUN driver's table runner runs."""
    cell = small_cell("table.scans")[0]
    cfg, mix = table_cfg(), R.load_json("traffic", "scans")
    ref = R.load_reference(cfg)
    assert ref.__name__.endswith("sunrgbd")
    ctx = R.Ctx(cell, cfg, mix, 1, torch.device("cpu"), {})
    runner = ctx.make_runner(R.load_module("drivers", "scans").build("table"))
    assert runner.pcfg.filter_coplanar and runner.pcfg.up_prior_deg == 30.0


@pytest.fixture(scope="module")
def random_case(tmp_path_factory):
    """The small table cell's configuration, seeded random weights in the
    reference's layout, and the program's table runner cut to the same
    sizes."""
    from cppf_tpu_torch.eval import sunrgbd_inference as S

    torch.set_num_threads(4)
    _, cfg, mix = small_cell("table.scans")
    g = np.random.default_rng(7)
    with np.load(os.path.join(R.ROOT, "weights", "table.npz")) as z:
        rand = {k: (g.normal(size=z[k].shape) * (1.0 if k.endswith("scale") else 0.3))
                .astype(np.float32) for k in z.files}
    path = tmp_path_factory.mktemp("weights") / "random.npz"
    np.savez(path, **rand)
    runner = S.load_runner("table", S.build_parser().parse_args(["--device", "cpu"]))
    pcfg = dataclasses.replace(runner.pcfg, n_pairs=cfg["n_pairs"],
                               rot_subsample=cfg["rot_subsample"])
    return cfg, mix, model.load_weights(str(path), "cpu"), pcfg


def _prepared(case, seed: int):
    cfg, mix, weights, _ = case
    crop = gen.make_crops("table", mix, mix["diagonal_m"], 1, np.random.default_rng(seed))[0]
    draws = D.key_draws(cfg, *threefry.split(threefry.key_of_seed(seed)), "cpu")
    return sunrgbd.prepare(cfg, weights, crop, draws), draws


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gate_and_prior_are_the_programs(random_case, seed):
    """The reference's coplanar gate and prior gate equal the program's
    ``coplanar_center_mask`` and ``up_prior_gate`` on the same cloud,
    normals, pairs and sphere; the gate drops pairs here, and the center
    grid is read on the kept pairs alone."""
    from cppf_tpu_torch.pipeline import pose as P

    p, _ = _prepared(random_case, seed)
    keep = sunrgbd.center_gate(p)
    assert torch.equal(keep, P.coplanar_center_mask(p.pc, p.normals, p.idx.int()))
    assert 0 < int(keep.sum()) < keep.numel()
    assert p.center.idx.shape[0] == int(keep.sum())
    assert torch.equal(sunrgbd.prior_gate(p), P.up_prior_gate(p.sphere, random_case[3]))


@pytest.mark.parametrize("seed", [1, 2])
def test_direct_right_sign_is_the_programs(random_case, seed):
    """The program's ``vote_pose`` on the reference's cloud, pairs, logits
    and draws gives the reference's own pose under either right sign, and
    the two signs part here: a program that takes the cross product where
    the configuration states ``direct`` is judged wrong by its sign."""
    from cppf_tpu_torch.pipeline import pose as P

    p, draws = _prepared(random_case, seed)
    outs = {}
    for rule in ("direct", "cross"):
        q = dataclasses.replace(p, cfg={**p.cfg, "geo_right_dir": rule})
        est = sunrgbd.estimate(q, draws)
        out = P.vote_pose(p.pc, p.normals, p.idx.int(), p.preds, p.n_valid, p.sphere,
                          dataclasses.replace(random_case[3], geo_right_dir=rule),
                          to_pose_draws(draws))
        assert torch.equal(out.T, est["T"]) and float(torch.dot(out.up, est["up"])) > 0.999999
        assert float(torch.dot(out.right, est["right"])) > 0.999999
        assert max(sunrgbd.judge(q, draws, out._asdict()).values()) < 1e-4
        outs[rule] = out
    assert float(torch.dot(outs["direct"].right, outs["cross"].right)) < -0.999999
    assert sunrgbd.judge(p, draws, outs["cross"]._asdict())["right_sign"] > 0.05


def test_a_sound_run_is_correct():
    code, res = run_small("table.scans", seed=5)
    assert code == 0 and res["correct"], res
    assert set(res["metrics"]) == {"poses_per_s", "frame_ms_p95", "setup_s"}
    assert set(res["checks"]) == set(json.load(open(os.path.join(
        R.ROOT, "limits", "table.scans.json")))["numbers"])


def _off(**changes):
    def hook(served):
        served.runner.pcfg = dataclasses.replace(served.runner.pcfg, **changes)
    return hook


@pytest.mark.parametrize("changes,seed,number", [({"filter_coplanar": False}, 4, "center"),
                                                 ({"up_prior_deg": 0.0}, 1, "up")])
def test_a_mechanism_left_out_is_not_correct(changes, seed, number):
    """The program's runner with the coplanar gate or the gravity prior
    turned off: the judge reads the gate in the center, the prior in the
    up axis."""
    code, res = run_small("table.scans", seed=seed, serve_hook=_off(**changes))
    assert code == 0 and not res["correct"], res["checks"]
    c, limit = res["checks"][number]
    assert c > limit, res["checks"]


def test_scan_pools_share_their_work_across_seeds():
    """Every seed serves as many scans of each instance count, in its own
    order; the instance keys follow the SUN driver's split."""
    from cppf_tpu_torch.core import threefry as port_threefry

    cell, cfg, mix = small_cell("table.scans")
    drv = R.load_module("drivers", "scans")
    sizes = []
    for seed in (3, 2 ** 31 + 5):
        ctx = R.Ctx(cell, cfg, mix, seed, torch.device("cpu"), {})
        ctx.make_runner = lambda build=None: None
        served = drv.make(ctx)
        sizes.append(sorted(len(s) for s in served.scans))
    assert sizes[0] == sizes[1] == [1, 2, 3]  # the small pool: one scan of each count
    rng, want = (7, 9), []
    for _ in range(3):
        rng, r = port_threefry.split(rng)
        want.append(tuple(port_threefry.split(r)))
    assert drv.instance_keys((7, 9), 3) == [tuple(tuple(int(w) for w in k) for k in pair)
                                            for pair in want]
