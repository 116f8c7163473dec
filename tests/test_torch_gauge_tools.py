"""The port's tools (``cppf_tpu_torch/scripts/{update_family_stats,
probe_sun_oracle,promote}.py``) against the JAX package's scripts on the
CPU: the family statistics equal, the oracle probe's pose JAX's on the same
draws (T ``T_TOL``, up ``UP_TOL_DEG``), and ``promote`` installing the
port's checkpoint layout."""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

from cppf_tpu_torch.models.convert import ASSETS
from test_torch_gauges import ROOT, T_TOL, UP_TOL_DEG, _jax_script

torch.set_num_threads(1)


def test_family_stats_match_jax():
    from cppf_tpu_torch.scripts import update_family_stats as port

    jfs = _jax_script("update_family_stats")
    for cat in ("table", "sofa"):
        rng_range = (0.5, 1.2)
        assert port.family_stats(cat, rng_range, n_draws=2, n_pairs=500) == \
            jfs.family_stats(cat, rng_range, n_draws=2, n_pairs=500)


def test_update_family_stats_writes_its_config_root(tmp_path):
    """``--dry`` leaves the configs alone; without it only the SUN
    categories' two lines change, in the given config root."""
    import shutil

    from cppf_tpu_torch.config import CONFIG_ROOT
    from cppf_tpu_torch.scripts import update_family_stats as port

    root = str(tmp_path / "configs")
    shutil.copytree(CONFIG_ROOT, root)
    before = {c: open(os.path.join(root, "category", f"{c}.yaml")).read() for c in port.SUN}
    with contextlib.redirect_stdout(io.StringIO()):
        port.main(["--dry", "--config_root", root])
    assert all(open(os.path.join(root, "category", f"{c}.yaml")).read() == t
               for c, t in before.items())
    monkey = port.family_stats
    try:
        port.family_stats = lambda cat, sr: ([9.5, 9.5], [0.1, 0.2, 0.3])
        with contextlib.redirect_stdout(io.StringIO()):
            port.main(["--config_root", root])
    finally:
        port.family_stats = monkey
    for c, text in before.items():
        new = open(os.path.join(root, "category", f"{c}.yaml")).read()
        changed = [(a, b) for a, b in zip(text.splitlines(), new.splitlines()) if a != b]
        assert all(b in ("vote_range: [9.5, 9.5]", "scale_mean: [0.1, 0.2, 0.3]")
                   for _, b in changed), changed
        assert len(changed) == 2


def test_probe_sun_oracle_matches_jax():
    """One oracle-voted table view at 512 pairs and 12 rotations: the
    port's pose on JAX's draws is JAX's (T ``T_TOL``, up ``UP_TOL_DEG``)."""
    from cppf_tpu.pipeline import pose as pose_j
    from cppf_tpu_torch.scripts import probe_sun_oracle as port

    jprobe = _jax_script("probe_sun_oracle")
    outs_j = []
    vote_j = pose_j.vote_pose

    def recording(*a, **k):
        out = vote_j(*a, **k)
        outs_j.append(out)
        return out

    poses = []
    with contextlib.redirect_stdout(io.StringIO()):
        pose_j.vote_pose = recording
        try:
            want = jprobe.probe("table", 1, 512, 12, False, False, 0)
        finally:
            pose_j.vote_pose = vote_j
        got = port.probe("table", 1, 512, 12, False, False, 0, device="cpu", poses=poses)
    assert len(outs_j) == len(poses) == 1
    np.testing.assert_allclose(poses[0][0], np.asarray(outs_j[0].T), rtol=0, atol=T_TOL)
    cos = float(poses[0][1] @ np.asarray(outs_j[0].up))
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) <= UP_TOL_DEG
    assert abs(got["t_err_mm_median"] - want["t_err_mm_median"]) <= 0.1 + 1e-9


def test_promote_installs_params_best(tmp_path):
    """An ``.npz`` state is copied, a ``.pt`` train state's encoders are
    written as ``params_best.npz`` (the runner serves either), with the
    config and the metrics beside it; a missing state raises."""
    import shutil

    from cppf_tpu_torch.config import load_config
    from cppf_tpu_torch.models.convert import (load_npz_params, make_encoders,
                                               params_to_state_dicts)
    from cppf_tpu_torch.scripts import promote as port

    exp = tmp_path / "bowl_exp"
    exp.mkdir()
    shutil.copy(os.path.join(ASSETS, "bowl_params_best.npz"), exp / "params_best.npz")
    shutil.copy(os.path.join(ROOT, "checkpoints", "bowl", "config.yaml"), exp / "config.yaml")
    (exp / "metrics.jsonl").write_text('{"epoch": 0}\n')
    torch.manual_seed(0)
    point, ppf = make_encoders(load_config("bowl", snapshot=str(exp / "config.yaml")).out_dim)
    torch.save({"point": point.state_dict(), "ppf": ppf.state_dict(), "opt": {}, "step": 3},
               exp / "best_decode.pt")
    root = str(tmp_path / "prod")
    with contextlib.redirect_stdout(io.StringIO()):
        dst = port.main(["bowl", str(exp), "--name", "params_best", "--ckpt_root", root])
    assert open(dst, "rb").read() == open(exp / "params_best.npz", "rb").read()
    assert os.path.exists(os.path.join(root, "bowl", "config.yaml"))
    assert os.path.exists(os.path.join(root, "bowl", "metrics.jsonl"))
    dst = port.promote("bowl", str(exp), "best_decode", root)
    point_sd, ppf_sd = params_to_state_dicts(load_npz_params(dst))
    for want, got in ((point.state_dict(), point_sd), (ppf.state_dict(), ppf_sd)):
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    with pytest.raises(FileNotFoundError):
        port.promote("bowl", str(exp), "epoch40", root)
