"""The port's host tools against the JAX package's: data/stats.py,
data/sunrgbd_synth.py, ops/peaks.py, utils/prof.py and train/multirun.py."""
import filecmp
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SMALL = ["knn=12", "npoint_pad=512", "npoint_max=2000", "train_pairs=2048", "batch_size=2",
         "max_epoch=1", "epoch_len=2", "decode_val_every=0", "contrast_val_every=0"]


@pytest.mark.parametrize("category,flags", [("bowl", (True, False, False)),
                                            ("mug", (False, False, False)),
                                            ("laptop", (False, True, True))])
def test_compute_stats_matches_jax(category, flags):
    """Two random meshes of the category: the diagonals and mean extents
    equal JAX's (the same host samples), the vote ranges within float32
    rounding of the targets (1e-6 relative)."""
    from cppf_tpu.data.stats import compute_stats as compute_stats_j
    from cppf_tpu.data.synthetic import random_primitive as random_primitive_j
    from cppf_tpu_torch.data.stats import compute_stats
    from cppf_tpu_torch.data.synthetic import random_primitive

    meshes_j = [random_primitive_j(category, np.random.default_rng(s)) for s in (1, 2)]
    meshes = [random_primitive(category, np.random.default_rng(s)) for s in (1, 2)]
    want = compute_stats_j(meshes_j, *flags, n_pairs=20000)
    got = compute_stats(meshes, *flags, n_pairs=20000, device="cpu")
    assert got["scale_range"] == want["scale_range"]
    assert got["scale_mean"] == want["scale_mean"]
    np.testing.assert_allclose(got["vote_range"], want["vote_range"], rtol=1e-6)


def test_stats_main_primitive_fallback(tmp_path, capsys):
    """Without ShapeNet, main takes the category's primitive, as JAX's."""
    from cppf_tpu.data.stats import main as main_j
    from cppf_tpu_torch.data.stats import main

    args = ["--category", "can", "--shapenet_root", str(tmp_path / "none")]
    want = main_j(args)
    got = main(args + ["--device", "cpu"])
    assert got["scale_range"] == want["scale_range"]
    np.testing.assert_allclose(got["vote_range"], want["vote_range"], rtol=1e-6)
    assert "scale_mean:" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(args)


@pytest.mark.parametrize("category,kw", [("table", dict(n_scans=2, instances=2)),
                                         ("bottle", dict(n_scans=1, instances=3,
                                                         target_diag=0.3))])
def test_make_scans_byte_equal(tmp_path, category, kw, monkeypatch):
    """Every file of the layout equals the JAX package's byte for byte.
    ``scipy.io.savemat`` stamps the MAT header with ``time.asctime()``, so
    the clock is pinned: two writes a second apart would differ there."""
    import time

    from cppf_tpu.data.sunrgbd_synth import make_scans as make_scans_j
    from cppf_tpu_torch.data.sunrgbd_synth import make_scans

    monkeypatch.setattr(time, "asctime", lambda *a: "Thu Jan  1 00:00:00 1970")
    runs = {}
    for name, fn in (("jax", make_scans_j), ("torch", make_scans)):
        sun, extra = tmp_path / name / "sun", tmp_path / name / "extra"
        runs[name] = fn(str(sun), str(extra), category, 7, pts_per_obj=1500, seed=3, **kw)
    assert runs["jax"] == runs["torch"]
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 2 + 4 * kw["n_scans"]
    for f in files:
        assert filecmp.cmp(tmp_path / "jax" / f, tmp_path / "torch" / f, shallow=False), f


def _grid(seed, shape=(20, 18, 16)):
    g = np.random.default_rng(seed).random(shape).astype(np.float32) ** 4
    for c in ((4, 5, 6), (15, 12, 3), (10, 2, 12)):
        g[c] += 5.0
    return g


def test_peaks_match_jax():
    """peak_contrast and gaussian_blur3d within float32 rounding (1e-6 of
    the maximum), extract_peaks' coordinates and validity equal."""
    from cppf_tpu.ops import peaks as peaks_j
    from cppf_tpu_torch.ops import peaks

    g = _grid(0)
    for width in (1, 2):
        np.testing.assert_allclose(peaks.peak_contrast(torch.from_numpy(g), width).numpy(),
                                   np.asarray(peaks_j.peak_contrast(jnp.asarray(g), width)),
                                   atol=1e-6 * np.abs(g).max())
    for sigma, radius in ((1.0, None), (0.7, 2), (2.0, None)):
        want = np.asarray(peaks_j.gaussian_blur3d(jnp.asarray(g), sigma, radius))
        got = peaks.gaussian_blur3d(torch.from_numpy(g), sigma, radius).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6 * want.max())
    sm = peaks.gaussian_blur3d(torch.from_numpy(g), 1.0)
    for kw in (dict(), dict(max_peaks=5, suppress_radius=3, min_contrast=0.5)):
        c_j, s_j, ok_j = peaks_j.extract_peaks(jnp.asarray(sm.numpy()), **kw)
        c, s, ok = peaks.extract_peaks(sm, **kw)
        np.testing.assert_array_equal(c.numpy(), np.asarray(c_j))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
        np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-6)
        assert c.dtype == torch.int32 and bool(ok[0])


def test_prof_on_the_cpu(tmp_path):
    """trace writes a Chrome trace of the block, and each span opened in it
    is a range of its name there, its stages inside it and the kernels
    they ran inside the stages."""
    from cppf_tpu_torch.utils import prof

    a = torch.randn(64, 64)
    prof.clear_spans()
    with prof.trace(str(tmp_path / "trace")) as p:
        with prof.span("pose"):
            with prof.span("pose.network"):
                (a @ a).sum()
            with prof.span("pose.center_vote", **{"pass": 1}):
                a.max()
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.key == "aten::matmul" for e in p.key_averages())

    def one(name):
        found = [e for e in events if e.get("name") == name]
        assert len(found) == 1, name
        return found[0]["ts"], found[0]["ts"] + found[0]["dur"]

    pose, net, vote, mm = (one(n) for n in ("pose", "pose.network", "pose.center_vote",
                                            "aten::matmul"))
    assert pose[0] <= net[0] <= mm[0] <= mm[1] <= net[1] <= vote[0] <= vote[1] <= pose[1]
    assert [s.name for s in prof.spans()] == ["pose", "pose.network", "pose.center_vote"]
    prof.clear_spans()


def test_multirun_in_sequence(tmp_path):
    """Two categories trained one after another in this process, each in
    <out_root>/<category> with the overrides and on the device asked."""
    from cppf_tpu_torch.config import load_config
    from cppf_tpu_torch.train import multirun

    out = multirun.main(["categories=bowl,mug", f"out_root={tmp_path}", "device=cpu"] + SMALL)
    assert sorted(out) == ["bowl", "mug"]
    for cat in ("bowl", "mug"):
        assert out[cat]["state"].step == 1
        assert next(out[cat]["state"].point.parameters()).device.type == "cpu"
        saved = load_config(snapshot=str(tmp_path / cat / "config.yaml"))
        assert saved.category == cat and saved.knn == 12 and saved.train_pairs == 2048
        assert os.path.exists(tmp_path / cat / "params_best.npz")


def test_multirun_parallel_commands(tmp_path, monkeypatch):
    """parallel=true starts one trainer process a category, with JAX's
    command lines but for the port's module, and returns their exit codes
    or-ed together."""
    import cppf_tpu.train.multirun as multirun_j
    from cppf_tpu_torch.train import multirun

    spawned = {"jax": [], "torch": []}

    def popen(name, rc):
        class Proc:
            def __init__(self, cmd):
                spawned[name].append(cmd)

            def wait(self):
                return rc
        return Proc

    args = ["categories=bowl,can", f"out_root={tmp_path}", "parallel=true", "max_epoch=3",
            "device=cpu"]
    monkeypatch.setattr(multirun_j.subprocess, "Popen", popen("jax", 0))
    with pytest.raises(SystemExit):
        multirun_j.main(args)
    monkeypatch.setattr(multirun.subprocess, "Popen", popen("torch", 2))
    assert multirun.main(args) == 2
    want = [[a.replace("cppf_tpu.train.loop", "cppf_tpu_torch.train.loop") for a in cmd]
            for cmd in spawned["jax"]]
    assert spawned["torch"] == want
    assert spawned["torch"][0][:3] == [sys.executable, "-m", "cppf_tpu_torch.train.loop"]
    assert "device=cpu" in spawned["torch"][1] and multirun.NOCS_DEFAULT == multirun_j.NOCS_DEFAULT
