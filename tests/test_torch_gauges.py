"""The port's quality gauges, demo and tools (``cppf_tpu_torch/scripts/``,
``cppf_tpu_torch/demo/``) against the JAX package's scripts on identical
inputs, at small sizes on the CPU.

- frames: ``make_frames`` ("bowl,mug", 2 frames, 2 instances, 1 clutter):
  the decoded PNGs pixel-equal to ``cv2``'s, every pkl array equal;
- SUN oracle: the port's writer's pkl equal to the JAX writer's, AP 100;
- zero-shot plumbing: ``run_frames`` on GT-oracle detections, the pkls and
  the mAP equal to JAX's;
- ``eval_category`` of bowl, 1 pose at seed 0, at the NOCS driver test's
  reduced width: on JAX's draws, T within ``T_TOL`` and the up axis within
  ``UP_TOL_DEG`` of JAX's pose;
- the views line up: ``render_views`` at seed 0 is the committed
  ``assets/<cat>_views.npz`` (clouds, GT) and the keys are JAX's, for all
  12 categories;
- a gauge refuses an ``--out_dir`` that already holds files, and makes a
  fresh one under ``TMPDIR`` without one;
- the demo's oracle mode at 4096 pairs: the preprocessed cloud JAX's
  (points ``PC_TOL``), and the pose JAX's
  ``vote_pose`` on the same indices and predictions (T ``T_TOL``, axes
  ``UP_TOL_DEG``);
- ``zero_shot_benchmark.main`` and ``bench_zero_shot.main`` run on the CPU.

The tools (``family_stats``, the oracle probe, ``promote``) are in
tests/test_torch_gauge_tools.py.
"""
import contextlib
import importlib.util
import io
import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf_tpu_torch.data.png import read_png, write_png
from cppf_tpu_torch.models.convert import ASSETS
from cppf_tpu_torch.scripts import eval_checkpoints as ec
from cppf_tpu_torch.scripts import sunrgbd_synthetic_benchmark as sun_bench
from cppf_tpu_torch.scripts import synthetic_benchmark as synth
from cppf_tpu_torch.scripts import zero_shot_benchmark as zs_bench
from test_torch_nocs_driver import _checkpoint_tree

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_TOL = 1e-5          # m, a pose's T against JAX's on the same draws
UP_TOL_DEG = 0.05     # an axis against JAX's on the same draws
PC_TOL = 1e-7         # m, a jittered point: float32 rounding of the jitter


def _jax_script(name):
    """A module of the JAX package's ``scripts/`` (which import each other
    by bare name)."""
    scripts = os.path.join(ROOT, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(scripts, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _assert_pkls_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, str):
            assert va == vb, k
        else:
            va, vb = np.asarray(va), np.asarray(vb)
            assert va.dtype == vb.dtype and va.shape == vb.shape, k
            np.testing.assert_array_equal(va, vb, err_msg=k)


def test_frames_equal_jax(tmp_path):
    import cv2

    jsb = _jax_script("synthetic_benchmark")
    args = ("bowl,mug", 2)
    kw = dict(seed=0, instances=2, clutter=1)
    seg_j, nocs_j = jsb.make_frames(str(tmp_path / "jax"), *args, **kw)
    seg_t, nocs_t = synth.make_frames(str(tmp_path / "port"), *args, **kw)
    frames = sorted(os.listdir(os.path.join(nocs_j, "real", "scene_1")))
    assert frames == sorted(os.listdir(os.path.join(nocs_t, "real", "scene_1")))
    assert len(frames) == 4
    for name in frames:
        want = cv2.imread(os.path.join(nocs_j, "real", "scene_1", name), cv2.IMREAD_UNCHANGED)
        got = read_png(os.path.join(nocs_t, "real", "scene_1", name))
        if got.ndim == 3:
            got = got[:, :, ::-1]  # cv2 reads BGR
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=name)
    pkls = sorted(os.listdir(seg_j))
    assert pkls == sorted(os.listdir(seg_t)) and len(pkls) == 2
    for name in pkls:
        with open(os.path.join(seg_j, name), "rb") as f:
            want = pickle.load(f)
        with open(os.path.join(seg_t, name), "rb") as f:
            got = pickle.load(f)
        _assert_pkls_equal(got, want)
        assert 0 < len(got["gt_class_ids"]) <= 4 and set(got["gt_class_ids"]) <= {2, 6}


def test_sun_oracle_matches_jax(tmp_path):
    """Both oracle writers on the port's scans write equal pkls; the port's
    script in ``--oracle`` mode scores AP 100."""
    jsun = _jax_script("sunrgbd_synthetic_benchmark")
    with contextlib.redirect_stdout(io.StringIO()):
        summary = sun_bench.main(["--oracle", "--category", "table", "--n_scans", "2",
                                  "--out_dir", str(tmp_path), "--device", "cpu"])
    assert summary["aps"]["iou_25"] == 100.0
    assert all(v == 100.0 for k, v in summary["aps"].items() if "deg" in k)
    extra = str(tmp_path / "extra")
    names = ["1", "2"]
    jsun.write_oracle_predictions(extra, str(tmp_path / "jax"), "table",
                                  sun_bench.TYPE2CLASS["table"], names)
    with open(tmp_path / "pred" / "results_table.pkl", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "jax" / "results_table.pkl", "rb") as f:
        want = pickle.load(f)
    assert sorted(got) == sorted(want) == names
    for scan in names:
        assert len(got[scan]) == len(want[scan]) == 2
        np.testing.assert_array_equal(np.asarray(got[scan]), np.asarray(want[scan]))


def test_zero_shot_plumbing_matches_jax(tmp_path):
    """``run_frames`` of both packages on GT-oracle detections: equal pkls,
    equal mAP (AP 100 at 15° 15 cm and IoU 50); an empty detector scores 0."""
    from cppf_tpu.eval import nocs_eval as nocs_eval_j
    from cppf_tpu.eval.zero_shot import Detection as DetectionJ
    from cppf_tpu_torch.eval import nocs_eval
    from cppf_tpu_torch.eval.nocs_inference import SYNSET_NAMES
    from cppf_tpu_torch.eval.zero_shot import Detection

    jzs = _jax_script("zero_shot_benchmark")
    seg_dir, nocs_dir = synth.make_frames(str(tmp_path), "bowl", 2, seed=0, instances=2)

    def oracle(cls):
        frame = [0]

        def detect(depth):
            with open(os.path.join(seg_dir, f"results_real_scene1_{frame[0]:04d}.pkl"),
                      "rb") as f:
                gt = pickle.load(f)
            frame[0] += 1
            assert depth.dtype == np.uint16 and depth.shape == (480, 640)
            dets = []
            for k, (rt, sc) in enumerate(zip(gt["gt_RTs"], gt["gt_scales"])):
                s_norm = np.linalg.norm(rt[:3, :3], axis=0).mean()
                dets.append(cls(rt[:3, 3], rt[:3, :3] / s_norm, sc * s_norm, rt, None,
                                1.0 - 0.1 * k))
            return dets
        return detect

    dirs = {who: str(tmp_path / f"pred_{who}") for who in ("jax", "port")}
    assert jzs.run_frames(range(2), seg_dir, nocs_dir, dirs["jax"], oracle(DetectionJ)) == 4
    assert zs_bench.run_frames(range(2), seg_dir, nocs_dir, dirs["port"], oracle(Detection)) == 4
    for name in sorted(os.listdir(dirs["jax"])):
        with open(os.path.join(dirs["jax"], name), "rb") as f:
            want = pickle.load(f)
        with open(os.path.join(dirs["port"], name), "rb") as f:
            got = pickle.load(f)
        _assert_pkls_equal(got, want)
    with contextlib.redirect_stdout(io.StringIO()):
        got = nocs_eval.main(["--pred_dir", dirs["port"], "--subsample", "1"])
        want = nocs_eval_j.main(["--pred_dir", dirs["jax"], "--subsample", "1"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12, equal_nan=True)
    cls = SYNSET_NAMES.index("bowl")
    assert got[1][cls, 2, 2] == 1.0 and got[0][cls, 50] == 1.0
    assert zs_bench.run_frames(range(2), seg_dir, nocs_dir, str(tmp_path / "empty"),
                               lambda depth: []) == 0
    with contextlib.redirect_stdout(io.StringIO()):
        empty = nocs_eval.main(["--pred_dir", str(tmp_path / "empty"), "--subsample", "1"])
    assert empty[1][cls, 2, 2] == 0.0


def test_eval_category_matches_jax(tmp_path, monkeypatch):
    """Bowl, 1 pose at seed 0, on a checkpoint tree at the NOCS driver
    test's width: the port's pose on the draws of JAX's key is JAX's (T
    ``T_TOL``, up ``UP_TOL_DEG``); the medians agree to their rounding."""
    from cppf_tpu.eval import nocs_inference as nocs_j

    ckpt = _checkpoint_tree(str(tmp_path / "checkpoints"), ["bowl"])
    jec = _jax_script("eval_checkpoints")
    jax_outs = []
    estimate_j = nocs_j.CategoryRunner.estimate

    def recording(self, rng, pc_raw, laptop_up=None):
        out = estimate_j(self, rng, pc_raw, laptop_up)
        jax_outs.append((np.asarray(jax.random.key_data(rng)), out[0]))
        return out

    monkeypatch.setattr(nocs_j.CategoryRunner, "estimate", recording)
    want = jec.eval_category("bowl", ckpt, 1, 0)
    poses = []
    got = ec.eval_category("bowl", ckpt, 1, 0, device="cpu", poses=poses)
    assert len(jax_outs) == len(poses) == 1
    key_j, out_j = jax_outs[0]
    np.testing.assert_array_equal(np.asarray(poses[0]["view"].key, np.uint32), key_j)
    np.testing.assert_allclose(poses[0]["T"], np.asarray(out_j.T), rtol=0, atol=T_TOL)
    cos = float(poses[0]["up"] @ np.asarray(out_j.up))
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) <= UP_TOL_DEG
    assert sorted(got) == sorted(want)
    for k in ("t_err_mm_median", "t_err_up_mm_median", "t_err_perp_mm_median",
              "scale_err_pct_median"):
        assert abs(got[k] - want[k]) <= 0.1 + 1e-9, k
    assert abs(got["up_err_deg_median"] - want["up_err_deg_median"]) <= UP_TOL_DEG + 0.1


def test_set_overrides_reach_the_pose_config():
    """``--set``: a config field is set on the config and the PoseConfig
    rebuilt from it; a field only the PoseConfig has (``center_mode``) is
    set on the PoseConfig; an unknown key raises."""
    ckpt = os.path.join(ROOT, "checkpoints")
    runner = ec.load_runner("bowl", ckpt, device="cpu", overrides=ec.parse_overrides(
        ["center_mode=grid", "coplanar_halfspace=true", "halfspace_margin=0.5"]))
    assert runner.pcfg.center_mode == "grid" and runner.pcfg.coplanar_halfspace is True
    assert runner.cfg.coplanar_halfspace is True and runner.pcfg.halfspace_margin == 0.5
    with pytest.raises(ValueError, match="centre_mode"):
        ec.load_runner("bowl", ckpt, device="cpu", overrides={"centre_mode": "grid"})


@pytest.mark.parametrize("category", ["bottle", "bowl", "camera", "can", "laptop", "mug",
                                      "table", "chair", "bed", "sofa", "bookshelf",
                                      "bathtub"])
def test_views_line_up_with_committed_assets(category):
    """``render_views`` at seed 0 renders the committed views (each cloud
    stride-subsampled to ``npoint_max`` as the runner takes it), and each
    view's key is JAX's (``jax_key_i`` where the asset stores it; bowl's
    asset predates the keys, so JAX's split is remade here)."""
    from cppf_tpu_torch.config import load_config
    from cppf_tpu_torch.eval.nocs_inference import _pad_cloud

    cfg = load_config(category, snapshot=os.path.join(ROOT, "checkpoints", category,
                                                      "config.yaml"))
    z = np.load(os.path.join(ASSETS, f"{category}_views.npz"))
    n = int(z["n_views"])
    views = list(ec.render_views(category, cfg.scale_range, n, 0))
    key = jax.random.PRNGKey(0)
    for i, v in enumerate(views):
        pad, n_raw = _pad_cloud(v.pc, cfg.npoint_max)
        np.testing.assert_array_equal(pad[:n_raw], z[f"pc_{i}"])
        for k in ("R", "T", "bound"):
            np.testing.assert_allclose(getattr(v, k), z[f"{k}_{i}"], rtol=0, atol=1e-6)
        key, k1 = jax.random.split(key)
        want = (z[f"jax_key_{i}"] if f"jax_key_{i}" in z.files
                else np.asarray(jax.random.key_data(k1), np.uint32))
        np.testing.assert_array_equal(np.asarray(v.key, np.uint32), want)
        if category == "laptop":
            R, T = v.R, v.T
            lup = R[:, 1] * (-1.0 if float(R[:, 1] @ T) > 0 else 1.0)
            np.testing.assert_allclose(lup, z[f"laptop_up_{i}"], rtol=0, atol=1e-7)


@pytest.mark.parametrize("gauge", [synth, sun_bench, zs_bench])
def test_gauges_refuse_a_used_out_dir(gauge, tmp_path, monkeypatch):
    """The eval scores every results pkl under ``--out_dir`` and the
    driver reads every frame there, so a gauge refuses a directory that
    already holds files, before it renders or runs anything; with no
    ``--out_dir`` it works in a new directory under ``TMPDIR``."""
    from cppf_tpu_torch.scripts import fresh_out_dir

    (tmp_path / "pred").mkdir()
    (tmp_path / "pred" / "results_real_scene1_0000.pkl").write_bytes(b"")
    with pytest.raises(FileExistsError, match="not empty"):
        gauge.main(["--out_dir", str(tmp_path), "--device", "cpu"])
    assert os.listdir(tmp_path) == ["pred"]
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    a, b = fresh_out_dir(None, "synth_bench_"), fresh_out_dir(None, "synth_bench_")
    assert a != b and os.path.dirname(a) == os.path.dirname(b) == str(tmp_path / "tmp")
    assert fresh_out_dir(str(tmp_path / "new" / "run"), "x") == str(tmp_path / "new" / "run")


def test_demo_oracle_matches_jax():
    """The demo's oracle mode at 4096 pairs: JAX's preprocess on
    ``PRNGKey(seed)`` gives the port's cloud, and JAX's ``vote_pose`` on
    ``PRNGKey(seed + 1)`` with the port's indices and predictions gives the
    port's pose."""
    from cppf_tpu.config import load_config as load_config_j
    from cppf_tpu.pipeline.pose import PoseConfig as PoseConfigJ, vote_pose as vote_pose_j
    from cppf_tpu.pipeline.preprocess import preprocess_cloud as preprocess_j
    from cppf_tpu_torch.demo import pose_single

    n_pairs = 4096
    with contextlib.redirect_stdout(io.StringIO()):
        got = pose_single.main(["--n_pairs", str(n_pairs), "--device", "cpu"])
    cfg = load_config_j("bottle")
    R, T = got["R_true"], got["T_true"]
    pre = got["pre"]
    # the JAX demo's cloud, remade from the same GT pose and the port's draws
    pad = np.zeros((pose_single.N_RAW_PAD, 3), np.float32)
    rng = np.random.default_rng(0)
    from cppf_tpu.data.synthetic import PRIMITIVES, mesh_bounds, observation_pose, sample_surface
    from cppf_tpu.data.shapenet import FLIP2NOCS

    mesh = PRIMITIVES["bottle"]()
    R_j, T_j = observation_pose(rng, is_nocs=True)
    np.testing.assert_array_equal(R_j, R)
    lo, hi = mesh_bounds(mesh)
    diag = float(np.linalg.norm(hi - lo))
    scale = float(np.mean(cfg.scale_range))
    pc = ((sample_surface(mesh, 6000, rng) - (lo + hi) / 2) / diag * scale) @ FLIP2NOCS.T
    pad[:6000] = (pc @ R_j.T + T_j).astype(np.float32)
    pre_j = preprocess_j(jax.random.PRNGKey(0), jnp.asarray(pad), 6000, cfg.res,
                         npoint_pad=4096, knn=cfg.knn)
    n = int(pre_j.n_valid)
    assert int(pre.n_valid) == n
    # the jitter's normal draws may differ from JAX's in the last bit
    np.testing.assert_allclose(pre.pc.numpy(), np.asarray(pre_j.pc), rtol=0, atol=PC_TOL)
    # the normals are held by tests/test_torch_preprocess.py on equal
    # points; here the points part in the last bit, and both vote halves
    # below take the port's normals
    pcfg = PoseConfigJ.from_config(cfg, n_pairs=n_pairs)
    out_j = vote_pose_j(jax.random.PRNGKey(1), jnp.asarray(pre.pc.numpy()),
                        jnp.asarray(pre.normals.numpy()), jnp.asarray(got["idxs"]),
                        jnp.asarray(got["preds"]), pre.n_valid.item(),
                        jnp.asarray(pcfg.sphere_points()), pcfg)
    out = got["out"]
    np.testing.assert_allclose(out.T.numpy(), np.asarray(out_j.T), rtol=0, atol=T_TOL)
    for axis in ("up", "right"):
        cos = float(getattr(out, axis).numpy() @ np.asarray(getattr(out_j, axis)))
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) <= UP_TOL_DEG, axis
    np.testing.assert_allclose(out.scale.numpy(), np.asarray(out_j.scale), rtol=1e-5)
    assert int(out.n_filtered) == int(out_j.n_filtered)
    assert np.linalg.norm(out.T.numpy() - T) < 0.01


def test_zero_shot_gauges_run_on_the_cpu(tmp_path):
    """``zero_shot_benchmark.main`` and ``bench_zero_shot.main`` end to end
    on the CPU at small sizes: the summary and the timer's keys by route."""
    from cppf_tpu_torch.scripts import bench_zero_shot

    with contextlib.redirect_stdout(io.StringIO()):
        summary = zs_bench.main(["--n_frames", "1", "--instances", "1", "--n_pairs", "20000",
                                 "--out_dir", str(tmp_path / "zs"), "--device", "cpu"])
    assert summary["n_frames"] == 1 and summary["device"] == "cpu"
    assert set(summary["pose_ap"]) == {f"{d}deg_{c}cm" for d in (5, 10, 15) for c in (5, 10, 15)}
    assert summary["n_detections"] == sum(len(d) for d in summary["detections"])
    # the demo frame cropped to one bowl keeps the CPU's KNN short; the
    # sparse route's 48³ windows take ~30 s a call on the CPU, and run on
    # the card (chip_smoke.py phase 18)
    depth = read_png(bench_zero_shot.DEMO_DEPTH)
    crop = np.zeros_like(depth)
    crop[105:200, 300:400] = depth[105:200, 300:400]
    write_png(str(tmp_path / "depth.png"), crop)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        timed = bench_zero_shot.main(["--depth", str(tmp_path / "depth.png"), "--n_pairs",
                                      "20000", "--repeat", "1", "--routes", "dense",
                                      "--device", "cpu"])
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == timed
    assert set(timed) == {"dense_s", "dense_first_s", "grid_dims", "device", "n_pairs"}
    assert timed["device"] == "cpu" and len(timed["grid_dims"]) == 3
