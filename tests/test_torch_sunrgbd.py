"""The port's SUN RGB-D driver and evaluation against cppf_tpu's.

Both drivers run from ``--seed 0`` on one scan set written by
``scripts/export_torch_assets.py::sun_scan_set`` (``make_scans``: a scan of
2 chairs, one of 2 beds, and one that joins 2 chairs, the second segment
cut to 150 points, with a bed) at the width of
tests/test_torch_nocs_driver.py (snapshot: 2048 pairs, 512 points, knn 16,
npoint_max 4000; 12 rotations, a 3° sphere), with and without the gravity
prior.  The checkpoint tree holds chair and bed only, so the eight other
classes are skipped and must take no key.  Each instance's row must match
JAX's to the slice tolerances (tests/torch_slices.py::assert_slices_match):
T and R to 1e-6, scales rtol 1e-5.  Table, whose in-plane aux sign is
float rounding between XLA fused and op by op (ROADMAP §C), stays out.

Also here: the up-prior gate and ``_vote_axis`` under it, the eval on the
JAX driver's and on oracle pkls (1e-12), and the numpy pieces (``nms``,
``gt_rt_from_bbox``, the depth decode, ``backproject_sunrgbd``,
``eval/alignment.py``) against JAX's.
"""
import contextlib
import dataclasses
import importlib.util
import io
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cppf_tpu.eval import alignment as alignment_j
from cppf_tpu.eval import sunrgbd_eval as eval_j
from cppf_tpu.eval import sunrgbd_inference as driver_j
from cppf_tpu.eval.box3d import Box3D as Box3DJ
from cppf_tpu.pipeline import pose as pose_j
from cppf_tpu_torch.core import threefry
from cppf_tpu_torch.core.geometry import backproject_sunrgbd
from cppf_tpu_torch.eval import alignment, sunrgbd_eval
from cppf_tpu_torch.eval import sunrgbd_inference as port
from cppf_tpu_torch.eval.box3d import Box3D
from cppf_tpu_torch.pipeline import pose
from cppf_tpu_torch.scripts import sunrgbd_synthetic_benchmark as sun_bench
from test_torch_nocs_driver import WIDTH, _checkpoint_tree, export
from test_torch_pose_units import _network
from torch_slices import ROOT, _axis_draws, t

torch.set_num_threads(1)


CATEGORIES = ("chair", "bed")
PRIORS = ("30", "0")


@pytest.fixture(scope="module")
def scan_set(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sun_scans"))
    scans = export.sun_scan_set(tmp, categories=CATEGORIES, mixed=("chair", "bed"), seed=1)
    sun_dir, extra_dir = chip_smoke.write_sun_layout(scans, os.path.join(tmp, "set"))
    ckpt = _checkpoint_tree(os.path.join(tmp, "checkpoints"), CATEGORIES)
    return dict(tmp=tmp, scans=scans, sun_dir=sun_dir, extra_dir=extra_dir, ckpt=ckpt)


def _args(scan_set, out_dir, extra=()):
    return ["--sunrgbd_dir", scan_set["sun_dir"], "--sunrgbd_extra_dir", scan_set["extra_dir"],
            "--out_dir", out_dir, "--ckpt_path", scan_set["ckpt"], "--seed", "0", *WIDTH,
            *extra]


def _results(out_dir):
    out = {}
    for cat in CATEGORIES:
        with open(os.path.join(out_dir, f"results_{cat}.pkl"), "rb") as f:
            out[cat] = pickle.load(f)
    return out


@pytest.fixture(scope="module")
def runs(scan_set):
    """Both drivers at each prior: {prior: (JAX pkls, port pkls, port
    instances, pred dir of JAX)}; the keys each port instance was posed on
    are recorded."""
    out = {}
    for prior in PRIORS:
        d_j, d_t = (os.path.join(scan_set["tmp"], f"{who}_{prior}") for who in ("jax", "port"))
        extra = ["--up_prior_deg", prior]
        driver_j.main(_args(scan_set, d_j, extra))
        keys = []
        real = port.CategoryRunner.draws

        def recording(self, key):
            keys.append(tuple(key))
            return real(self, key)

        port.CategoryRunner.draws = recording
        try:
            posed = port.main(_args(scan_set, d_t, extra + ["--device", "cpu"]))
        finally:
            port.CategoryRunner.draws = real
        out[prior] = (_results(d_j), _results(d_t), posed, keys, d_j)
    return out


@pytest.mark.parametrize("prior", PRIORS)
def test_driver_matches_jax(runs, scan_set, prior):
    rows_j, rows_t, posed, _, _ = runs[prior]
    n = 0
    for cat in CATEGORIES:
        assert list(rows_t[cat]) == list(rows_j[cat])
        for scan, want in rows_j[cat].items():
            got = rows_t[cat][scan]
            assert len(got) == len(want) > 0, (cat, scan)
            for a, b in zip(got, want):
                a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
                assert a[0] == b[0] == port.TYPE2CLASS[cat] and a[1] == b[1] == 1.0
                np.testing.assert_allclose(a[2:5], b[2:5], rtol=1e-5)
                np.testing.assert_allclose(a[5:14], b[5:14], atol=1e-6)
                np.testing.assert_allclose(a[14:17], b[14:17], atol=1e-6)
                R = a[5:14].reshape(3, 3)
                np.testing.assert_allclose(R.T @ R, np.eye(3), atol=1e-5)
                if prior == "30":
                    # the up axis (R's second column) within 30° of ±y
                    assert abs(R[1, 1]) >= np.cos(np.radians(30)) - 1e-6
                n += 1
    # chair: 2 in scan 1, 1 in scan 3 (the 150-point segment skipped);
    # bed: 2 in scan 2, 1 in scan 3
    assert n == len(posed) == 6
    assert [(p.category, p.scan, p.index) for p in posed] == [
        ("bed", "2", 0), ("bed", "2", 1), ("bed", "3", 2),
        ("chair", "1", 0), ("chair", "1", 1), ("chair", "3", 0)]
    assert all(p.points >= port.MIN_POINTS and p.seconds > 0 for p in posed)


def test_prior_changes_some_up_axis(runs):
    """At 12 rotations and 512 points an up vote is noisy: the prior must
    move at least one up axis, in both packages alike."""
    moved = 0
    for cat in CATEGORIES:
        for scan, rows in runs["30"][1][cat].items():
            for a, b in zip(rows, runs["0"][1][cat][scan]):
                moved += not np.allclose(np.asarray(a[5:14]), np.asarray(b[5:14]), atol=1e-6)
    assert moved > 0


def test_key_schedule(runs):
    """One split of ``key(seed)`` a posed instance, running on across the
    categories in TYPE2CLASS order: the skipped classes and the skipped
    150-point segment take none."""
    _, _, posed, keys, _ = runs["30"]
    rng, want = threefry.key(0), []
    for _ in posed:
        rng, r = threefry.split(rng)
        want.append(tuple(r))
    assert keys == want


def test_scan_instances_filters_and_cuts():
    """The class filter, the 200-point floor and the 40 000-point cut (to
    the segment's first points, before the runner's stride)."""
    points = np.arange(3 * 50000, dtype=np.float64).reshape(50000, 3)
    bboxes = np.zeros((4, 8))
    bboxes[:, 7] = [3, 3, 1, 3]
    segments = [np.arange(199), np.arange(45000)[::-1], np.arange(300), np.arange(200)]
    items = port.scan_instances(points, bboxes, segments, 3)
    assert [i for i, _ in items] == [1, 3]
    assert items[0][1].dtype == np.float32 and items[0][1].shape == (40000, 3)
    np.testing.assert_array_equal(items[0][1], points[np.arange(45000)[::-1][:40000]])
    assert items[1][1].shape == (200, 3)


@pytest.mark.parametrize("angle_prec", [1.5, 3.0])
def test_up_prior_gate_matches_jax(angle_prec):
    """The gate at 30° equals JAX's on the sphere, with no direction within
    1e-5 of the float32 cos(30°) (where an ulp between XLA's and torch's
    cos could move it)."""
    pcfg = dataclasses.replace(pose.PoseConfig(angle_prec=angle_prec), up_prior_deg=30.0)
    sphere = pcfg.sphere_points()
    want = np.asarray(jnp.abs(jnp.asarray(sphere) @ jnp.asarray(pcfg.up_prior_dir, jnp.float32))
                      >= jnp.cos(jnp.deg2rad(pcfg.up_prior_deg)))
    got = pose.up_prior_gate(torch.from_numpy(sphere), pcfg).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(sphere)
    assert np.abs(np.abs(sphere[:, 1]) - np.float32(np.cos(np.radians(30)))).min() > 1e-5
    assert pose.up_prior_gate(torch.from_numpy(sphere), pose.PoseConfig()) is None


@pytest.mark.parametrize("topk", [1, 3])
def test_vote_axis_with_gate_matches_jax(topk):
    """_vote_axis on chair's up logits, on JAX's draws, with a gate about
    a direction ⟂ the ungated answer (so that the gate moves it): the same
    signed sphere direction as JAX's to 1e-6, inside the gate."""
    pre, _, _, idxs, preds, mask, pcfg_j, pcfg_t = _network("chair")
    pcfg_j = dataclasses.replace(pcfg_j, axis_topk=topk)
    B, R = pcfg_j.tr_num_bins, pcfg_j.rot_num_bins
    logits, aux = preds[:, 2 * B: 2 * B + R], preds[:, -5]
    sphere = pcfg_t.sphere_points()
    key = jax.random.PRNGKey(7)

    def port_axis(pcfg, gate):
        return pose._vote_axis(t(pre.pc), t(pre.normals), t(idxs), torch.from_numpy(mask),
                               t(logits), t(aux), torch.from_numpy(sphere), pcfg,
                               _axis_draws(key, pcfg), prior_gate=gate).numpy()

    free = port_axis(dataclasses.replace(pcfg_t, axis_topk=topk), None)
    perp = np.cross(free, [1.0, 0.0, 0.0] if abs(free[0]) < 0.9 else [0.0, 1.0, 0.0])
    perp = tuple(float(v) for v in perp / np.linalg.norm(perp))
    pcfg_t = dataclasses.replace(pcfg_t, axis_topk=topk, up_prior_deg=30.0, up_prior_dir=perp)
    gate = pose.up_prior_gate(torch.from_numpy(sphere), pcfg_t)
    got_t = port_axis(pcfg_t, gate)
    got_j = np.asarray(pose_j._vote_axis(key, pre.pc, pre.normals, idxs, jnp.asarray(mask),
                                         logits, aux, jnp.asarray(sphere), pcfg_j,
                                         prior_gate=jnp.asarray(gate.numpy())))
    np.testing.assert_allclose(got_t, got_j, atol=1e-6, rtol=0)
    assert abs(got_t @ np.asarray(perp)) >= np.cos(np.radians(30)) - 1e-6
    assert not np.allclose(np.abs(got_t), np.abs(free), atol=1e-3)


def _jax_oracle_writer():
    spec = importlib.util.spec_from_file_location(
        "sunrgbd_synthetic_benchmark", os.path.join(ROOT, "scripts",
                                                    "sunrgbd_synthetic_benchmark.py"))
    writer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(writer)
    return writer


def _oracle_dir(scan_set, out_dir, writer=sun_bench):
    """Oracle pkls of every category in ``out_dir``, by ``writer``'s
    ``write_oracle_predictions`` (default: the port's)."""
    for cat in CATEGORIES:
        cid = port.TYPE2CLASS[cat]
        names = port.scan_names(scan_set["extra_dir"], cid)
        writer.write_oracle_predictions(scan_set["extra_dir"], out_dir, cat, cid, names)
    return out_dir


def test_oracle_writers_agree(scan_set):
    """The port's oracle writer (cppf_tpu_torch/scripts/
    sunrgbd_synthetic_benchmark.py) writes the JAX script's pkls, row for
    row."""
    got = _oracle_dir(scan_set, os.path.join(scan_set["tmp"], "oracle_port"))
    want = _oracle_dir(scan_set, os.path.join(scan_set["tmp"], "oracle_jax"),
                       _jax_oracle_writer())
    for cat in CATEGORIES:
        with open(os.path.join(got, f"results_{cat}.pkl"), "rb") as f:
            rows_t = pickle.load(f)
        with open(os.path.join(want, f"results_{cat}.pkl"), "rb") as f:
            rows_j = pickle.load(f)
        assert sorted(rows_t) == sorted(rows_j) and rows_t
        for scan in rows_j:
            np.testing.assert_array_equal(np.asarray(rows_t[scan], np.float64),
                                          np.asarray(rows_j[scan], np.float64))
            assert len(rows_t[scan]) == len(rows_j[scan])


@pytest.mark.parametrize("preds,full_rot", [("jax", False), ("jax", True), ("oracle", False)])
def test_eval_matches_jax(runs, scan_set, preds, full_rot):
    """The port's eval on the same pkls: every array of JAX's to 1e-12, the
    match indices bit for bit; AP 100 on the oracle's."""
    pred_dir = (runs["30"][4] if preds == "jax"
                else _oracle_dir(scan_set, os.path.join(scan_set["tmp"], "oracle")))
    argv = ["--pred_dir", pred_dir, "--sunrgbd_dir", scan_set["sun_dir"],
            "--sunrgbd_extra_dir", scan_set["extra_dir"], "--categories", *CATEGORIES]
    if full_rot:
        argv.append("--full_rot")
    with contextlib.redirect_stdout(io.StringIO()):
        want = eval_j.main(argv)
        got = sunrgbd_eval.main(argv)
    assert list(got) == list(want) == list(CATEGORIES)
    for cat in CATEGORIES:
        for g, w in zip(got[cat], want[cat]):
            assert g.shape == w.shape and g.dtype == w.dtype
            if g.dtype.kind == "i":
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
        if preds == "oracle":
            iou_aps, pose_aps = got[cat][:2]
            assert iou_aps[1, 50] == 1.0 and pose_aps[1, 0, 0] == 1.0


def _boxes(rng, n):
    """``n`` random boxes near each other (some overlapping), in both
    packages' Box3D, with scores."""
    out_j, out_t = [], []
    for _ in range(n):
        a = rng.uniform(0, 2 * np.pi)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        T, s = rng.uniform(-0.6, 0.6, 3), rng.uniform(0.3, 1.2, 3)
        out_j.append(Box3DJ.from_transformation(R, T, s))
        out_t.append(Box3D.from_transformation(R, T, s))
    return out_j, out_t, rng.uniform(0, 1, n)


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_matches_jax(seed):
    boxes_j, boxes_t, scores = _boxes(np.random.default_rng(seed), 12)
    want = eval_j.nms(boxes_j, scores, 0.3)
    got = sunrgbd_eval.nms(boxes_t, scores, 0.3)
    assert [int(i) for i in got] == [int(i) for i in want]
    assert 1 < len(got) < 12
    for i in range(3):
        assert sunrgbd_eval.iou_3d_safe(boxes_t[i], boxes_t[i + 1]) == pytest.approx(
            eval_j.iou_3d_safe(boxes_j[i], boxes_j[i + 1]), abs=1e-12)


def test_gt_rt_from_bbox_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(5):
        bbox = np.concatenate([rng.uniform(-2, 2, 3), rng.uniform(0.2, 1, 3),
                               rng.uniform(-np.pi, np.pi, 1), [3.0]])
        rot = export._tilt(rng, 40.0)
        extra = port.EX_MAT @ rot @ export._tilt(rng) @ port.EX_MAT
        for g, w in zip(sunrgbd_eval.gt_rt_from_bbox(bbox, rot, extra),
                        eval_j.gt_rt_from_bbox(bbox, rot, extra)):
            np.testing.assert_array_equal(g, w)


def test_decode_sunrgbd_depth_matches_jax():
    raw = np.random.default_rng(0).integers(0, 65536, (48, 64)).astype(np.uint16)
    got = port.decode_sunrgbd_depth(raw)
    np.testing.assert_array_equal(got, driver_j.decode_sunrgbd_depth(raw))
    assert got.dtype == np.uint16 and got.max() == 8000


@pytest.mark.parametrize("masked", [False, True])
def test_backproject_sunrgbd_matches_jax(masked):
    from cppf_tpu.core.geometry import backproject_sunrgbd as backproject_sunrgbd_j

    rng = np.random.default_rng(4)
    depth = rng.integers(500, 6000, (48, 64)).astype(np.float64)
    depth[rng.random(depth.shape) < 0.2] = 0
    K = np.array([[529.5, 0, 31.2], [0, 529.5, 23.7], [0, 0, 1]])
    Rtilt = export._tilt(rng)
    mask = rng.random(depth.shape) < 0.6 if masked else None
    got = backproject_sunrgbd(depth, K, Rtilt, mask)
    np.testing.assert_array_equal(got, backproject_sunrgbd_j(depth, K, Rtilt, mask))
    keep = depth > 0 if mask is None else (depth > 0) & mask
    assert got.shape == (keep.sum(), 3)


def _similar_pair(rng, n=300, outliers=60):
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                  [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                  [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
    src = rng.normal(size=(n, 3))
    tgt = src @ (0.8 * R) + np.array([-0.1, 0.4, 0.2])
    bad = rng.choice(n, outliers, replace=False)
    tgt[bad] += rng.normal(size=(outliers, 3)) * 5.0
    return src, tgt


@pytest.mark.parametrize("fn", ["umeyama", "estimate_similarity_transform",
                                "estimate_restricted_affine_transform"])
def test_alignment_matches_jax(fn):
    """Each solver on the same points (RANSAC under the same np.random
    seed): every output equal to JAX's."""
    src, tgt = _similar_pair(np.random.default_rng(5), outliers=0 if fn == "umeyama" else 60)
    outs = []
    for module in (alignment_j, alignment):
        np.random.seed(11)
        outs.append(getattr(module, fn)(src, tgt))
    for g, w in zip(*outs):
        np.testing.assert_array_equal(g, w)


def test_align_nocs_matches_jax():
    """The legacy NOCS alignment of a rendered-like coordinate map: RTs,
    scales and the error text equal to JAX's under one np.random seed."""
    rng = np.random.default_rng(6)
    h, w = 24, 32
    depth = rng.uniform(600, 900, (h, w))
    masks = np.zeros((h, w, 2), bool)
    masks[2:12, 3:14, 0] = True
    masks[12:22, 15:30, 1] = True
    coords = rng.uniform(0, 1, (h, w, 2, 3))
    K = np.array([[591.0, 0, 16.0], [0, 590.0, 12.0], [0, 0, 1]])
    outs = []
    for module in (alignment_j, alignment):
        np.random.seed(2)
        outs.append(module.align_nocs(np.array([1, 2]), masks, coords, depth, K,
                                      ["BG", "a", "b"]))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    assert outs[1][2] == outs[0][2]


def test_main_needs_cuda_unless_told_cpu(scan_set, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.main(_args(scan_set, str(tmp_path / "out")))
    assert not os.path.exists(tmp_path / "out")
