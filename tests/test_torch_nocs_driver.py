"""The port's NOCS driver against cppf_tpu's, end to end on one synthetic
frame at a reduced width (snapshot: 2048 pairs, 512 points, knn 16,
npoint_max 4000; 12 rotations, a 3° sphere): three bowls (a batched chunk padded from 3 to 4) and a
mug (a singleton, with its second center pass and regressed right axis),
the trained weights of both.  Both drivers run from ``--seed 0`` on one
checkpoint tree: orbax weights for JAX, the same weights as ``.npz`` beside
each snapshot for the port.  Each instance's pose must match to the slice
tolerances (tests/torch_slices.py::assert_slices_match): T and R to 1e-6,
scales rtol 1e-5; batched, ``--serial`` and ``--bbox_mask``.

Also here: the batched runner against one-instance calls on the same keys,
the ``anchor_t`` post-step against the JAX runner's, and the driver's
refusals (no CUDA, a checkpoint directory without its own weights).  The
laptop path with its segmenter is in test_torch_nocs_laptop.py."""
import importlib.util
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from cppf_tpu.config import load_config as load_config_j
from cppf_tpu_torch.core import threefry
from cppf_tpu_torch.eval import nocs_inference as port
from cppf_tpu_torch.models.convert import ASSETS

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "export_torch_assets", os.path.join(ROOT, "scripts", "export_torch_assets.py"))
export = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(export)

# instances close enough that each box takes in part of a neighbour, so
# that --bbox_mask crops differ from the masks'.  The frame has no planar
# background: box edges would cut it in straight rows of points, whose KNN
# normals are ill-conditioned and differ between the packages in float32
# rounding (ROADMAP §C, test_normals_of_collinear_rows_are_ill_conditioned)
LAYOUT = (("bowl", -0.09, 0.06, 0.80), ("mug", 0.02, 0.02, 0.86),
          ("bowl", 0.11, 0.06, 0.84), ("bowl", 0.0, -0.06, 0.98))
SMALL = dict(infer_pairs=2048, npoint_pad=512, knn=16, npoint_max=4000)
# 12 rotations a pair and a 3° sphere (240 directions) keep the axis votes
# of both drivers cheap; both CLIs take them
WIDTH = ["--num_rots", "12", "--angle_prec", "3"]
MODES = {"batched": [], "serial": ["--serial"], "bbox_mask": ["--bbox_mask"]}


def _checkpoint_tree(root, categories):
    """Each category's training snapshot at the test width, its orbax
    weights (a link) for JAX and their .npz export beside it for the port."""
    for cat in categories:
        d = os.path.join(root, cat)
        os.makedirs(d)
        cfg = load_config_j(cat, snapshot=os.path.join(ROOT, "checkpoints", cat, "config.yaml"))
        for k, v in SMALL.items():
            setattr(cfg, k, v)
        cfg.save(os.path.join(d, "config.yaml"))
        os.symlink(os.path.join(ROOT, "checkpoints", cat, "params_best"),
                   os.path.join(d, "params_best"))
        shutil.copy(os.path.join(ASSETS, f"{cat}_params_best.npz"),
                    os.path.join(d, "params_best.npz"))
    return root


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("nocs_frame"))
    seg_dir, nocs_dir, record = export.render_nocs_frame(tmp, LAYOUT, seed=3)
    ckpt = _checkpoint_tree(os.path.join(tmp, "checkpoints"), {c for c, *_ in LAYOUT})
    return dict(tmp=tmp, seg_dir=seg_dir, nocs_dir=nocs_dir, ckpt=ckpt, record=record)


def _args(frame, out_dir, extra):
    return ["--seg_dir", frame["seg_dir"], "--nocs_dir", frame["nocs_dir"], "--out_dir",
            out_dir, "--ckpt_path", frame["ckpt"], "--seed", "0", *WIDTH, *extra]


def _load(out_dir):
    with open(os.path.join(out_dir, "results_real_scene_1_0000.pkl"), "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(frame):
    """Both drivers in each mode: {mode: (JAX pkl, port pkl, port chunks)};
    the JAX driver once a mode, since its compiles are the cost."""
    from cppf_tpu.eval import nocs_inference as jax_driver

    out = {}
    for mode, extra in MODES.items():
        d_j, d_t = (os.path.join(frame["tmp"], f"{who}_{mode}") for who in ("jax", "port"))
        jax_driver.main(_args(frame, d_j, extra))
        chunks = port.main(_args(frame, d_t, extra + ["--device", "cpu"]))
        out[mode] = (_load(d_j), _load(d_t), chunks[0])
    return out


def _rotation(RT):
    return RT[:3, :3] / np.cbrt(np.linalg.det(RT[:3, :3]))


@pytest.mark.parametrize("mode", list(MODES))
def test_driver_matches_jax(runs, frame, mode):
    res_j, res_t, chunks = runs[mode]
    n = len(LAYOUT)
    assert res_t["pred_RTs"].shape == (n, 4, 4) and res_t["pred_RTs"].dtype == np.float32
    assert res_t["pred_scales"].shape == (n, 3) and res_t["pred_scales"].dtype == np.float32
    for key in frame["record"]:
        if key != "pred_masks":
            np.testing.assert_array_equal(res_t[key], res_j[key])
    for i in range(n):
        RT_j, RT_t = res_j["pred_RTs"][i], res_t["pred_RTs"][i]
        assert not np.allclose(RT_t, np.eye(4)), f"instance {i} was not posed"
        np.testing.assert_allclose(RT_t[:3, 3], RT_j[:3, 3], atol=1e-6)
        np.testing.assert_allclose(_rotation(RT_t), _rotation(RT_j), atol=1e-6)
        np.testing.assert_allclose(np.linalg.norm(RT_t[:3, :3], axis=0),
                                   np.linalg.norm(RT_j[:3, :3], axis=0), rtol=1e-5)
        np.testing.assert_allclose(res_t["pred_scales"][i], res_j["pred_scales"][i], rtol=1e-5)
        assert np.linalg.det(RT_t[:3, :3]) > 0
    # bowl (3 instances, padded to 4) batched unless --serial; mug alone
    shape = [(c.category, c.instances, c.batched) for c in chunks]
    if mode == "serial":
        assert shape == [("bowl", 1, False)] * 3 + [("mug", 1, False)]
    else:
        assert shape == [("bowl", 3, True), ("mug", 1, False)]


def test_bbox_mask_changes_the_crops(runs):
    """``--bbox_mask`` poses each instance on its whole box (the masks are
    copied, not written into the record): the poses must differ."""
    res_plain, res_box = runs["batched"][1], runs["bbox_mask"][1]
    assert not np.allclose(res_plain["pred_RTs"], res_box["pred_RTs"])
    np.testing.assert_array_equal(res_box["pred_masks"], res_plain["pred_masks"])


@pytest.fixture(scope="module")
def runner():
    """Bowl's runner at the test width."""
    import dataclasses

    runner = port.CategoryRunner("bowl", device="cpu", num_rots=12, angle_prec=3.0)
    runner.cfg.npoint_pad, runner.cfg.knn, runner.cfg.npoint_max = 512, 16, 4000
    runner.pcfg = dataclasses.replace(runner.pcfg, n_pairs=2048, knn=16, rot_subsample=2048)
    return runner


def _frame_bowls(frame):
    from cppf_tpu_torch.data.png import read_png

    depth = read_png(os.path.join(frame["nocs_dir"], "real", "scene_1", "0000_depth.png"))
    groups = port.frame_crops(depth, frame["record"], {"bowl": True})
    return [pc for _, pc in groups["bowl"]]


def test_estimate_batch_equals_one_instance_calls(frame, runner, monkeypatch):
    """Row i of a B = 3 batch padded to 4 equals ``estimate`` on the
    preprocess key i and the pose key 4 + i of the batch's split, bit for
    bit; the padding row is not run."""
    pcs = _frame_bowls(frame)
    assert len(pcs) == 3
    key = threefry.split(threefry.key(9))[1]
    calls = []
    real = runner.estimate

    def counting(pc, **kw):
        calls.append(len(pc))
        return real(pc, **kw)

    monkeypatch.setattr(runner, "estimate", counting)
    out, pre = runner.estimate_batch(pcs, key, pad_to=4)
    monkeypatch.undo()
    assert calls == [len(pc) for pc in pcs] and out.T.shape == (3, 3) and pre.pc.shape[0] == 3
    keys = threefry.split(key, 8)
    for i, pc in enumerate(pcs):
        draws = port.PoseDraws.from_jax_keys(runner.pcfg, keys[i], keys[4 + i], "cpu",
                                             n_raw=runner.cfg.npoint_max)
        one, one_pre = runner.estimate(pc, draws=draws)
        for name, a, b in zip(one._fields, one, out):
            assert torch.equal(a, b[i]), (i, name)
        for name, a, b in zip(one_pre._fields, one_pre, pre):
            assert torch.equal(a, b[i]), (i, name)


def test_estimate_pose_batch_equals_one_instance_calls(frame, runner):
    """``estimate_pose_batch`` poses row i on its own cloud, neighbours and
    draws: bit for bit ``estimate_pose`` of that row."""
    from cppf_tpu_torch.pipeline.pose import estimate_pose, estimate_pose_batch
    from cppf_tpu_torch.pipeline.preprocess import preprocess_cloud_batch

    pcs = _frame_bowls(frame)[:2]
    keys = threefry.split(threefry.key(6), 4)
    draws = [port.PoseDraws.from_jax_keys(runner.pcfg, keys[i], keys[2 + i], "cpu",
                                          n_raw=runner.cfg.npoint_max) for i in range(2)]
    pads, n_raws = zip(*(port._pad_cloud(pc, runner.cfg.npoint_max) for pc in pcs))
    pre = preprocess_cloud_batch(torch.from_numpy(np.stack(pads)), n_raws, runner.cfg.res,
                                 torch.stack([d.jitter for d in draws]),
                                 npoint_pad=runner.cfg.npoint_pad, knn=runner.cfg.knn)
    args = (runner.point_encoder, runner.ppf_encoder)
    out = estimate_pose_batch(*args, pre.pc, pre.normals, pre.n_valid, runner.sphere,
                              runner.pcfg, draws, pre.nbr_idx)
    for i, d in enumerate(draws):
        one = estimate_pose(*args, pre.pc[i], pre.normals[i], pre.n_valid[i], runner.sphere,
                            runner.pcfg, nbr_idx=pre.nbr_idx[i], draws=d)
        for name, a, b in zip(one._fields, one, out):
            assert torch.equal(a, b[i]), (i, name)


def test_preprocess_cloud_batch_matches_jax(frame):
    """The batched preprocess on JAX's keys (each row its own jitter) equals
    cppf_tpu's vmapped one."""
    import jax
    import jax.numpy as jnp

    from cppf_tpu.pipeline.preprocess import preprocess_cloud_batch as batch_j
    from cppf_tpu_torch.pipeline.preprocess import preprocess_cloud_batch

    pcs = _frame_bowls(frame)
    n_max = 4000
    pads, n_raws = zip(*(port._pad_cloud(pc, n_max) for pc in pcs))
    pads = np.stack(pads)
    keys = jax.random.split(jax.random.PRNGKey(2), len(pcs))
    pre_j = batch_j(keys, jnp.asarray(pads), jnp.asarray(n_raws, jnp.int32), 4e-3,
                    npoint_pad=512, knn=16)
    noises = torch.stack(threefry.draw_many(
        [("normal", tuple(int(v) for v in np.asarray(k)), (n_max, 3)) for k in keys], "cpu"))
    pre_t = preprocess_cloud_batch(torch.from_numpy(pads), n_raws, 4e-3, noises,
                                   npoint_pad=512, knn=16)
    np.testing.assert_array_equal(pre_t.n_valid.numpy(), np.asarray(pre_j.n_valid))
    np.testing.assert_array_equal(pre_t.raw_idx.numpy(), np.asarray(pre_j.raw_idx))
    np.testing.assert_allclose(pre_t.pc.numpy(), np.asarray(pre_j.pc), atol=1e-7)
    np.testing.assert_allclose(pre_t.normals.numpy(), np.asarray(pre_j.normals), atol=1e-5)


def _anchor_case():
    """The box of tests/test_drivers.py::test_runner_anchor_post_step: its
    full surface observed, the voted center biased."""
    rng = np.random.default_rng(0)
    center = np.array([0.05, -0.1, 1.1])
    R = np.eye(3, dtype=np.float32)
    scale = np.array([0.2, 0.08, 0.2], np.float32)
    pts = []
    for axis in range(3):
        for side in (-0.5, 0.5):
            p = rng.uniform(-0.5, 0.5, (600, 3))
            p[:, axis] = side
            pts.append(p)
    pts = (np.concatenate(pts) * scale + center).astype(np.float32)
    T = (center + np.array([0.02, -0.02, 0.015])).astype(np.float32)
    s_norm = float(np.linalg.norm(scale))
    RT = np.eye(4, dtype=np.float32)
    RT[:3, :3] = R * s_norm
    RT[:3, 3] = T
    return dict(T=T, R=R, scale=scale, RT=RT, scale_unit=scale / s_norm, up=R[:, 1],
                right=R[:, 0], n_filtered=np.int32(1000), grid_max=np.float32(1.0)), pts


def test_anchor_post_step_matches_jax(runner):
    from cppf_tpu.eval.nocs_inference import CategoryRunner as RunnerJ
    from cppf_tpu.pipeline.pose import PoseResult as PoseResultJ
    from cppf_tpu_torch.pipeline.pose import PoseResult

    fields, pts = _anchor_case()
    want = RunnerJ._anchor(None, PoseResultJ(**fields), pts)
    got = runner._anchor(PoseResult(**{k: torch.as_tensor(v) for k, v in fields.items()}), pts)
    assert got.T.dtype == torch.float32
    np.testing.assert_array_equal(got.T.numpy(), np.asarray(want.T))
    np.testing.assert_array_equal(got.RT.numpy(), np.asarray(want.RT))
    np.testing.assert_array_equal(got.R.numpy(), fields["R"])
    assert np.linalg.norm(got.T.numpy() - np.array([0.05, -0.1, 1.1])) < 0.004


def test_anchor_t_runs_in_estimate_and_estimate_batch(frame, runner, monkeypatch):
    """With ``anchor_t`` on, both runner calls anchor each row on its own
    raw cloud, and touch nothing but T and RT's translation."""
    pcs = _frame_bowls(frame)[:2]
    key = threefry.key(4)
    plain, _ = runner.estimate_batch(pcs, key)
    one, _ = runner.estimate(pcs[0], draws=runner.draws(key))
    monkeypatch.setattr(runner.cfg, "anchor_t", True)
    anchored, _ = runner.estimate_batch(pcs, key)
    one_anchored, _ = runner.estimate(pcs[0], draws=runner.draws(key))
    for i, pc in enumerate(pcs):
        row = type(plain)(*(f[i] for f in plain))
        want = runner._anchor(row, pc)
        assert torch.equal(anchored.T[i], want.T) and torch.equal(anchored.RT[i], want.RT)
        assert torch.equal(anchored.R[i], plain.R[i])
    assert torch.equal(one_anchored.T, runner._anchor(one, pcs[0]).T)
    assert not torch.equal(one_anchored.T, one.T)


def test_main_needs_cuda_unless_told_cpu(frame, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.main(_args(frame, str(tmp_path / "out"), []))
    assert not os.path.exists(tmp_path / "out")


def test_checkpoint_without_its_own_weights_is_skipped(tmp_path, monkeypatch):
    """A ``<ckpt_path>/<cat>`` that holds a snapshot but no weights (no
    orbax ``params_best/``, no ``params_best.npz``) has no weights the port
    can read: the runner raises and the driver skips the category, as JAX's
    skips a directory without weights.  A link to the repo's directory
    serves its orbax ``params_best/``, equal to the export in ``assets/``,
    which no runtime path reads."""
    from cppf_tpu_torch.models.convert import load_npz_params
    from cppf_tpu_torch.train import checkpoints as ckpt_t

    ckpt = tmp_path / "ckpt"
    (ckpt / "bowl").mkdir(parents=True)
    shutil.copy(os.path.join(ROOT, "checkpoints", "bowl", "config.yaml"), ckpt / "bowl")
    with pytest.raises(FileNotFoundError, match="params_best.npz"):
        port.CategoryRunner("bowl", device="cpu", ckpt_path=str(ckpt))
    os.symlink(os.path.join(ROOT, "checkpoints", "mug"), ckpt / "mug")
    served, npz_read = [], []
    real_any, real_npz = port.maybe_load_any, ckpt_t.load_npz_params
    monkeypatch.setattr(port, "maybe_load_any",
                        lambda path, name: served.append(real_any(path, name)) or served[-1])
    monkeypatch.setattr(ckpt_t, "load_npz_params",
                        lambda path: npz_read.append(path) or real_npz(path))
    args = port.build_parser().parse_args(["--ckpt_path", str(ckpt), "--device", "cpu"])
    assert list(port.load_runners(args)) == ["mug"]
    served = [p for p in served if p is not None]
    assert npz_read == [] and len(served) == 1
    want = load_npz_params(os.path.join(ASSETS, "mug_params_best.npz"))
    got = served[0]
    for top in ("point", "ppf"):
        flat_got, flat_want = (dict(_flat_tree(t[top])) for t in (got, want))
        assert sorted(flat_got) == sorted(flat_want)
        for k, v in flat_want.items():
            assert flat_got[k].tobytes() == v.tobytes(), k


def _flat_tree(tree, prefix=""):
    for k, v in tree.items():
        yield from (_flat_tree(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)])


def test_normals_of_collinear_rows_are_ill_conditioned():
    """Why the --bbox_mask frame has no planar background: a box edge cuts
    a plane in straight rows of points.  Where a point's neighbours all lie
    in its row, the two smallest eigenvalues of their covariance are nearly
    equal and the closed-form normal is float32 rounding: the packages'
    normals then differ by up to a whole direction, while on a plane they
    agree to 1e-6."""
    import jax.numpy as jnp

    from cppf_tpu.ops.knn import knn_indices as knn_j
    from cppf_tpu.ops.normals import estimate_normals as normals_j
    from cppf_tpu_torch.ops.normals import estimate_normals

    rng = np.random.default_rng(0)
    x = np.arange(-0.1, 0.1, 0.004)
    rows = np.concatenate([np.stack([x, -0.27 + 0.08 * r + rng.normal(0, 5e-4, len(x)),
                                     1.69 + rng.normal(0, 5e-4, len(x))], -1)
                           for r in range(3)]).astype(np.float32)
    grid = np.stack(np.meshgrid(x, np.arange(-0.05, 0.05, 0.004)), -1).reshape(-1, 2)
    plane = np.concatenate([grid, 1.2 + 0.3 * grid[:, :1] + 0.1 * grid[:, 1:]],
                           -1).astype(np.float32)
    diffs = []
    for pc in (rows, plane):
        nbr = np.array(knn_j(jnp.asarray(pc), 16))
        n_j = np.asarray(normals_j(jnp.asarray(pc), 16, nbr_idx=jnp.asarray(nbr)))
        n_t = estimate_normals(torch.from_numpy(pc), 16, nbr_idx=torch.from_numpy(nbr)).numpy()
        diffs.append(np.abs(n_t - n_j).max())
    pts = rows.astype(np.float64)
    for nb in np.array(knn_j(jnp.asarray(rows), 16)):
        c = pts[nb] - pts[nb].mean(0)
        ev = np.linalg.eigvalsh(c.T @ c)
        assert ev[1] < 6 * ev[0]
    assert diffs[0] > 0.1 and diffs[1] < 1e-6
