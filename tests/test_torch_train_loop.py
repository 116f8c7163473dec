"""The port's training loop (train/loop.py, checkpoints.py, decode_val.py)
against the JAX package's at the JAX tests' small size: the whole loop on
JAX's init and key schedule, decode validation on the same weights and
keys, the regression head's contrast validation and its params_zs,
checkpoints that resume and that the runner serves, the command line."""
import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from cppf_tpu.train import loop as loop_j
from cppf_tpu_torch.config import Config, load_config
from cppf_tpu_torch.train import checkpoints, loop, step
from torch_training import jax_params, small_configs

torch.set_num_threads(1)


def test_loop_matches_jax(tmp_path):
    """Two epochs of two steps from JAX's init on JAX's key schedule, with a
    decode validation of 2 poses each epoch: the same metrics.jsonl keys,
    losses to 1e-5, decode metrics to their rounding."""
    cfg_j, cfg = small_configs(decode_val_every=1, decode_val_poses=2)
    params = jax_params(cfg_j)
    loop_j.train(cfg_j, out_dir=str(tmp_path / "jax" / "bowl"), epoch_len=2)
    out = loop.train(cfg, out_dir=str(tmp_path / "torch" / "bowl"), epoch_len=2, device="cpu",
                     init_params=params)
    assert out["state"].step == 2

    def rows(run, name):
        with open(tmp_path / run / "bowl" / name) as f:
            return [json.loads(line) for line in f]

    for got, want in zip(rows("torch", "metrics.jsonl"), rows("jax", "metrics.jsonl"),
                         strict=True):
        assert sorted(got) == sorted(want)
        for k in want:
            if k.startswith("loss"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for got, want in zip(rows("torch", "decode_metrics.jsonl"),
                         rows("jax", "decode_metrics.jsonl"), strict=True):
        assert sorted(got) == sorted(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 0.011, (k, got[k], want[k])
    for name in ("params_best.npz", "config.yaml", "best_decode.pt", "last.pt", "epoch0.pt"):
        assert os.path.exists(tmp_path / "torch" / "bowl" / name), name


def test_train_state_round_trip_and_resume(tmp_path):
    """A saved train state restores weights, Adam moments and step; a
    resumed run continues the step count and the epoch numbers."""
    _, cfg = small_configs(max_epoch=1)
    out_dir = str(tmp_path / "bowl")
    out = loop.train(cfg, out_dir=out_dir, epoch_len=2, device="cpu")
    state = out["state"]
    assert state.step == 1 and os.path.exists(os.path.join(out_dir, "params_best.npz"))
    fresh = step.init_train_state(dataclasses.replace(cfg, seed=5), "cpu")
    checkpoints.load_train_state(out_dir, fresh, name="last")
    assert fresh.step == 1
    for a, b in zip(state.opt.param_groups[0]["params"], fresh.opt.param_groups[0]["params"]):
        assert torch.equal(a, b)
        sa, sb = state.opt.state[a], fresh.opt.state[b]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
        assert float(sa["step"]) == float(sb["step"]) == 1

    cfg.max_epoch = 2
    resumed = loop.train(cfg, out_dir=out_dir, epoch_len=2, device="cpu", resume=True)
    assert resumed["state"].step == 2 and len(resumed["history"]) == 1
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1]


def test_runner_serves_trained_params(tmp_path):
    """params_best.npz with its config.yaml is served by CategoryRunner; on
    a committed bowl view its estimate equals the estimate from the trained
    modules passed in directly."""
    from cppf_tpu_torch.eval.nocs_inference import CategoryRunner
    from cppf_tpu_torch.models.convert import ASSETS
    from cppf_tpu_torch.pipeline.pose import PoseDraws, estimate_pose

    _, cfg = small_configs(max_epoch=1)
    out = loop.train(cfg, out_dir=str(tmp_path / "bowl"), epoch_len=2, device="cpu")
    state = out["state"]
    runner = CategoryRunner("bowl", ckpt_path=str(tmp_path), device="cpu", num_rots=18)
    assert runner.cfg.npoint_pad == 512 and runner.cfg.knn == 12
    with np.load(os.path.join(ASSETS, "bowl_views.npz")) as z:
        pc_raw = z["pc_0"]
    draws = PoseDraws.sample(runner.pcfg, torch.Generator().manual_seed(2), "cpu",
                             n_raw=runner.cfg.npoint_max)
    served, pre = runner.estimate(pc_raw, draws=draws)
    direct = estimate_pose(state.point, state.ppf, pre.pc, pre.normals, pre.n_valid,
                           runner.sphere, runner.pcfg, nbr_idx=pre.nbr_idx, draws=draws)
    for field in ("T", "R", "scale"):
        assert torch.equal(getattr(served, field), getattr(direct, field)), field


def test_main_needs_cuda_unless_told_cpu(tmp_path):
    args = ["category=bowl", "max_epoch=1", "epoch_len=2", "knn=12", "npoint_pad=512",
            "npoint_max=2000", "train_pairs=2048", "batch_size=2", "decode_val_every=0",
            f"out_dir={tmp_path / 'bowl'}"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            loop.main(args)
    out = loop.main(args + ["device=cpu"])
    assert next(out["state"].point.parameters()).device.type == "cpu"
    assert out["state"].step == 1 and np.isfinite(out["best_loss"])
    assert torch.backends.cuda.matmul.allow_tf32 is False
    saved = load_config(snapshot=str(tmp_path / "bowl" / "config.yaml"))
    assert saved.knn == 12 and saved.train_pairs == 2048 and isinstance(saved, Config)


@pytest.mark.parametrize("category", ["laptop"])
def test_decode_validator_matches_jax(category):
    """The held-out poses equal JAX's, and on the committed weights and the
    same key the metrics equal JAX's to their rounding: laptop's right-axis
    terms and its plane-override score."""
    from cppf_tpu.train.decode_val import DecodeValidator as DecodeValidatorJ
    from cppf_tpu_torch.models.convert import ASSETS, load_npz_params
    from cppf_tpu_torch.train.decode_val import DecodeValidator

    cfg_j, cfg = small_configs(category, decode_val_poses=2)
    dv_j, dv = DecodeValidatorJ(cfg_j), DecodeValidator(cfg, "cpu")
    assert len(dv.poses) == len(dv_j.poses) == 2
    for a, b in zip(dv.poses, dv_j.poses):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    params = load_npz_params(os.path.join(ASSETS, f"{category}_params_best.npz"))
    state = step.init_train_state(cfg, "cpu", params=params)
    key = jax.random.PRNGKey(5)
    want = dv_j(params, key)
    got = dv(state.point, state.ppf, tuple(int(v) for v in np.asarray(jax.random.key_data(key))))
    assert sorted(got) == sorted(want)
    assert ("dv_override_up_deg" in got) == (category == "laptop")
    assert "dv_right_line_deg" in got
    for k in want:
        assert abs(got[k] - want[k]) <= 0.011, (k, got[k], want[k])


def test_trainer_renders_jax_sample_stream_at_any_seed(tmp_path, monkeypatch):
    """At cfg.seed 3 the port's train renders the samples of JAX's trainer:
    the dataset it builds is reseeded by shard_dataset, to default_rng(0)
    on one process whatever the seed, as cppf_tpu/train/loop.py:126-132
    reseeds JAX's."""
    from cppf_tpu.data.shapenet import ShapeNetRenderDataset as DatasetJ
    from cppf_tpu.parallel.input_pipeline import shard_dataset as shard_dataset_j

    cfg_j, cfg = small_configs(max_epoch=1, seed=3)
    rendered = []

    class Recording(loop.ShapeNetRenderDataset):
        def sample(self):
            rendered.append(super().sample())
            return rendered[-1]

    monkeypatch.setattr(loop, "ShapeNetRenderDataset", Recording)
    loop.train(cfg, out_dir=str(tmp_path / "bowl"), epoch_len=2, device="cpu")
    assert len(rendered) == cfg.batch_size == 2
    ds_j = shard_dataset_j(DatasetJ(cfg_j, seed=cfg_j.seed))
    for got in rendered:
        want = ds_j.sample()
        np.testing.assert_array_equal(got.pc, want.pc)
        np.testing.assert_array_equal(got.bound, want.bound)
        assert got.scale == want.scale


# the val scene cropped to its two bowls at 4 mm (rows 200-289, columns
# 120-289 and 350-494), so that a contrast validation takes seconds on the
# CPU; the pairs and the threshold scaled together (10 · 30 000 / 500 000)
VAL_BOXES = ((slice(200, 290), slice(120, 290)), (slice(200, 290), slice(350, 495)))
VAL_PAIRS, VAL_THRESH = 30000, 0.6


def _reduced_validation(monkeypatch, module):
    """``module``'s make_val_scene cropped to VAL_BOXES and its
    proposal_contrast_score at VAL_PAIRS and VAL_THRESH (each trainer
    imports both from the module when it runs)."""
    make, score = module.make_val_scene, module.proposal_contrast_score

    def make_val_scene(category):
        depth, centers = make(category)
        crop = np.zeros_like(depth)
        for box in VAL_BOXES:
            crop[box] = depth[box]
        return crop, centers

    def proposal_contrast_score(*args, **kw):
        return score(*args, **dict(kw, n_pairs=VAL_PAIRS, prop_thresh=VAL_THRESH))

    monkeypatch.setattr(module, "make_val_scene", make_val_scene)
    monkeypatch.setattr(module, "proposal_contrast_score", proposal_contrast_score)


def _record_saves(monkeypatch, ckpt_module, out_dir, saved):
    """Record, for every params_zs that ``ckpt_module.save_params`` writes,
    the epoch of the zs_metrics.jsonl line just written."""
    save = ckpt_module.save_params

    def save_params(*args, name="params_best", **kw):
        if name == "params_zs":
            with open(os.path.join(out_dir, "zs_metrics.jsonl")) as f:
                saved.append(json.loads(f.readlines()[-1])["epoch"])
        return save(*args, name=name, **kw)

    monkeypatch.setattr(ckpt_module, "save_params", save_params)


def _warm_start_dirs(tmp_path):
    """A JAX and a port run directory, each holding the committed params_zs
    as its params_best (both trainers' weights-only warm start), so that
    the contrast validations score a model that finds the bowls."""
    from cppf_tpu.train import checkpoints as checkpoints_j
    from cppf_tpu_torch.models.convert import ASSETS, load_npz_params

    dirs = tmp_path / "jax" / "bowl", tmp_path / "torch" / "bowl"
    src = os.path.join(ASSETS, "bowl_reg_params_zs.npz")
    checkpoints_j.save_params(str(dirs[0]), load_npz_params(src), name="params_best")
    os.makedirs(dirs[1])
    shutil.copy(src, dirs[1] / "params_best.npz")
    return dirs


def test_contrast_validation_matches_jax(tmp_path, monkeypatch):
    """The regression head with contrast_val_every=1, two epochs of one step
    from the committed params_zs: zs_metrics.jsonl equals JAX's (hits and
    false positives exact, contrast and score to 1e-4 relative: the
    network's float32 rounding), and params_zs is written at the same
    epochs, each a new best."""
    import cppf_tpu.eval.contrast_val as contrast_val_j
    from cppf_tpu.train import checkpoints as checkpoints_j
    from cppf_tpu_torch.eval import contrast_val

    cfg_j, cfg = small_configs(cls_bins=False, contrast_val_every=1)
    dir_j, dir_t = _warm_start_dirs(tmp_path)
    saved_j, saved_t = [], []
    for module in (contrast_val_j, contrast_val):
        _reduced_validation(monkeypatch, module)
    _record_saves(monkeypatch, checkpoints_j, str(dir_j), saved_j)
    _record_saves(monkeypatch, checkpoints, str(dir_t), saved_t)
    loop_j.train(cfg_j, out_dir=str(dir_j), epoch_len=2, resume=True)
    loop.train(cfg, out_dir=str(dir_t), epoch_len=2, device="cpu", resume=True)

    def rows(d):
        with open(d / "zs_metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    got, want = rows(dir_t), rows(dir_j)
    assert [r["epoch"] for r in want] == [0, 1]
    for g, w in zip(got, want, strict=True):
        assert sorted(g) == sorted(w)
        assert (g["epoch"], g["zs_hits"], g["zs_false"]) == (w["epoch"], w["zs_hits"], w["zs_false"])
        for k in ("zs_mean_contrast", "zs_score"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    assert want[0]["zs_hits"] == 2
    assert saved_t == saved_j and saved_j[0] == 0
    assert os.path.exists(dir_t / "params_zs.npz")


def test_contrast_validation_keeps_standing_best(tmp_path, monkeypatch):
    """A run in a directory whose zs_metrics.jsonl already holds a better
    score (an earlier run's, as after a resume) appends its own line but
    writes no params_zs, as the JAX trainer reads the standing best from
    that file (cppf_tpu/train/loop.py:184-189); params_zs.npz reloads
    into the encoders."""
    from cppf_tpu_torch.eval import contrast_val

    _reduced_validation(monkeypatch, contrast_val)
    _, cfg = small_configs(cls_bins=False, contrast_val_every=1, max_epoch=1)
    _, dir_t = _warm_start_dirs(tmp_path)
    standing = {"zs_score": 1e9, "zs_hits": 2, "zs_false": 0, "zs_mean_contrast": 1.0,
                "epoch": 7}
    with open(dir_t / "zs_metrics.jsonl", "w") as f:
        f.write(json.dumps(standing) + "\n")
    out = loop.train(cfg, out_dir=str(dir_t), epoch_len=2, device="cpu", resume=True)
    with open(dir_t / "zs_metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert lines[0] == standing and len(lines) == 2 and lines[1]["epoch"] == 0
    assert not os.path.exists(dir_t / "params_zs.npz")

    # the round trip of the weights the trainer writes as params_zs
    checkpoints.save_params(str(dir_t), out["state"], cfg, name="params_zs")
    fresh = step.init_train_state(dataclasses.replace(cfg, seed=5), "cpu")
    checkpoints.load_params_into(str(dir_t), fresh, name="params_zs")
    for a, b in zip(out["state"].point.parameters(), fresh.point.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(out["state"].ppf.parameters(), fresh.ppf.parameters()):
        assert torch.equal(a, b)
