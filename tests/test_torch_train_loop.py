"""The port's training loop (train/loop.py, checkpoints.py, decode_val.py)
against the JAX package's at the JAX tests' small size: the whole loop on
JAX's init and key schedule, decode validation on the same weights and
keys, checkpoints that resume and that the runner serves, the command line."""
import dataclasses
import json
import os

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
