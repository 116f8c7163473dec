"""The port's zero-shot command line (eval/zero_shot.py::main) against the
JAX package's: the same detections and the same picture on the demo frame,
the rules that pick its weights, and the RANSAC draws it shares with JAX.

The demo frame at 200 000 pairs gives no detection in either package (the
contrast threshold is set for 5 M pairs), and the port's KNN takes minutes
on the CPU over its whole cloud; so the comparison runs the depth frame
cropped to a pixel box around its two bowls (as
tests/test_torch_zero_shot_demo.py), where both packages find both bowls
at 200 000 pairs."""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from cppf_tpu.eval import zero_shot as zs_j
from cppf_tpu_torch.data.png import read_png, write_png
from cppf_tpu_torch.eval import zero_shot as zs
from cppf_tpu_torch.models.convert import ASSETS, load_npz_params

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH = os.path.join(ROOT, "data", "demo", "0000_depth.png")
COLOR = os.path.join(ROOT, "data", "demo", "0000_color.png")
T_TOL = 1e-3


def test_plane_uniforms_are_jax_draws():
    """scene_planes' default RANSAC uniforms are JAX's (they were a torch
    Generator's, which made the CLI's plane veto draw other numbers than
    JAX's)."""
    for seed in (0, 1, 5):
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (200, 3)))
        np.testing.assert_array_equal(zs.plane_uniforms(seed).numpy(), want)


def test_cli_matches_jax_on_cropped_demo(tmp_path, monkeypatch):
    """``main --ckpt checkpoints/bowl_reg --n_pairs 200000`` on the cropped
    depth frame: both bowls, each T within 1 mm of JAX's and scale within
    1e-5 m; the written PNG equals JAX's pixel for pixel (draw_line is
    cv2.line's pixels exactly), and differs from the colour frame only in
    red pixels."""
    import cppf_tpu.utils.cache

    # JAX's CLI would set a compilation cache outside the test's directory
    monkeypatch.setattr(cppf_tpu.utils.cache, "enable_compilation_cache", lambda *a, **k: None)
    depth = read_png(DEPTH)
    crop = np.zeros_like(depth)
    box = (slice(105, 285), slice(300, 460))
    crop[box] = depth[box]
    write_png(str(tmp_path / "depth.png"), crop)
    args = ["--ckpt", os.path.join(ROOT, "checkpoints", "bowl_reg"), "--color", COLOR,
            "--depth", str(tmp_path / "depth.png"), "--n_pairs", "200000"]
    dets_j = []
    detect_j = zs_j.zero_shot_detect

    def recording_detect(*a, **k):
        dets_j.extend(detect_j(*a, **k))
        return dets_j

    monkeypatch.setattr(zs_j, "zero_shot_detect", recording_detect)
    zs_j.main(args + ["--out", str(tmp_path / "jax.png")])
    dets, img = zs.main(args + ["--out", str(tmp_path / "torch.png"), "--device", "cpu"])
    assert len(dets) == len(dets_j) == 2
    for d, d_j in zip(dets, dets_j):
        assert np.linalg.norm(d.T - d_j.T) < T_TOL
        np.testing.assert_allclose(d.scale, d_j.scale, atol=1e-5)
    got, want = read_png(str(tmp_path / "torch.png")), read_png(str(tmp_path / "jax.png"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)
    color = read_png(COLOR)
    drawn = (got != color).any(-1)
    assert drawn.sum() > 100
    assert (got[drawn] == [255, 0, 0]).all()


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _same_tree(a, b):
    a, b = dict(_leaves(a)), dict(_leaves(b))
    return sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)


def test_cli_weights(tmp_path):
    """params_zs first, then params_best; --params_name picks one; the
    repo's own checkpoints/bowl_reg (and a link to it) serves its orbax
    params_zs/ (equal to the exported asset) and, named, its params_best/;
    a name it lacks and any other directory without weights raise.  (The
    reference .pth pairs among these names: tests/test_torch_reference_pth.py.)"""
    from cppf_tpu_torch.train.orbax import restore_numpy

    repo = os.path.join(ROOT, "checkpoints", "bowl_reg")
    asset = os.path.join(ASSETS, "bowl_reg_params_zs.npz")
    zs_w = load_npz_params(asset)
    assert _same_tree(zs.cli_weights(repo), zs_w)
    os.symlink(repo, tmp_path / "link")
    assert _same_tree(zs.cli_weights(str(tmp_path / "link")), zs_w)
    repo_best = zs.cli_weights(repo, "params_best")
    assert _same_tree(repo_best, restore_numpy(os.path.join(repo, "params_best"))["params"])
    assert not _same_tree(repo_best, zs_w)
    with pytest.raises(FileNotFoundError):
        zs.cli_weights(repo, "best")
    run = tmp_path / "run"
    run.mkdir()
    with pytest.raises(FileNotFoundError, match="params_zs.npz or params_best.npz"):
        zs.cli_weights(str(run))
    # params_best: the asset's weights doubled, to tell the two files apart
    with np.load(asset) as z:
        np.savez(run / "params_best.npz", **{k: 2 * z[k] for k in z.files})
    best_w = load_npz_params(str(run / "params_best.npz"))
    assert not _same_tree(best_w, zs_w)
    assert _same_tree(zs.cli_weights(str(run)), best_w)
    shutil.copy(asset, run / "params_zs.npz")
    assert _same_tree(zs.cli_weights(str(run)), zs_w)
    assert _same_tree(zs.cli_weights(str(run), "params_best"), best_w)


def test_cli_needs_cuda_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        zs.main(["--ckpt", os.path.join(ROOT, "checkpoints", "bowl_reg"),
                 "--out", str(tmp_path / "x.png")])
    assert not os.path.exists(tmp_path / "x.png")
