"""The reference CPPF's ``.pth`` checkpoints in the port, against the JAX
package: the encoders' and the segmenter's converters, the ``.pth`` pairs
each package writes and reads, the order in which every loader of served
weights looks for them, and ``ops/knn.py::pairwise_dist``."""
import dataclasses
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf_tpu.models import convert as convert_j
from cppf_tpu.models.encoders import PointEncoder as PointEncoderJ
from cppf_tpu.models.encoders import PPFEncoder as PPFEncoderJ
from cppf_tpu.ops.knn import knn_indices as knn_j
from cppf_tpu.ops.knn import pairwise_dist as pairwise_dist_j
from cppf_tpu.train import checkpoints as checkpoints_j
from cppf_tpu_torch.core import threefry
from cppf_tpu_torch.eval import zero_shot as zs
from cppf_tpu_torch.eval.nocs_inference import CategoryRunner
from cppf_tpu_torch.models import convert
from cppf_tpu_torch.models.segmenter import FCNResNet50
from cppf_tpu_torch.ops.knn import pairwise_dist
from cppf_tpu_torch.scripts import eval_checkpoints as ec
from cppf_tpu_torch.train import checkpoints
from test_segmenter import _torch_fcn_resnet50_in

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIM = 2 * 8 + 2 * 6 + 2 + 3  # a small pair head
FEAT_TOL = 1e-5                   # tests/test_torch_encoders.py's float32 tolerances
PRED_TOL = 1e-4


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _cloud(n=64, k=8, seed=0):
    rng = np.random.default_rng(seed)
    pc = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    normals = rng.normal(size=(n, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    nbr = np.array(knn_j(jnp.asarray(pc), k, chunk=n))
    idxs = rng.integers(0, n, (200, 2)).astype(np.int32)
    return pc, normals, nbr, idxs


@pytest.fixture(scope="module")
def jax_params():
    """Seeded JAX encoder params (as tests/test_models_parity.py makes them)
    with a small pair head."""
    pc, normals, nbr, idxs = _cloud()
    point = PointEncoderJ().init(jax.random.PRNGKey(0), jnp.asarray(pc), jnp.asarray(normals),
                                 jnp.asarray(nbr))
    # the point features: 32 from the SPRIN layer and 8 global
    feat = np.random.default_rng(1).normal(size=(len(pc), 40)).astype(np.float32)
    ppf = PPFEncoderJ(out_dim=OUT_DIM).init(jax.random.PRNGKey(1), jnp.asarray(pc),
                                            jnp.asarray(normals), jnp.asarray(feat),
                                            jnp.asarray(idxs))
    return jax.tree.map(np.array, {"point": point, "ppf": ppf})


# ---- (a) the encoders' mapping ------------------------------------------------
def test_to_torch_equals_jax(jax_params):
    for ours, theirs, tree in ((convert.point_encoder_to_torch, convert_j.point_encoder_to_torch,
                                jax_params["point"]),
                               (convert.ppf_encoder_to_torch, convert_j.ppf_encoder_to_torch,
                                jax_params["ppf"])):
        got, want = ours(tree), theirs(tree)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert "res_layers.0.fc0.weight" in convert.ppf_encoder_to_torch(jax_params["ppf"])
    assert "res_layers.1.fc0.weight" not in convert.ppf_encoder_to_torch(jax_params["ppf"])


def test_from_torch_returns_jax_params(jax_params):
    point_sd = convert_j.point_encoder_to_torch(jax_params["point"])
    ppf_sd = convert_j.ppf_encoder_to_torch(jax_params["ppf"])
    assert_trees_equal(convert.point_encoder_from_torch(point_sd), jax_params["point"])
    assert_trees_equal(convert.ppf_encoder_from_torch(ppf_sd), jax_params["ppf"])
    # and from torch tensors, as torch.load gives them
    assert_trees_equal(convert.ppf_encoder_from_torch(
        {k: torch.from_numpy(np.array(v)) for k, v in ppf_sd.items()}),
        jax_params["ppf"])


def test_encoders_from_reference_weights_match_flax(jax_params):
    """The port's encoders on the mapped reference state_dicts against
    JAX's on its params, float32: features to 1e-5, pair logits to 1e-4."""
    sd = {"point": convert_j.point_encoder_to_torch(jax_params["point"]),
          "ppf": convert_j.ppf_encoder_to_torch(jax_params["ppf"])}
    params = {"point": convert.point_encoder_from_torch(sd["point"]),
              "ppf": convert.ppf_encoder_from_torch(sd["ppf"])}
    point, ppf = convert.load_encoders(params, OUT_DIM, "cpu")
    pc, normals, nbr, idxs = _cloud(seed=2)
    feat_j = PointEncoderJ().apply(jax_params["point"], jnp.asarray(pc), jnp.asarray(normals),
                                   jnp.asarray(nbr))
    preds_j = PPFEncoderJ(out_dim=OUT_DIM).apply(jax_params["ppf"], jnp.asarray(pc),
                                                 jnp.asarray(normals), feat_j,
                                                 jnp.asarray(idxs))
    t = [torch.from_numpy(a) for a in (pc, normals, nbr)]
    with torch.no_grad():
        feat = point(*t)
        preds = ppf(t[0], t[1], torch.from_numpy(np.array(feat_j)), torch.from_numpy(idxs))
    np.testing.assert_allclose(feat.numpy(), np.asarray(feat_j), atol=FEAT_TOL)
    np.testing.assert_allclose(preds.numpy(), np.asarray(preds_j), atol=PRED_TOL)


def test_head_width_must_match_the_config(jax_params):
    with pytest.raises(RuntimeError, match="final.weight"):
        convert.load_encoders(jax_params, OUT_DIM + 1, "cpu")


def test_a_key_the_mapping_does_not_read_raises(jax_params):
    """A second SPRIN layer under num_layers=1 (JAX drops it and serves a
    truncated network) or a stray head raises; a missing key too."""
    point_sd = convert_j.point_encoder_to_torch(jax_params["point"])
    extra = dict(point_sd, **{"spconvs.1.outnet.weight": point_sd["spconvs.0.outnet.weight"]})
    with pytest.raises(ValueError, match="spconvs.1.outnet.weight"):
        convert.point_encoder_from_torch(extra)
    assert "spconv1" not in convert_j.point_encoder_from_torch(extra)["params"]
    ppf_sd = convert_j.ppf_encoder_to_torch(jax_params["ppf"])
    with pytest.raises(ValueError, match="res_layers.3.fc1.bias"):
        convert.ppf_encoder_from_torch(dict(ppf_sd, **{"res_layers.3.fc1.bias": np.zeros(3)}))
    del ppf_sd["final.bias"]
    with pytest.raises(KeyError, match="final.bias"):
        convert.ppf_encoder_from_torch(ppf_sd)


# ---- (b) the .pth pairs across the packages ---------------------------------
def test_pth_pairs_read_back_across_the_packages(jax_params, tmp_path):
    ours = (str(tmp_path / "point_ours.pth"), str(tmp_path / "ppf_ours.pth"))
    theirs = (str(tmp_path / "point_jax.pth"), str(tmp_path / "ppf_jax.pth"))
    convert.export_reference_pth(jax_params, *ours)
    convert_j.export_reference_pth(jax_params, *theirs)
    assert_trees_equal(checkpoints_j.load_reference_pth(*ours), jax_params)
    assert_trees_equal(checkpoints.load_reference_pth(*theirs), jax_params)
    assert_trees_equal(checkpoints.load_reference_pth(*ours), jax_params)
    sd = convert.load_torch_state_dict(ours[0])
    assert all(isinstance(v, np.ndarray) and v.dtype == np.float32 for v in sd.values())


# ---- (c) bowl's committed weights served from a .pth pair -------------------
def _write_pair(d, name, params):
    os.makedirs(d, exist_ok=True)
    convert.export_reference_pth(params, *checkpoints.reference_pair(str(d), name))


def test_bowl_served_from_pth_poses_as_from_npz(tmp_path):
    """The upstream layout, <ckpt_path>/bowl/{point,ppf}_encoder_epochbest.pth
    with the config snapshot, serves view 0 on JAX's draws as the committed
    .npz does, to the bit (at 20 000 pairs, phase 9's CPU width)."""
    weights = convert.load_npz_params(os.path.join(convert.ASSETS, "bowl_params_best.npz"))
    _write_pair(tmp_path / "bowl", "best", weights)
    shutil.copy(os.path.join(ROOT, "checkpoints", "bowl", "config.yaml"), tmp_path / "bowl")
    pth = CategoryRunner("bowl", device="cpu", ckpt_path=str(tmp_path))
    npz = CategoryRunner("bowl", device="cpu")
    assert_trees_equal(_runner_weights(pth), _runner_weights(npz))
    with np.load(os.path.join(convert.ASSETS, "bowl_views.npz")) as z:
        pc = z["pc_0"]
    for r in (pth, npz):
        r.pcfg = dataclasses.replace(r.pcfg, n_pairs=20_000)
    outs = [r.estimate(pc, draws=r.draws(threefry.key(0)))[0] for r in (pth, npz)]
    for k in ("T", "up", "right", "scale", "RT", "n_filtered"):
        np.testing.assert_array_equal(getattr(outs[0], k).numpy(), getattr(outs[1], k).numpy(),
                                      err_msg=k)
    assert int(outs[0].n_filtered) > 0


# ---- (d) the order in which each loader looks ------------------------------
def _runner_weights(runner):
    flat = convert.modules_to_flat_params(runner.point_encoder, runner.ppf_encoder)
    tree: dict = {}
    for key, arr in flat.items():
        *parts, leaf = key.split("/")
        node = tree
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def _load_runner(root, name):
    return _runner_weights(CategoryRunner("bowl", device="cpu", ckpt_path=str(root)))


def _load_cli(root, name):
    return zs.cli_weights(str(root / "bowl"), name)


def _load_eval(root, name):
    return _runner_weights(ec.load_runner("bowl", str(root), ckpt_name=name, device="cpu"))


LOADERS = {"CategoryRunner": _load_runner, "cli_weights": _load_cli,
           "eval_checkpoints --name": _load_eval}


@pytest.fixture(scope="module")
def weights():
    """(A, B): bowl's committed weights, and the same doubled."""
    a = convert.load_npz_params(os.path.join(convert.ASSETS, "bowl_params_best.npz"))
    return a, jax.tree.map(lambda x: 2 * x, a)


def _write_npz(path, params):
    np.savez(path, **dict(_leaves(params)))


@pytest.mark.parametrize("loader", LOADERS)
def test_npz_beats_pair(loader, weights, tmp_path):
    a, b = weights
    _write_pair(tmp_path / "bowl", "best", b)
    _write_npz(tmp_path / "bowl" / "best.npz", a)
    assert_trees_equal(LOADERS[loader](tmp_path, "best"), a)
    os.remove(tmp_path / "bowl" / "best.npz")
    assert_trees_equal(LOADERS[loader](tmp_path, "best"), b)


@pytest.mark.parametrize("loader", LOADERS)
def test_params_best_beats_best(loader, weights, tmp_path):
    """Without a name, each loader takes params_best before best: a
    params_best pair before a best.npz (eval_checkpoints without --name
    follows the runner)."""
    a, b = weights
    os.makedirs(tmp_path / "bowl")
    _write_npz(tmp_path / "bowl" / "best.npz", a)
    assert_trees_equal(LOADERS[loader](tmp_path, None), a)
    _write_pair(tmp_path / "bowl", "params_best", b)
    assert_trees_equal(LOADERS[loader](tmp_path, None), b)


def test_cli_takes_params_zs_first(weights, tmp_path):
    a, b = weights
    _write_pair(tmp_path / "bowl", "params_best", a)
    _write_pair(tmp_path / "bowl", "params_zs", b)
    assert_trees_equal(_load_cli(tmp_path, None), b)


@pytest.mark.parametrize("loader", LOADERS)
def test_half_a_pair_raises(loader, weights, tmp_path):
    _write_pair(tmp_path / "bowl", "best", weights[0])
    os.remove(checkpoints.reference_pair(str(tmp_path / "bowl"), "best")[1])
    with pytest.raises(FileNotFoundError):
        LOADERS[loader](tmp_path, "best")


@pytest.mark.parametrize("loader", LOADERS)
def test_unreadable_npz_warns_and_the_pair_serves(loader, weights, tmp_path, caplog):
    _write_pair(tmp_path / "bowl", "best", weights[1])
    (tmp_path / "bowl" / "best.npz").write_bytes(b"PK\x03\x04 cut short")
    with caplog.at_level(logging.WARNING, logger="cppf_tpu_torch.checkpoints"):
        assert_trees_equal(LOADERS[loader](tmp_path, "best"), weights[1])
    assert "unreadable checkpoint" in caplog.text and "best.npz" in caplog.text


@pytest.mark.parametrize("loader", LOADERS)
def test_a_key_left_unread_raises(loader, weights, tmp_path):
    _write_pair(tmp_path / "bowl", "best", weights[0])
    point_pth = checkpoints.reference_pair(str(tmp_path / "bowl"), "best")[0]
    sd = torch.load(point_pth, weights_only=True)
    sd["aggrs.1.linear.bias"] = sd["aggrs.0.linear.bias"]
    torch.save(sd, point_pth)
    with pytest.raises(ValueError, match="aggrs.1.linear.bias"):
        LOADERS[loader](tmp_path, "best")


# ---- (e) the segmenter ------------------------------------------------------
SEG_TORCH_TOL = 1e-4   # of the largest logit: the port and the oracle, both torch
SEG_JAX_ATOL, SEG_JAX_RTOL = 2e-3, 1e-3  # tests/test_segmenter.py's, torch against flax


def test_segmenter_from_a_torchvision_state_dict():
    """torchvision's fcn_resnet50 with InstanceNorms that keep running
    statistics (tests/test_segmenter.py's oracle), seeded weights and
    statistics, 64×96: the port's conversion is JAX's to the bit, and its
    track_stats segmenter gives the oracle's eval logits and JAX's."""
    from cppf_tpu.models.segmenter import FCNResNet50 as FCNResNet50J

    oracle = _torch_fcn_resnet50_in(num_classes=2)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for _, p in oracle.named_parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
        for name, b in oracle.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=gen) * 0.1)
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=gen) * 0.5 + 0.75)
    oracle.eval()
    x = torch.randn(1, 3, 64, 96, generator=gen)
    with torch.no_grad():
        want = oracle(x)["out"].numpy().transpose(0, 2, 3, 1)
    sd = {k: v.numpy() for k, v in oracle.state_dict().items()}
    assert any(k.endswith("num_batches_tracked") for k in sd)
    params = convert.fcn_resnet50_from_torch(sd)
    assert_trees_equal(params, jax.tree.map(np.ascontiguousarray,
                                            convert_j.fcn_resnet50_from_torch(sd)))
    # the inverse gives the oracle's keys back, but the unread counters
    back = convert.fcn_resnet50_to_torch(params)
    assert sorted(back) == sorted(k for k in sd if not k.endswith("num_batches_tracked"))
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)
    model = FCNResNet50(2, track_stats=True)
    model.load_state_dict(convert.segmenter_state_dict(params), strict=True)
    with torch.no_grad():
        got = model.eval()(x.permute(0, 2, 3, 1)).numpy()
    assert got.shape == want.shape == (1, 64, 96, 2)
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= SEG_TORCH_TOL * scale
    out_j = np.asarray(FCNResNet50J(num_classes=2, track_stats=True).apply(
        convert_j.fcn_resnet50_from_torch(sd), jnp.asarray(x.numpy().transpose(0, 2, 3, 1))))
    np.testing.assert_allclose(got, out_j, atol=SEG_JAX_ATOL, rtol=SEG_JAX_RTOL)
    with pytest.raises(ValueError, match="aux_classifier.0.weight"):
        convert.fcn_resnet50_from_torch(dict(sd, **{"aux_classifier.0.weight": np.zeros(1)}))


# ---- (f) pairwise_dist ------------------------------------------------------
def test_pairwise_dist_matches_jax():
    rng = np.random.default_rng(3)
    a = (rng.normal(size=(300, 3)) * 0.2 + [0, 0, 1]).astype(np.float32)
    b = np.concatenate([a[:50], (rng.normal(size=(200, 3)) * 0.2).astype(np.float32)])
    got = pairwise_dist(torch.from_numpy(a), torch.from_numpy(b).double())
    assert got.dtype == torch.float32 and got.shape == (300, 250)
    np.testing.assert_allclose(got.numpy(), np.asarray(pairwise_dist_j(jnp.asarray(a),
                                                                       jnp.asarray(b))),
                               atol=1e-5)
    assert float(got.min()) >= 0.0
