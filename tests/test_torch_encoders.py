"""The port's encoders, with the bowl weights carried across, against flax."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf_tpu.data.synthetic import PRIMITIVES, sample_surface
from cppf_tpu.models.encoders import PointEncoder as PointEncoderJ
from cppf_tpu.models.encoders import PPFEncoder as PPFEncoderJ
from cppf_tpu.ops.knn import knn_indices as knn_j
from cppf_tpu.ops.normals import estimate_normals as normals_j
from cppf_tpu.train.checkpoints import load_params
from cppf_tpu_torch.models.convert import load_encoders, params_to_state_dicts
from cppf_tpu_torch.models.encoders import LN_EPS

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIM = 2 * 32 + 2 * 36 + 2 + 3


@pytest.fixture(scope="module")
def bowl_params():
    return load_params(os.path.join(ROOT, "checkpoints", "bowl"), "params_best")


@pytest.fixture(scope="module")
def cloud():
    n, n_valid, k = 384, 340, 16
    rng = np.random.default_rng(0)
    pc = np.zeros((n, 3), np.float32)
    pc[:n_valid] = sample_surface(PRIMITIVES["bowl"](), n_valid, rng) + np.float32([0, 0, 0.6])
    valid = np.arange(n) < n_valid
    nbr = np.array(knn_j(jnp.asarray(pc), k, jnp.asarray(valid)))
    normals = np.array(normals_j(jnp.asarray(pc), k, jnp.asarray(valid),
                                 nbr_idx=jnp.asarray(nbr)))
    idxs = rng.integers(0, n_valid, (1000, 2)).astype(np.int32)
    return pc, normals, nbr, valid, idxs


def test_state_dicts_cover_every_parameter(bowl_params):
    point_sd, ppf_sd = params_to_state_dicts(bowl_params)
    assert point_sd["spconv0.kernel.lin0.weight"].shape == (32, 6)
    assert ppf_sd["final.weight"].shape == (OUT_DIM, 16)
    point, ppf = load_encoders(bowl_params, OUT_DIM, "cpu")  # strict=True inside
    assert point.spconv0.norm.eps == LN_EPS == 1e-6
    np.testing.assert_array_equal(
        point.spconv0.kernel.ln1.weight.detach().numpy(),
        bowl_params["point"]["params"]["spconv0"]["kernel"]["ln1"]["scale"])


def _apply_both(bowl_params, cloud, dtype):
    pc, normals, nbr, valid, idxs = cloud
    point, ppf = load_encoders(bowl_params, OUT_DIM, "cpu")
    point, ppf = point.to(dtype), ppf.to(dtype)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    params = jax.tree.map(lambda a: jnp.asarray(a, np_dt), bowl_params)
    pc, normals = pc.astype(np_dt), normals.astype(np_dt)
    pe_j = PointEncoderJ(spfcs=(32, 64, 32, 32), out_dim=32, num_layers=1)
    ppf_j = PPFEncoderJ(ppffcs=(84, 32, 32, 16), out_dim=OUT_DIM)
    feat_j = pe_j.apply(params["point"], *(jnp.asarray(a) for a in (pc, normals, nbr, valid)))
    preds_j = ppf_j.apply(params["ppf"], jnp.asarray(pc), jnp.asarray(normals), feat_j,
                          jnp.asarray(idxs))
    t = [torch.from_numpy(a) for a in (pc, normals, nbr, valid)]
    with torch.no_grad():
        feat_t = point(*t)
        preds_t = ppf(t[0], t[1], torch.from_numpy(np.array(feat_j)), torch.from_numpy(idxs))
        preds_chain = ppf(t[0], t[1], feat_t, torch.from_numpy(idxs))
    return [np.asarray(a) for a in (feat_j, preds_j)], [a.numpy() for a in (feat_t, preds_t,
                                                                           preds_chain)]


def test_encoders_match_flax(bowl_params, cloud):
    """float32, as the pipeline runs: features to 1e-5.  The pair head's
    logits to 1e-4: its hidden activations reach ~20, where 1e-5 is three
    float32 ulps, and after four dense layers whose sums MKL and XLA order
    differently the two sides sit a few ulps apart (each as close to the
    float64 result as the other)."""
    (feat_j, preds_j), (feat_t, preds_t, preds_chain) = _apply_both(bowl_params, cloud,
                                                                     torch.float32)
    np.testing.assert_allclose(feat_t, feat_j, atol=1e-5)
    np.testing.assert_allclose(preds_t, preds_j, atol=1e-4)
    np.testing.assert_allclose(preds_chain, preds_j, atol=1e-4)
    assert np.mean(np.abs(preds_t - preds_j) < 1e-5) > 0.99


def test_encoders_match_flax_float64(bowl_params, cloud):
    """The same function: in float64 the two agree to 1e-10."""
    with jax.enable_x64(True):
        (feat_j, preds_j), (feat_t, preds_t, preds_chain) = _apply_both(bowl_params, cloud,
                                                                         torch.float64)
    assert feat_j.dtype == np.float64
    np.testing.assert_allclose(feat_t, feat_j, atol=1e-10)
    np.testing.assert_allclose(preds_t, preds_j, atol=1e-10)
    np.testing.assert_allclose(preds_chain, preds_j, atol=1e-10)


FULL_PAIRS = 4096
# the PPF head's logits at full width (ROADMAP §C2): scripts/category_near_ties.py
# measured up to 1.09e-3 apart between the packages, 3.7e-5 of the largest logit
FULL_LOGIT_ATOL = 2e-3
FULL_LOGIT_RTOL_OF_MAX = 1e-4


def test_logits_match_flax_at_full_width(bowl_params):
    """Bowl's committed view 0 (1277 points on the 4 mm voxel grid),
    preprocessed as the runner serves it (JAX's ``preprocess_cloud`` at
    npoint_pad 4096, knn 60, no jitter), the served weights at full width,
    4096 pairs: the port's logits from its own features within 2e-3 of
    flax's and within 1e-4 of the largest logit (1.854e-3 and 2.3e-5 of
    79.81 measured here)."""
    from cppf_tpu.pipeline.preprocess import preprocess_cloud
    from cppf_tpu_torch.models.convert import ASSETS

    raw = np.load(os.path.join(ASSETS, "bowl_views.npz"))["pc_0"]
    pad = np.zeros((10000, 3), np.float32)
    pad[:len(raw)] = raw
    pre = preprocess_cloud(jax.random.PRNGKey(0), jnp.asarray(pad), len(raw), 4e-3,
                           npoint_pad=4096, knn=60, jitter=False)
    n_valid = int(pre.n_valid)
    assert n_valid == 1277 and pre.nbr_idx.shape == (4096, 60)
    idxs = np.random.default_rng(1).integers(0, n_valid, (FULL_PAIRS, 2)).astype(np.int32)
    pe_j = PointEncoderJ(spfcs=(32, 64, 32, 32), out_dim=32, num_layers=1)
    ppf_j = PPFEncoderJ(ppffcs=(84, 32, 32, 16), out_dim=OUT_DIM)
    feat_j = pe_j.apply(bowl_params["point"], pre.pc, pre.normals, pre.nbr_idx, pre.valid_mask)
    preds_j = np.asarray(ppf_j.apply(bowl_params["ppf"], pre.pc, pre.normals, feat_j,
                                     jnp.asarray(idxs)))
    point, ppf = load_encoders(bowl_params, OUT_DIM, "cpu")
    t = [torch.from_numpy(np.array(a)) for a in (pre.pc, pre.normals, pre.nbr_idx,
                                                  pre.valid_mask)]
    with torch.no_grad():
        preds_t = ppf(t[0], t[1], point(*t), torch.from_numpy(idxs)).numpy()
    d = float(np.abs(preds_t - preds_j).max())
    top = float(np.abs(preds_j).max())
    assert d <= FULL_LOGIT_ATOL, d
    assert d <= FULL_LOGIT_RTOL_OF_MAX * top, (d, top)
