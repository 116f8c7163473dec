"""The port's soft-binning codec, voting targets and training losses
(core/binning.py, core/targets.py, train/losses.py) against the JAX
package's on the same numpy inputs."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf_tpu.core import binning as bin_j
from cppf_tpu.core import targets as tgt_j
from cppf_tpu.train import losses as loss_j
from cppf_tpu_torch.core import binning, targets
from cppf_tpu_torch.train import losses

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


def _cloud(seed, n=400, n_valid=350):
    """A canonical-frame cloud with unit normals, its padding rows zero."""
    rng = np.random.default_rng(seed)
    pc = (rng.normal(size=(n, 3)) * [0.06, 0.04, 0.05]).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    pc[n_valid:] = 0
    nrm[n_valid:] = 0
    return pc, nrm, n_valid


@pytest.mark.parametrize("circular", [False, True])
@pytest.mark.parametrize("max_val,num_bins", [(0.24, 32), (np.pi, 36), (2 * np.pi, 12)])
def test_real2prob_prob2real(circular, max_val, num_bins):
    rng = np.random.default_rng(num_bins)
    val = rng.uniform(0, max_val, size=(500,)).astype(np.float32)
    val[:3] = [0.0, max_val, max_val / 2]
    p_j = np.asarray(bin_j.real2prob(jnp.asarray(val), max_val, num_bins, circular))
    p_t = binning.real2prob(t(val), max_val, num_bins, circular).numpy()
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=1e-6)
    logits = rng.normal(size=(500, num_bins)).astype(np.float32)
    prob = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    r_j = np.asarray(bin_j.prob2real(jnp.asarray(prob), max_val, num_bins, circular))
    r_t = binning.prob2real(t(prob), max_val, num_bins, circular).numpy()
    np.testing.assert_allclose(r_t, r_j, rtol=0, atol=1e-6)


def test_decode_bins():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(300, 32)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    gumbel = np.asarray(jax.random.gumbel(key, logits.shape))
    want = np.asarray(bin_j.decode_bin_sample(key, jnp.asarray(logits), 0.24, -0.12))
    got = binning.decode_bin_sample(t(gumbel), t(logits), 0.24, -0.12).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_allclose(binning.decode_bin_argmax(t(logits), np.pi).numpy(),
                               np.asarray(bin_j.decode_bin_argmax(jnp.asarray(logits), np.pi)),
                               rtol=0, atol=1e-7)


def test_sample_pair_idxs():
    key = jax.random.PRNGKey(9)
    want = np.asarray(tgt_j.sample_pair_idxs(key, jnp.int32(337), 5000))
    u = np.asarray(jax.random.uniform(key, (5000, 2)))
    got = targets.sample_pair_idxs(t(u), torch.tensor(337, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() == 336 and got.min() == 0


def test_radial_asymmetry_and_base_membership():
    pc, _, n_valid = _cloud(1)
    np.testing.assert_allclose(
        targets.radial_asymmetry(t(pc), n_valid).numpy(),
        np.asarray(tgt_j.radial_asymmetry(jnp.asarray(pc), n_valid)), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        targets.base_membership(t(pc), n_valid).numpy(),
        np.asarray(tgt_j.base_membership(jnp.asarray(pc), n_valid)))


@pytest.mark.parametrize("up_sym,right_sym,z_right",
                         list(itertools.product([False, True], repeat=3)))
@pytest.mark.parametrize("weights", ["plain", "asym_base"])
def test_generate_targets(up_sym, right_sym, z_right, weights):
    pc, nrm, n_valid = _cloud(2)
    rng = np.random.default_rng(5)
    idxs = rng.integers(0, n_valid, size=(3000, 2)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if weights == "asym_base":
        kw_j = dict(asym=tgt_j.radial_asymmetry(jnp.asarray(pc), n_valid),
                    base=tgt_j.base_membership(jnp.asarray(pc), n_valid))
        kw_t = dict(asym=targets.radial_asymmetry(t(pc), n_valid),
                    base=targets.base_membership(t(pc), n_valid))
    want = tgt_j.generate_targets(jnp.asarray(pc), jnp.asarray(nrm), jnp.asarray(idxs),
                                  up_sym, right_sym, z_right, **kw_j)
    got = targets.generate_targets(t(pc), t(nrm), t(idxs), up_sym, right_sym, z_right, **kw_t)
    for field in ("tr", "rot", "aux_weight", "up_rot_weight"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None) == (field == "up_rot_weight" and weights == "plain")
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6,
                                       err_msg=field)
    np.testing.assert_array_equal(got.point_idxs.numpy(), np.asarray(want.point_idxs))
    # the aux bits: equal but where the canonical normal lies in the axis's plane
    aux_t, aux_j = got.rot_aux.numpy(), np.asarray(want.rot_aux)
    w = np.asarray(want.aux_weight)
    if weights == "plain":
        assert np.all((aux_t == aux_j) | (w < 1e-6))
    else:
        assert np.all((aux_t[:, 0] == aux_j[:, 0]) | (w[:, 0] < 1e-6))


def test_soft_bins_and_scale_target():
    """On the same targets (JAX's): the bins turn a target's float32
    rounding into up to 11 times as much mass (1/interval of the angle
    bins), so generate_targets' own 1e-6 is held above, not compounded."""
    pc, nrm, n_valid = _cloud(4)
    idxs = np.random.default_rng(6).integers(0, n_valid, size=(2000, 2)).astype(np.int32)
    tg_j = tgt_j.generate_targets(jnp.asarray(pc), jnp.asarray(nrm), jnp.asarray(idxs))
    tg_t = targets.VotingTargets(*(None if f is None else t(f) for f in tg_j))
    for a, b in zip(targets.soft_bin_targets(tg_t, (0.12, 0.12), 32, 36),
                    tgt_j.soft_bin_targets(tg_j, (0.12, 0.12), 32, 36)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    bound = np.float32([0.8, 0.5, 0.7])
    np.testing.assert_allclose(
        targets.scale_target(t(bound), torch.tensor(0.21), (0.07, 0.03, 0.07)).numpy(),
        np.asarray(tgt_j.scale_target(jnp.asarray(bound), jnp.float32(0.21),
                                      (0.07, 0.03, 0.07))), rtol=0, atol=1e-6)


def _loss_inputs(seed, P=512, B=32, R=36):
    rng = np.random.default_rng(seed)
    preds = rng.normal(size=(P, 2 * B + 2 * R + 5)).astype(np.float32) * 2
    tr = np.asarray(jax.nn.softmax(jnp.asarray(rng.normal(size=(P, 2, B)) * 3), -1))
    tr = np.where(tr < 1e-3, 0.0, tr).astype(np.float32)  # exact zeros: 0·log 0
    rot = np.asarray(jax.nn.softmax(jnp.asarray(rng.normal(size=(P, 2, R)) * 3), -1))
    aux = rng.integers(0, 2, size=(P, 2)).astype(np.float32)
    st = rng.normal(size=(3,)).astype(np.float32)
    aux_w = rng.uniform(size=(P, 2)).astype(np.float32)
    up_w = rng.uniform(0.1, 1.0, size=(P,)).astype(np.float32)
    return preds, tr.astype(np.float32), rot.astype(np.float32), aux, st, aux_w, up_w


@pytest.mark.parametrize("regress_right,weighted,boost",
                         [(False, False, 1.0), (False, True, 1.0), (True, True, 1.0),
                          (True, True, 2.5), (True, False, 1.0)])
def test_ppf_losses(regress_right, weighted, boost):
    preds, tr, rot, aux, st, aux_w, up_w = _loss_inputs(7)
    kw = dict(aux_weight=aux_w, up_rot_weight=up_w) if weighted else {}
    total_j, comps_j = loss_j.ppf_losses(jnp.asarray(preds), tr, rot, aux, st, 32, 36,
                                         regress_right, right_aux_boost=boost,
                                         **{k: jnp.asarray(v) for k, v in kw.items()})
    total_t, comps_t = losses.ppf_losses(t(preds), t(tr), t(rot), t(aux), t(st), 32, 36,
                                         regress_right, right_aux_boost=boost,
                                         **{k: t(v) for k, v in kw.items()})
    assert sorted(comps_t) == sorted(comps_j)
    for k in comps_j:
        np.testing.assert_allclose(float(comps_t[k]), float(comps_j[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(total_t), float(total_j), rtol=1e-6)


def test_ppf_regression_losses():
    rng = np.random.default_rng(8)
    P = 400
    preds = rng.normal(size=(P, 9)).astype(np.float32)
    tr, rot = (rng.normal(size=(P, 2)).astype(np.float32) for _ in range(2))
    aux = rng.integers(0, 2, size=(P, 2)).astype(np.float32)
    st = rng.normal(size=(3,)).astype(np.float32)
    aux_w = rng.uniform(size=(P, 2)).astype(np.float32)
    for w in (None, aux_w):
        _, cj = loss_j.ppf_regression_losses(jnp.asarray(preds), tr, rot, aux, st,
                                             None if w is None else jnp.asarray(w))
        _, ct = losses.ppf_regression_losses(t(preds), t(tr), t(rot), t(aux), t(st),
                                             None if w is None else t(w))
        assert sorted(ct) == sorted(cj)
        for k in cj:
            np.testing.assert_allclose(float(ct[k]), float(cj[k]), rtol=1e-6, err_msg=k)
