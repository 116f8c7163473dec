"""The port's copy of JAX's default random numbers (core/threefry.py)
against jax.random: keys, splits and uniform bits equal, gumbel and normal
draws within float32 rounding; and PoseDraws.from_jax_key against the draws
the slice tests make with jax.random from the same key."""
import jax
import numpy as np
import pytest
import torch

from cppf_tpu_torch.core import threefry
from cppf_tpu_torch.pipeline.pose import PoseDraws
from torch_slices import jax_draws, small_configs

torch.set_num_threads(1)


def _draw(kind, k, shape):
    """One draw of ``threefry.draw_many``, on the CPU."""
    return threefry.draw_many([(kind, k, shape)], "cpu")[0]


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 5])
def test_keys_and_uniform_bits_equal(seed):
    key = jax.random.PRNGKey(seed)
    assert threefry.key(seed) == tuple(int(v) for v in np.asarray(jax.random.key_data(key)))
    assert threefry.split(threefry.key(seed), 5) == [
        tuple(int(v) for v in k) for k in np.asarray(jax.random.split(key, 5))]
    for shape in [(5,), (37, 3), (100_003, 2)]:
        np.testing.assert_array_equal(_draw("uniform", threefry.key(seed), shape).numpy(),
                                      np.asarray(jax.random.uniform(key, shape)))


def test_gumbel_and_normal_within_rounding():
    key = jax.random.PRNGKey(11)
    g = _draw("gumbel", threefry.key(11), (2000, 36)).numpy()
    np.testing.assert_allclose(g, np.asarray(jax.random.gumbel(key, (2000, 36))), rtol=1e-6,
                               atol=1e-6)
    n = _draw("normal", threefry.key(11), (30_000, 3)).numpy()
    np.testing.assert_allclose(n, np.asarray(jax.random.normal(key, (30_000, 3))), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("category", ["bowl", "mug"])
def test_pose_draws_from_jax_key(category):
    """A runner's draws from a JAX key: jitter from the preprocess half of
    the key's split, the pose draws from the other, as
    CategoryRunner.estimate splits it."""
    _, pcfg, _ = small_configs(category)
    key = jax.random.PRNGKey(5)
    got = PoseDraws.from_jax_key(pcfg, np.asarray(jax.random.key_data(key)), "cpu", n_raw=1000)
    r_pre, r_pose = jax.random.split(key)
    want = jax_draws(r_pose, pcfg)
    np.testing.assert_array_equal(got.pair_u.numpy(), want.pair_u.numpy())
    pairs = [(got.tr_gumbel, want.tr_gumbel), (got.fallback_normal, want.fallback_normal),
             (got.jitter, torch.from_numpy(np.array(jax.random.normal(r_pre, (1000, 3)))))]
    for a, b in zip((*got.up, *(got.right or ())), (*want.up, *(want.right or ()))):
        pairs.append((a, b))
    assert (got.right is None) == (want.right is None) == (not pcfg.regress_right)
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_draw_many_equals_one_draw_at_a_time():
    """One pass of the hash over several draws' counters, each with its own
    key, gives each draw bit for bit."""
    keys = threefry.split(threefry.key(3), 4)
    shapes = [(1000, 2), (7,), (333, 3), (50, 36)]
    kinds = ["uniform", "normal", "normal", "gumbel"]
    got = threefry.draw_many(list(zip(kinds, keys, shapes)), "cpu")
    for kind, k, shape, g in zip(kinds, keys, shapes, got):
        assert g.shape == shape and g.dtype == torch.float32
        assert torch.equal(g, _draw(kind, k, shape)), kind


@pytest.mark.parametrize("seed", [0, 1, 2**32 - 5])
def test_fold_in_and_bernoulli(seed):
    """fold_in on the trainer's epoch numbers and draw_many's "bernoulli"
    kind as bernoulli(0.5), the trainer's random normal signs."""
    key = jax.random.PRNGKey(seed)
    for data in (0, 1, 7, 199, 2**31 - 1):
        assert threefry.fold_in(threefry.key(seed), data) == tuple(
            int(v) for v in np.asarray(jax.random.key_data(jax.random.fold_in(key, data))))
    for shape in ((4096, 1), (1000,)):
        got = threefry.draw_many([("bernoulli", threefry.key(seed), shape)], "cpu")[0]
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got, np.asarray(jax.random.bernoulli(key, 0.5, shape)))


def test_batch_draws_from_jax_key():
    """The trainer's batch draws: split(key, B), each row's key split into
    preprocess / pairs / sign keys (cppf_tpu/train/loop.py:55-63)."""
    from cppf_tpu_torch.config import load_config
    from cppf_tpu_torch.train.loop import BatchDraws

    cfg = load_config("bowl")
    cfg.npoint_max, cfg.train_pairs, cfg.npoint_pad = 700, 900, 300
    key = jax.random.fold_in(jax.random.PRNGKey(1), 3)
    got = BatchDraws.from_jax_key(np.asarray(jax.random.key_data(key)), 3, cfg, "cpu")
    for i, k in enumerate(jax.random.split(key, 3)):
        pre, pairs, sign = jax.random.split(k, 3)
        np.testing.assert_allclose(got.jitter[i].numpy(),
                                   np.asarray(jax.random.normal(pre, (700, 3))), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(got.pair_u[i].numpy(),
                                      np.asarray(jax.random.uniform(pairs, (900, 2))))
        np.testing.assert_array_equal(got.keep_sign[i].numpy(),
                                      np.asarray(jax.random.bernoulli(sign, 0.5, (300, 1))))
