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
