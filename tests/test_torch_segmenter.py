"""The port's laptop segmenter (models/segmenter.py, its weights in
models/convert.py, its loss and step in train/laptop_aux.py) against
cppf_tpu's FCNResNet50 on identical weights and inputs.

Tolerances: logits within 1e-4 of each map's max |logit|; on the committed
weights at 224², labels equal wherever JAX's margin exceeds 1e-3; the loss
1e-6 relative; one Adam step (no dropout) against ``jax.value_and_grad`` of
``FCNResNet50.apply(train=False)`` with ``optax.adam``, both in float64:
loss 1e-5 relative, gradients 1e-4 of each tensor's maximum, weights 1e-6
(and the float32 loss 1e-5)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf_tpu.models.segmenter import FCNResNet50 as FCNResNet50J
from cppf_tpu_torch.models.convert import (ASSETS, load_npz_params, save_segmenter_npz,
                                           segmenter_flat_params, segmenter_state_dict)
from cppf_tpu_torch.models.segmenter import DROPOUT, FCNResNet50, SegmenterRunner
from cppf_tpu_torch.train.laptop_aux import ce_ignore_loss, make_optimizer, seg_train_step
from cppf_tpu_torch.train.step import flax_init_

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_RTOL = 1e-4
# the Adam step's depth: every kind of block (the first of each layer with
# its down-projection, and layer3's and layer4's dilated others) at a
# third of the full net's compile time
ADAM_LAYERS = (1, 1, 2, 2)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _seeded_params(layers, track, seed=0):
    """JAX's init at ``layers``, with the norms' scales, biases and (with
    ``track``) running statistics drawn from a seed, so that no norm is
    the identity."""
    model = FCNResNet50J(2, layers=tuple(layers), track_stats=track)
    params = _numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(seed),
                                             jnp.zeros((1, 64, 64, 3))))
    rng = np.random.default_rng(seed)

    def fill(path, v):
        leaf = path[-1].key
        if leaf == "mean":
            return rng.normal(0, 0.5, v.shape).astype(np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        if leaf == "scale":
            return rng.normal(1.0, 0.3, v.shape).astype(np.float32)
        if leaf == "bias":
            return rng.normal(0.0, 0.3, v.shape).astype(np.float32)
        return v

    return model, jax.tree_util.tree_map_with_path(fill, params)


def _torch_model(params, layers=(3, 4, 6, 3), track=False):
    model = FCNResNet50(2, layers, track)
    model.load_state_dict(segmenter_state_dict(params), strict=True)
    return model.eval()


def _assert_logits(got, want):
    err = np.abs(got - want).max(axis=(-3, -2, -1))
    scale = np.abs(want).max(axis=(-3, -2, -1))
    assert np.all(err <= LOGIT_RTOL * scale), (err, scale)


@pytest.fixture(scope="module")
def seeded():
    """{track_stats: (JAX model, seeded params)} at one block a layer."""
    return {track: _seeded_params((1, 1, 1, 1), track) for track in (False, True)}


@pytest.fixture(scope="module")
def committed():
    """The committed segmenter weights (checkpoints/laptop_aux, orbax),
    read once."""
    from cppf_tpu.train.checkpoints import load_params

    return _numpy_tree(load_params(os.path.join(ROOT, "checkpoints", "laptop_aux"),
                                   name="params_best"))


def test_weights_round_trip(seeded, tmp_path):
    """flax tree → state_dict → flat layout is the identity, leaf for leaf
    (164 arrays, 32 947 266 parameters at full depth), and through
    ``save_segmenter_npz`` / ``load_npz_params`` as well."""
    for track, (_, params) in seeded.items():
        model = _torch_model(params, (1, 1, 1, 1), track)
        flat, want = segmenter_flat_params(model), _flat(params)
        assert flat.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(flat[k], want[k], err_msg=k)
        path = str(tmp_path / f"params_{track}.npz")
        save_segmenter_npz(path, model)
        back = _flat(load_npz_params(path))
        assert back.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    full = segmenter_flat_params(FCNResNet50())
    assert len(full) == 164 and sum(a.size for a in full.values()) == 32_947_266


@pytest.mark.parametrize("track", [False, True], ids=["instance_stats", "running_stats"])
def test_fcn_matches_jax_small(seeded, track):
    """One block a layer at 64×64, batch 2, on seeded params: per-sample
    InstanceNorm, and the running statistics of converted weights."""
    model_j, params = seeded[track]
    x = np.random.default_rng(3).random((2, 64, 64, 3), dtype=np.float32)
    want = np.asarray(model_j.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _torch_model(params, (1, 1, 1, 1), track)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 2)
    _assert_logits(got, want)


def _laptop_crops():
    """Crops of the kind the segmenter meets: the laptop frame's (where the
    committed asset is present) and a rendered training sample."""
    from cppf_tpu_torch.data.laptop_aux import LaptopAuxDataset

    crops = [LaptopAuxDataset(data_root="/nonexistent", seed=5).sample()[0]]
    path = os.path.join(ASSETS, "nocs_laptop_frame", "jax_driver.npz")
    with np.load(path) as z:
        crops.append(z["crop"])
    return np.stack(crops)


def test_fcn_matches_jax_on_committed_weights(committed, tmp_path):
    """The whole net at 224² on the committed weights: logits within 1e-4
    of the maximum, labels equal wherever JAX's margin exceeds 1e-3, and
    ``SegmenterRunner`` over the weights' ``.npz`` gives the same labels."""
    x = _laptop_crops()
    logits_j = np.asarray(jax.jit(FCNResNet50J(2).apply)(committed, jnp.asarray(x)))
    with torch.no_grad():
        logits_t = _torch_model(committed)(torch.from_numpy(x)).numpy()
    _assert_logits(logits_t, logits_j)
    margin = np.abs(logits_j[..., 1] - logits_j[..., 0])
    clear = margin > 1e-3
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(logits_t.argmax(-1)[clear], logits_j.argmax(-1)[clear])
    np.savez(str(tmp_path / "params_best.npz"), **_flat(committed))
    runner = SegmenterRunner(str(tmp_path), device="cpu")
    assert not runner.model.stem_bn.track_stats
    for i in range(len(x)):
        pred = runner.predict(x[i])
        assert pred.shape == (224, 224)
        np.testing.assert_array_equal(pred[clear[i]], logits_j[i].argmax(-1)[clear[i]])


def test_upsample_matches_jax_image_resize():
    """The head's 28 → 224 bilinear upsample (``align_corners=False``) is
    ``jax.image.resize(..., "bilinear")`` on an upsample, edges included."""
    y = np.random.default_rng(0).normal(size=(2, 28, 28, 2)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(y), (2, 224, 224, 2), "bilinear"))
    got = torch.nn.functional.interpolate(torch.from_numpy(y).permute(0, 3, 1, 2), size=(224, 224),
                                          mode="bilinear", align_corners=False)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-6)


def test_ce_ignore_loss_matches_jax():
    from cppf_tpu.train.laptop_aux import ce_ignore_loss as ce_j

    rng = np.random.default_rng(1)
    logits = rng.normal(0, 3, (2, 16, 16, 2)).astype(np.float32)
    labels = rng.integers(0, 2, (2, 16, 16))
    labels[rng.random(labels.shape) < 0.3] = -100
    for lab in (labels, np.full_like(labels, -100)):
        want = float(ce_j(jnp.asarray(logits), jnp.asarray(lab)))
        got = float(ce_ignore_loss(torch.from_numpy(logits), torch.from_numpy(lab)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


def test_adam_step_matches_jax():
    """One step at 32×32, batch 2, from JAX's init at ``ADAM_LAYERS``: the
    loss, the gradient of every parameter and the weights after
    ``optax.adam(1e-3)``, both packages in float64.  In float32 the gradients of the deep layers are
    ill-conditioned: the InstanceNorm backward subtracts each map's mean
    from a gradient that its mean dominates, and the torch step in float32
    is itself up to ~25 % of a layer's largest gradient off the same step
    in float64 (layer4), so no two float32 implementations meet 1e-4 there.
    The float32 loss is held to JAX's float32 loss."""
    import optax

    from cppf_tpu.train.laptop_aux import ce_ignore_loss as ce_j

    rng = np.random.default_rng(2)
    x = rng.random((2, 32, 32, 3), dtype=np.float32)
    y = rng.integers(0, 2, (2, 32, 32)).astype(np.int32)
    y[rng.random(y.shape) < 0.2] = -100
    model_j = FCNResNet50J(2, layers=ADAM_LAYERS)
    params = _numpy_tree(jax.jit(model_j.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    model = FCNResNet50(2, ADAM_LAYERS)
    model.load_state_dict(segmenter_state_dict(params), strict=True)
    with torch.no_grad():
        loss32 = ce_ignore_loss(model(torch.from_numpy(x)), torch.from_numpy(y).long())
    loss32_j = ce_j(jax.jit(model_j.apply)(params, jnp.asarray(x)), jnp.asarray(y))
    assert float(loss32) == pytest.approx(float(loss32_j), rel=1e-5)

    tx = optax.adam(1e-3)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        x64, y64 = jnp.asarray(x, jnp.float64), jnp.asarray(y)

        @jax.jit
        def step(p):
            loss, g = jax.value_and_grad(
                lambda p: ce_j(model_j.apply(p, x64, train=False), y64))(p)
            upd, _ = tx.update(g, tx.init(p), p)
            return loss, g, optax.apply_updates(p, upd)

        loss_j, grads_j, after_j = jax.tree_util.tree_map(np.asarray, step(p64))
    model = model.double().train()
    opt = make_optimizer(model, 1e-3)
    grads = {}
    for name, p in model.named_parameters():
        p.register_hook(lambda g, name=name: grads.__setitem__(name, g.clone()))
    loss = seg_train_step(model, opt, torch.from_numpy(x).double(),
                          torch.from_numpy(y).long())
    assert float(loss) == pytest.approx(float(loss_j), rel=1e-5)
    grads_want, after_want = segmenter_state_dict(grads_j), segmenter_state_dict(after_j)
    assert grads.keys() == grads_want.keys()
    for name, g in grads.items():
        want = grads_want[name]
        err = float((g - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), (name, err)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), after_want[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


def test_dropout_keep_rate_and_scale():
    """The head drops a feature with probability 0.1 and scales the kept
    ones by 1/0.9; the mask comes from the generator and is the same for
    the same seed."""
    model = FCNResNet50(2, layers=(1, 1, 1, 1))
    flax_init_(model, torch.Generator().manual_seed(0))
    feats = {}
    model.head_out.register_forward_pre_hook(lambda m, a: feats.__setitem__("x", a[0]))
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model(x)
        plain = feats["x"].clone()
        out_a = model(x, torch.Generator().manual_seed(7))
        dropped = feats["x"].clone()
        out_b = model(x, torch.Generator().manual_seed(7))
    assert torch.equal(out_a, out_b)
    live = plain != 0
    kept = dropped[live] != 0
    assert abs(float(kept.float().mean()) - (1 - DROPOUT)) < 0.01
    torch.testing.assert_close(dropped[live][kept], plain[live][kept] / (1 - DROPOUT),
                               rtol=1e-6, atol=0)


def test_flax_init_moments():
    """The flax-style init: each conv kernel truncated at ±2σ with
    variance 1/fan_in, biases 0, norm scales 1; the same seed, the same
    weights."""
    a, b = FCNResNet50(2), FCNResNet50(2)
    flax_init_(a, torch.Generator().manual_seed(0))
    flax_init_(b, torch.Generator().manual_seed(0))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    w = a.layer3_1.conv2.weight.detach()
    fan_in = w[0].numel()
    assert float(w.var()) == pytest.approx(1.0 / fan_in, rel=0.05)
    assert float(w.abs().max()) <= 2 * (1.0 / fan_in) ** 0.5 / 0.87962566103423978 + 1e-6
    assert float(a.head_out.bias.detach().abs().max()) == 0
    assert float(a.head_bn.weight.detach().min()) == 1
