"""The port's training step (config.py's training fields, train/step.py,
train/loop.py::build_batch) against the JAX package's at the JAX tests'
small size (tests/test_train.py::_small_cfg): the config, the init, the
step on a JAX-built batch from JAX's init, the device batch prep on JAX's
keys.  The loop itself: tests/test_torch_train_loop.py."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf_tpu.config import load_config as load_config_j
from cppf_tpu.config import parse_cli_overrides as parse_cli_overrides_j
from cppf_tpu.train import step as step_j
from cppf_tpu_torch.config import load_config, parse_cli_overrides
from cppf_tpu_torch.core import binning
from cppf_tpu_torch.models.convert import params_to_state_dicts
from cppf_tpu_torch.train import loop, step
from torch_training import jax_batch, jax_params, small_configs, torch_batch

torch.set_num_threads(1)

CATEGORIES = ("bottle", "bowl", "camera", "can", "laptop", "mug",
              "bathtub", "bed", "bookshelf", "chair", "sofa", "table")


@pytest.mark.parametrize("category", CATEGORIES)
def test_config_equal(category):
    """Every field of the JAX config, layered and from the checkpoint's
    snapshot, equals the port's."""
    snap = os.path.join(os.path.dirname(os.path.dirname(__file__)), "checkpoints", category,
                        "config.yaml")
    for kw in ({}, {"snapshot": snap}):
        cj = dataclasses.asdict(load_config_j(category, **kw))
        ct = dataclasses.asdict(load_config(category, **kw))
        assert ct == cj


def test_cli_overrides_and_save(tmp_path):
    args = ["category=mug", "opt.lr=5e-4", "max_epoch=3", "aux_asym=true", "res=4.0e-3",
            "geo_right_dir=direct", "scale_range=[0.1,0.2]"]
    assert parse_cli_overrides(args) == parse_cli_overrides_j(args)
    over = parse_cli_overrides(args)
    cat = over.pop("category")
    cfg = load_config(cat, over)
    assert cfg.opt.lr == 5e-4 and cfg.opt.weight_decay == 1e-4 and cfg.max_epoch == 3
    assert dataclasses.asdict(cfg) == dataclasses.asdict(load_config_j(cat, over))
    cfg.save(str(tmp_path / "c" / "config.yaml"))
    back = load_config(snapshot=str(tmp_path / "c" / "config.yaml"))
    assert dataclasses.asdict(back) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(load_config_j(snapshot=str(tmp_path / "c" / "config.yaml"))) == \
        dataclasses.asdict(cfg)
    with pytest.raises(ValueError):
        parse_cli_overrides(["max_epoch"])


def test_flax_init_statistics():
    """The flax-style init's weights have the moments of JAX's init, layer
    by layer, within sampling error; biases 0, LayerNorm scales 1."""
    cfg_j, cfg = small_configs()
    state = step.init_train_state(cfg, "cpu")
    again = step.init_train_state(cfg, "cpu")
    params_j = jax_params(cfg_j)
    n_kernels = sum(path[-1].key == "kernel"
                    for path, _ in jax.tree_util.tree_leaves_with_path(params_j))
    sd_j = {}
    for top, sd in zip(("point", "ppf"), params_to_state_dicts(params_j)):
        sd_j.update({f"{top}.{k}": v.numpy() for k, v in sd.items()})
    n_layers = 0
    for top, module, module_again in (("point", state.point, again.point),
                                      ("ppf", state.ppf, again.ppf)):
        for name, m in module.named_modules():
            w_j = sd_j.get(f"{top}.{name}.weight")
            if isinstance(m, torch.nn.Linear):
                n_layers += 1
                w = m.weight.detach().numpy()
                n, fan_in = w.size, w.shape[1]
                sigma = (1.0 / fan_in) ** 0.5
                assert abs(w.mean() - w_j.mean()) < 6 * sigma / n ** 0.5, name
                assert abs(w.std() / w_j.std() - 1) < 6 / n ** 0.5, name
                assert abs(w.std() / sigma - 1) < 6 / n ** 0.5, name
                assert np.abs(w).max() <= 2 * sigma / 0.87962566103423978 + 1e-7
                assert not m.bias.detach().any()
            elif isinstance(m, torch.nn.LayerNorm):
                assert (m.weight.detach() == 1).all() and not m.bias.detach().any()
        for a, b in zip(module.parameters(), module_again.parameters()):
            assert torch.equal(a, b)  # a function of cfg.seed
    assert n_layers == n_kernels


@pytest.mark.parametrize("category,kw", [("bowl", {}), ("bowl", {"cls_bins": False}),
                                         ("laptop", {}), ("mug", {"right_aux_boost": 2.0})])
def test_step_matches_jax(category, kw):
    """On JAX's init and a JAX-built batch: the loss and each component to
    1e-5, every gradient to 1e-4 of its tensor's maximum, the weights after
    3 Adam steps to 1e-5."""
    cfg_j, cfg = small_configs(category, **kw)
    params = jax_params(cfg_j)
    _, batch_j = jax_batch(cfg_j, jax.random.PRNGKey(1))
    statics_j = step_j.TrainStatics.from_config(cfg_j)
    statics = step.TrainStatics.from_config(cfg)
    assert dataclasses.asdict(statics) == dataclasses.asdict(statics_j)
    batch = torch_batch(batch_j)
    assert (batch.aux_weight is None) == (not cfg.aux_weighted)
    assert (batch.up_rot_weight is None) == (not cfg.up_rot_base)
    state = step.init_train_state(cfg, "cpu", params=params)

    # JAX op by op: its float32 order is the one the port follows (rifeat's
    # cosines of near-coincident neighbours magnify any other order; XLA's
    # fused program moves laptop's first-layer gradient by 1.9e-4 of its max)
    (loss_j, comps_j), grads_j = jax.value_and_grad(step_j.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params), batch_j, statics_j)
    state.opt.zero_grad()
    loss, comps = step.loss_fn(state, batch, statics)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    assert sorted(comps) == sorted(comps_j)
    for k in comps_j:
        np.testing.assert_allclose(comps[k].item(), float(comps_j[k]), rtol=1e-5, err_msg=k)
    for (top, module), sd_j in zip((("point", state.point), ("ppf", state.ppf)),
                                   params_to_state_dicts(jax.tree.map(np.asarray, grads_j))):
        for name, p in module.named_parameters():
            g, g_j = p.grad.numpy(), sd_j[name].numpy()
            scale = max(float(np.abs(g_j).max()), 1e-12)
            assert np.abs(g - g_j).max() <= 1e-4 * scale, f"{top}.{name}"

    tx = step_j.make_optimizer(cfg_j)
    state_j = step_j.TrainState(jax.tree.map(jnp.asarray, params),
                                tx.init(jax.tree.map(jnp.asarray, params)), jnp.int32(0))
    for _ in range(3):
        state_j, _ = step_j.train_step(state_j, batch_j, statics_j, tx)
        step.train_step(state, batch, statics)
    assert state.step == int(state_j.step) == 3
    for module, sd_j in zip((state.point, state.ppf),
                            params_to_state_dicts(jax.tree.map(np.asarray, state_j.params))):
        for name, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), sd_j[name].numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)


def test_padding_rows_never_reach_the_loss():
    """Padded rows are masked out of the global max-pool and never paired:
    moving them changes neither the loss nor any gradient."""
    cfg_j, cfg = small_configs()
    _, batch_j = jax_batch(cfg_j, jax.random.PRNGKey(1))
    batch = torch_batch(batch_j)
    pad = torch.zeros(2, 64, 3)
    batch = batch._replace(pc=torch.cat([batch.pc, pad], 1),
                           normals=torch.cat([batch.normals, pad], 1))
    n = cfg.npoint_pad
    assert (batch.n_valid <= n).all()
    moved_pc, moved_n = batch.pc.clone(), batch.normals.clone()
    moved_pc[:, n:] = 5.0 + torch.rand(pad.shape, generator=torch.Generator().manual_seed(0))
    moved_n[:, n:] = 1.0
    statics = step.TrainStatics.from_config(cfg)
    grads = []
    for b in (batch, batch._replace(pc=moved_pc, normals=moved_n)):
        state = step.init_train_state(cfg, "cpu")
        loss, _ = step.loss_fn(state, b, statics)
        loss.backward()
        grads.append([p.grad.clone() for p in state.opt.param_groups[0]["params"]])
        grads[-1].append(loss.detach())
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("category", ["bowl", "mug", "laptop"])
def test_build_batch_matches_jax(category):
    """build_batch on BatchDraws.from_jax_key against JAX's build_batch on
    the same key and samples: pair indices and point counts equal; points,
    soft bins, angles and scale targets within 1e-5; normals, aux bits and their
    weights equal (1e-5) but where a normal itself differs, a share under
    1 % (ill-conditioned neighbourhoods, ROADMAP §C)."""
    cfg_j, cfg = small_configs(category)
    key = jax.random.PRNGKey(3)
    samples, batch_j = jax_batch(cfg_j, key)
    draws = loop.BatchDraws.from_jax_key(np.asarray(jax.random.key_data(key)), 2, cfg, "cpu")
    batch = loop.build_batch(cfg, draws, samples, cfg.npoint_pad, "cpu")
    np.testing.assert_array_equal(batch.n_valid.numpy(), np.asarray(batch_j.n_valid))
    np.testing.assert_array_equal(batch.point_idxs.numpy(), np.asarray(batch_j.point_idxs))
    for field in ("pc", "tr_prob", "scale_target", "up_rot_weight"):
        a, b = getattr(batch, field), getattr(batch_j, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5,
                                       err_msg=field)
    # the angle bins: the decoded angles (prob2real inverts the two-hot)
    # within 1e-5 rad, and the bins within 1e-5 but where the pair axis lies
    # within asin(0.15) of the axis, where arccos multiplies the points'
    # last-bit differences (the jitter's erfinv) by 1/sin θ > 6.7
    rot_j = np.asarray(batch_j.rot_prob)
    ang = binning.prob2real(batch.rot_prob, np.pi, cfg.rot_num_bins).numpy()
    ang_j = binning.prob2real(torch.from_numpy(rot_j), np.pi, cfg.rot_num_bins).numpy()
    np.testing.assert_allclose(ang, ang_j, rtol=0, atol=1e-5)
    conditioned = np.sin(ang_j) > 0.15
    np.testing.assert_allclose(batch.rot_prob.numpy()[conditioned], rot_j[conditioned], rtol=0,
                               atol=1e-5)
    print(f"{category}: angle targets within asin(0.15) of the axis: {1 - conditioned.mean():.5f}")
    nrm, nrm_j = batch.normals.numpy(), np.asarray(batch_j.normals)
    same_normal = np.abs(nrm - nrm_j).max(-1) < 1e-5           # [B, N]
    idxs = batch.point_idxs.numpy().astype(np.int64)
    same_pair = np.take_along_axis(same_normal, idxs[..., 0], 1)  # normal of a: the aux bits
    share = 1.0 - same_pair.mean()
    print(f"{category}: pairs whose first normal differs from JAX's: {share:.5f}")
    assert share < 0.01
    aux, aux_j = batch.aux.numpy(), np.asarray(batch_j.aux)
    w, w_j = batch.aux_weight.numpy(), np.asarray(batch_j.aux_weight)
    np.testing.assert_allclose(w[same_pair], w_j[same_pair], rtol=0, atol=1e-5)
    on_plane = np.abs(w_j[same_pair]) < 1e-6
    assert np.all((aux[same_pair] == aux_j[same_pair]) | on_plane)


def test_batch_draws_sample_shapes():
    _, cfg = small_configs()
    d = loop.BatchDraws.sample(torch.Generator().manual_seed(0), 2, cfg, "cpu")
    assert d.jitter.shape == (2, cfg.npoint_max, 3)
    assert d.pair_u.shape == (2, cfg.train_pairs, 2)
    assert d.keep_sign.shape == (2, cfg.npoint_pad, 1) and d.keep_sign.dtype == torch.bool
