"""The port's entry points (``cppf_tpu_torch/entry.py``) against
``__graft_entry__.py``: ``entry()`` on JAX's weights and draws, and
``dryrun_multichip(4)`` over 4 gloo CPU ranks (a (2, 2) mesh) against
JAX's ``train_step`` on a (2, 2) mesh of the CPU devices and the port's
one-device step, from JAX's init."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from cppf_tpu.parallel.mesh import make_mesh as make_mesh_j
from cppf_tpu.train import step as step_j
from cppf_tpu_torch import entry as entry_t
from cppf_tpu_torch.models.convert import params_to_state_dicts
from cppf_tpu_torch.train import step
from torch_slices import jax_draws

torch.set_num_threads(1)


def test_entry_matches_jax(monkeypatch):
    """entry() builds JAX's inputs (the cloud, preprocessed with JAX's
    jitter: the same count, points to 1e-6, 99.9 % of the normals to 1e-4:
    the rest are ROADMAP §C's ill-conditioned ones) and JAX's draws; on
    JAX's weights, cloud and draws it gives JAX's pose: every field's
    shape equal and finite, T the same voxel, up to 1e-6."""
    import cppf_tpu.utils.cache

    # the JAX entry would set a compilation cache outside the checkout
    monkeypatch.setattr(cppf_tpu.utils.cache, "enable_compilation_cache", lambda: None)
    fn_j, args_j = __graft_entry__.entry()
    out_j = fn_j(*args_j)
    _, p_point, p_ppf, pc_j, nrm_j, nv_j, _ = args_j
    fn, (draws, point, ppf, pc, normals, n_valid, sphere) = entry_t.entry("cpu")
    assert int(n_valid) == int(nv_j)
    np.testing.assert_allclose(pc.numpy(), np.asarray(pc_j), atol=1e-6)
    close = np.all(np.abs(normals.numpy() - np.asarray(nrm_j)) <= 1e-4, -1)
    assert close.mean() >= 0.999
    point_sd, ppf_sd = params_to_state_dicts(jax.tree.map(np.asarray,
                                                          {"point": p_point, "ppf": p_ppf}))
    point.load_state_dict(point_sd)
    ppf.load_state_dict(ppf_sd)
    pcfg = entry_t.entry_config()
    want = jax_draws(jax.random.PRNGKey(entry_t.ENTRY_POSE_KEY), pcfg)
    # entry's own draws are JAX's: uniforms to the bit, Gumbel noise to
    # float32 rounding (tests/test_torch_threefry.py); the pose runs on
    # jax.random's
    assert torch.equal(draws.pair_u, want.pair_u)
    np.testing.assert_allclose(draws.tr_gumbel.numpy(), want.tr_gumbel.numpy(), rtol=1e-6,
                               atol=1e-6)
    out = fn(want, point, ppf, torch.from_numpy(np.asarray(pc_j)),
             torch.from_numpy(np.asarray(nrm_j)), n_valid, sphere)
    for k, v in out._asdict().items():
        assert tuple(v.shape) == tuple(np.shape(getattr(out_j, k))), k
        assert bool(torch.isfinite(v.float()).all()), k
    np.testing.assert_allclose(out.T.numpy(), np.asarray(out_j.T), atol=1e-6)
    np.testing.assert_allclose(out.up.numpy(), np.asarray(out_j.up), atol=1e-6)


def test_entry_defaults_on_cpu():
    """entry('cpu') with its own seeded weights: a finite pose of the
    documented shapes; the weights are the same from call to call."""
    fn, args = entry_t.entry("cpu")
    out = fn(*args)
    assert tuple(out.T.shape) == (3,) and tuple(out.R.shape) == (3, 3)
    assert bool(torch.isfinite(out.RT).all())
    _, (_, point2, *_) = entry_t.entry("cpu")
    for a, b in zip(args[1].parameters(), point2.parameters()):
        assert torch.equal(a, b)


# XLA's compiled (2, 2) program of JAX's step differs from JAX run op by op
# (and from the port, which equals the latter to 2e-5) by up to 4.6e-4 of a
# point-encoder gradient's maximum on this random cloud: the fused
# program's float order (ROADMAP §C, "the train step's gradients")
MESH_GRAD_TOL = 5e-4


@pytest.fixture(scope="module")
def dryrun():
    """dryrun_multichip(4) on gloo CPU ranks from JAX's init, and the
    references: JAX's loss, gradients and weights after train_step on a
    (2, 2) mesh; JAX's loss and gradients run op by op on the whole batch;
    the port's one-device step on the whole batch."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from cppf_tpu.config import load_config as load_config_j
    from cppf_tpu.parallel.mesh import DATA_AXIS, PAIR_AXIS

    cfg_j = load_config_j("mug")
    cfg_j.knn = 8
    params = jax.tree.map(np.asarray, jax.jit(lambda k: step_j.init_train_state(
        k, cfg_j, entry_t.DRYRUN_POINTS).params)(jax.random.PRNGKey(0)))
    ranks = entry_t.dryrun_multichip(4, devices=["cpu"] * 4, params=params)

    cfg = entry_t.dryrun_config()
    batch = entry_t.dryrun_batch(cfg, 2, 2)
    mesh = make_mesh_j(4, shape=(2, 2))
    pair_fields = ("point_idxs", "tr_prob", "rot_prob", "aux", "aux_weight")
    batch_j = step_j.Batch(*(
        None if t is None else jax.device_put(jnp.asarray(t.numpy()), NamedSharding(
            mesh, P(DATA_AXIS, PAIR_AXIS) if name in pair_fields else P(DATA_AXIS)))
        for name, t in zip(batch._fields, batch)))
    statics_j = step_j.TrainStatics.from_config(cfg_j)
    tx = step_j.make_optimizer(cfg_j)
    params_r = jax.device_put(jax.tree.map(jnp.asarray, params), NamedSharding(mesh, P()))
    grad_fn = jax.value_and_grad(step_j.loss_fn, has_aux=True)
    with mesh:
        (loss_j, _), grads_j = jax.jit(grad_fn, static_argnums=2)(params_r, batch_j, statics_j)
        state_j, _ = step_j.train_step(step_j.TrainState(params_r, tx.init(params_r),
                                                         jnp.int32(0)), batch_j, statics_j, tx)
    with jax.disable_jit():
        (loss_e, _), grads_e = grad_fn(jax.tree.map(jnp.asarray, params), step_j.Batch(
            *(None if t is None else jnp.asarray(t.numpy()) for t in batch)), statics_j)
    single = step.init_train_state(cfg, "cpu", params=params)
    comps = step.train_step(single, batch, step.TrainStatics.from_config(cfg))
    names = [(sd, n) for sd, module in ((0, single.point), (1, single.ppf))
             for n, _ in module.named_parameters()]

    def flat(tree):
        sds = params_to_state_dicts(jax.tree.map(np.asarray, tree))
        return [sds[sd][n] for sd, n in names]

    ps = single.opt.param_groups[0]["params"]
    return ranks, dict(
        jax_mesh=dict(loss=float(loss_j), grads=flat(grads_j), weights=flat(state_j.params)),
        jax_eager=dict(loss=float(loss_e), grads=flat(grads_e), weights=None),
        port=dict(loss=float(comps["loss"]), grads=[p.grad.clone() for p in ps],
                  weights=[p.detach().clone() for p in ps]))


def test_dryrun_step_matches_jax_and_one_device(dryrun):
    """The dry run's step on its (2, 2) mesh (B = 2, 128 pairs a sample
    split over 2 pair ranks) against JAX's train_step on a (2, 2) mesh
    (loss 1e-5, weights 1e-6, gradients ``MESH_GRAD_TOL`` of each maximum),
    JAX's step run op by op (loss 1e-5, gradients 1e-4 of each maximum) and
    the port's one-device step on the whole batch (loss 1e-5, gradients
    1e-4, weights 1e-6); every rank holds the same weights."""
    ranks, refs = dryrun
    assert ranks[0]["mesh"] == (2, 2)
    for r in ranks[1:]:
        for a, b in zip(r["weights"], ranks[0]["weights"]):
            assert torch.equal(a, b)
    got = ranks[0]
    for ref, g_tol in ((refs["jax_mesh"], MESH_GRAD_TOL), (refs["jax_eager"], 1e-4),
                       (refs["port"], 1e-4)):
        np.testing.assert_allclose(float(got["comps"]["loss"]), ref["loss"], rtol=1e-5)
        for g, g_ref in zip(got["grads"], ref["grads"], strict=True):
            g_ref = torch.as_tensor(np.asarray(g_ref))
            assert float((g - g_ref).abs().max()) <= g_tol * max(float(g_ref.abs().max()), 1e-12)
        for w, w_ref in zip(got["weights"], ref["weights"] or (), strict=False):
            np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=0, atol=1e-6)


def test_dryrun_pose_is_the_one_device_pose(dryrun):
    """The dry run's pair-sharded pose (hier, 8 rotations, 32³, 2 rounds) is
    the same on every rank, finite, and equals the port's one-device pose of
    the stepped weights on the same draws (T the same voxel, up 1e-6,
    survivors equal)."""
    from cppf_tpu_torch.core import threefry
    from cppf_tpu_torch.models.convert import make_encoders
    from cppf_tpu_torch.pipeline.pose import PoseDraws, estimate_pose

    ranks, _ = dryrun
    for r in ranks[1:]:
        for k, v in r["pose"].items():
            assert torch.equal(v, ranks[0]["pose"][k]), k
    got = ranks[0]["pose"]
    assert bool(torch.isfinite(got["RT"]).all())
    cfg = entry_t.dryrun_config()
    pcfg = entry_t.dryrun_pose_config(cfg, 2)
    assert (pcfg.n_pairs, pcfg.rot_subsample, pcfg.num_rots, pcfg.grid_shape) == (
        128, 64, 8, (32, 32, 32))
    point, ppf = make_encoders(cfg.out_dim)
    n_point = len(list(point.parameters()))
    with torch.no_grad():
        for p, w in zip([*point.parameters(), *ppf.parameters()], ranks[0]["weights"]):
            p.copy_(w)
    assert n_point < len(ranks[0]["weights"])
    batch = entry_t.dryrun_batch(cfg, 2, 2)
    draws = PoseDraws.from_jax_keys(pcfg, threefry.key(0), threefry.key(entry_t.DRYRUN_POSE_KEY),
                                    "cpu", 1)
    single = estimate_pose(point.eval(), ppf.eval(), batch.pc[0], batch.normals[0],
                           torch.tensor(entry_t.DRYRUN_POINTS),
                           torch.from_numpy(pcfg.sphere_points()), pcfg, draws=draws)
    assert torch.equal(got["T"], single.T)
    np.testing.assert_allclose(got["up"].numpy(), single.up.numpy(), atol=1e-6)
    assert int(got["n_filtered"]) == int(single.n_filtered)


def test_entry_cli_parses():
    """``python -m cppf_tpu_torch.entry [multichip n]`` as __graft_entry__'s
    __main__, with --device and --backend; both entry points raise without
    a card unless told the CPU."""
    import cppf_tpu_torch.entry as e

    calls = []
    orig = e.dryrun_multichip
    e.dryrun_multichip = lambda n, backend=None, devices=None: calls.append((n, backend, devices))
    try:
        e.main(["multichip", "4", "--device", "cpu", "--backend", "gloo"])
    finally:
        e.dryrun_multichip = orig
    assert calls == [(4, "gloo", ["cpu"] * 4)]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    # the card by default, and no fallback to the CPU without it
    with pytest.raises(RuntimeError, match="CUDA"):
        e.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        e.dryrun_multichip(2)
