"""The port's parallel/ (pair-sharded vote, peak and pose; the data-parallel
train step) in spawned gloo groups of 2 and 4 CPU ranks against
cppf_tpu.parallel on the 8-virtual-device mesh, and against the port's own
one-device functions, at the pose slices' size (``torch_slices``: 512
points, knn 16, 2048 pairs, JAX's draws) and the training tests' width
(``torch_training``).

One group of each size runs everything its ranks are asked here
(``torch_parallel.parallel_checks``), while the parent compiles the JAX
sharded programs in threads.  JAX's sharded pose runs once a job, on a
(1, 2) or a (1, 4) mesh (its mesh size moves only the order of its float
sums): both port group sizes are held to that run.  The jobs are four
categories on their committed views, bowl with each of three pose flags,
and tests/test_parallel.py:52-110's flag sets (grid and hier center modes)
on its synthetic mug with JAX's random init.  The train step runs on a
(2, 1) and a (1, 2) mesh of the 2-rank group and a (1, 4) and a (2, 2) one
of the 4-rank group."""
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel
import torch_slices as ts
from cppf_tpu.parallel import input_pipeline as input_pipeline_j
from cppf_tpu.parallel.mesh import _factor as _factor_j
from cppf_tpu.parallel.mesh import make_mesh as make_mesh_j
from cppf_tpu.parallel.mesh import sharded_ppf_vote as sharded_ppf_vote_j
from cppf_tpu.parallel.pose import sharded_estimate_pose as sharded_estimate_pose_j
from cppf_tpu.pipeline.pose import PoseConfig as PoseConfigJ
from cppf_tpu.train import step as step_j
from cppf_tpu.train.checkpoints import load_params
from cppf_tpu_torch.ops.voting import _poolf, ppf_vote, ppf_vote_peak
from cppf_tpu_torch.parallel.launch import run_ranks
from cppf_tpu_torch.parallel.mesh import PairMesh, _factor, shard_rows
from cppf_tpu_torch.pipeline.pose import PoseConfig, estimate_pose
from cppf_tpu_torch.train import step
from torch_training import jax_batch, jax_params, small_configs, torch_batch

torch.set_num_threads(1)

SEED = 7
# job → (category, view, points, JAX mesh's pair ranks, flags); view None is
# tests/test_parallel.py:52-110's synthetic mug with JAX's random init
POSE_FLAGS = ("subvoxel_refine", "sharp_axis_votes", "coplanar_halfspace")
FLAG_SETS = {
    center_mode: dict(rot_subsample=512, num_rots=16, knn=16, center_mode=center_mode,
                      grid_shape=(48, 48, 48), subvoxel_refine=True,
                      filter_coplanar=center_mode == "grid",
                      coplanar_halfspace=center_mode == "hier", axis_topk=3, up_prior_deg=60.0,
                      geo_right_sign=True, geo_right_dir="direct", sharp_axis_votes=True)
    for center_mode in ("grid", "hier")}
POSES = {"bowl": ("bowl", 0, 512, 2, {}), "mug": ("mug", 0, 512, 4, {}),
         "table": ("table", 1, 2048, 2, {}), "laptop": ("laptop", 0, 512, 4, {}),
         **{f"bowl_{f}": ("bowl", 0, 512, 2, {f: True}) for f in POSE_FLAGS},
         **{f"mug_{m}": ("mug", None, 1024, 4, FLAG_SETS[m]) for m in FLAG_SETS}}
SIZES = (2, 4)
MESHES = {2: ((2, 1), (1, 2)), 4: ((1, 4), (2, 2))}


def _vote_problem():
    """tests/test_parallel.py's pair-sharded vote: 64 points, 1024 pairs
    aimed at the cloud's mean, 1 cm voxels, 24³, 16 rotations; and a
    half-space gate of random directions on half the pairs, 1 cm margin."""
    rng = np.random.default_rng(0)
    n, p = 64, 1024
    pc = (rng.uniform(size=(n, 3)) * 0.2).astype(np.float32)
    idxs = rng.integers(0, n, size=(p, 2)).astype(np.int32)
    a, b = pc[idxs[:, 0]], pc[idxs[:, 1]]
    u = (a - b) / (np.linalg.norm(a - b, axis=-1, keepdims=True) + 1e-7)
    center = pc.mean(0)
    proj = np.sum((a - center) * u, -1)
    odist = np.linalg.norm(a - center - proj[:, None] * u, axis=-1)
    corner = pc.min(0)
    n_out = rng.normal(size=(p, 3)).astype(np.float32)
    n_out /= np.linalg.norm(n_out, axis=-1, keepdims=True)
    return dict(pc=pc, preds_tr=np.stack([proj, odist], -1).astype(np.float32),
                probs=np.ones(n, np.float32), idxs=idxs, corner=corner, res=0.01,
                dims=((pc.max(0) - corner) / 0.01).astype(np.int32) + 1,
                grid_shape=(24, 24, 24), n_rots=16,
                halfspace=(a, n_out, rng.uniform(size=p) < 0.5, 0.01))


def _synthetic_mug(flags):
    """tests/test_parallel.py:52-110's instance: 1500 samples of the mug
    primitive, 1024 points at knn 16, JAX's random init from keys 1 and 2,
    mug's PoseConfig at 2048 pairs with ``flags``.  Returns (pre, params,
    JAX PoseConfig, port PoseConfig, out_dim)."""
    from cppf_tpu.data.synthetic import PRIMITIVES, sample_surface
    from cppf_tpu.pipeline.pose import make_models
    from cppf_tpu.pipeline.preprocess import preprocess_cloud as preprocess_j

    cfg_j = ts.load_config_j("mug")
    pc_cam = sample_surface(PRIMITIVES["mug"](), 1500, np.random.default_rng(0)) \
        .astype(np.float32) + np.float32([0.05, -0.02, 0.6])
    pad = np.zeros((2048, 3), np.float32)
    pad[:1500] = pc_cam
    pre = preprocess_j(jax.random.PRNGKey(0), jnp.asarray(pad), 1500, cfg_j.res,
                       npoint_pad=1024, knn=16)
    point_enc, ppf_enc = make_models(cfg_j)
    p_pt = point_enc.init(jax.random.PRNGKey(1), pre.pc, pre.normals, pre.nbr_idx)
    feat = point_enc.apply(p_pt, pre.pc, pre.normals, pre.nbr_idx)
    p_pf = ppf_enc.init(jax.random.PRNGKey(2), pre.pc, pre.normals, feat,
                        jnp.zeros((8, 2), jnp.int32))
    params = jax.tree.map(np.asarray, {"point": p_pt, "ppf": p_pf})
    pcfg_j = dataclasses.replace(PoseConfigJ.from_config(cfg_j, n_pairs=2048), **flags)
    pcfg_t = dataclasses.replace(PoseConfig.from_config(ts.load_config("mug"), n_pairs=2048),
                                 **flags)
    return pre, params, pcfg_j, pcfg_t, cfg_j.out_dim


def _pose_job(name):
    category, view, n_points, _, flags = POSES[name]
    params = None
    if view is None:
        pre, params, pcfg_j, pcfg_t, out_dim = _synthetic_mug(flags)
    else:
        raw, _ = ts.view(category, view)
        pcfg_j, pcfg_t, cfg = ts.small_configs(category)
        pcfg_j = dataclasses.replace(pcfg_j, **flags)
        pcfg_t = dataclasses.replace(pcfg_t, **flags)
        pre = ts.preprocess(raw, cfg.res, n_points)
        out_dim = cfg.out_dim
    key = jax.random.PRNGKey(SEED)
    return dict(category=category, out_dim=out_dim, pc=np.asarray(pre.pc), params=params,
                normals=np.asarray(pre.normals), n_valid=np.asarray(pre.n_valid),
                nbr_idx=np.asarray(pre.nbr_idx), sphere=pcfg_t.sphere_points(), pcfg=pcfg_t,
                draws=ts.jax_draws(key, pcfg_t)), (pcfg_j, pre, key, params)


def _jax_pose(name, pcfg_j, pre, key, params):
    if params is None:
        params = load_params(os.path.join(ts.ROOT, "checkpoints", POSES[name][0]),
                             "params_best")
    w = POSES[name][3]
    out = sharded_estimate_pose_j(make_mesh_j(w, shape=(1, w)), key, params["point"],
                                  params["ppf"], pre.pc, pre.normals, pre.n_valid,
                                  jnp.asarray(pcfg_j.sphere_points()), pcfg_j,
                                  nbr_idx=pre.nbr_idx)
    return jax.tree.map(np.asarray, out._asdict())


def _port_pose(j):
    point, ppf = torch_parallel.encoders(j)
    return estimate_pose(point, ppf, ts.t(j["pc"]), ts.t(j["normals"]), ts.t(j["n_valid"]),
                         ts.t(j["sphere"]), j["pcfg"], nbr_idx=ts.t(j["nbr_idx"]),
                         draws=j["draws"])._asdict()


def _train_references(cfg_j, cfg, params, batch_j, batch):
    """(JAX: loss, gradients, weights after one step; the port's one-device
    step: the same), the gradients in the port's parameter order."""
    from cppf_tpu_torch.models.convert import params_to_state_dicts

    statics_j = step_j.TrainStatics.from_config(cfg_j)
    # JAX op by op for the loss and gradients, as tests/test_torch_train.py
    (loss_j, _), grads_j = jax.value_and_grad(step_j.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params), batch_j, statics_j)
    tx = step_j.make_optimizer(cfg_j)
    state_j = step_j.TrainState(jax.tree.map(jnp.asarray, params),
                                tx.init(jax.tree.map(jnp.asarray, params)), jnp.int32(0))
    state_j, _ = step_j.train_step(state_j, batch_j, statics_j, tx)

    single = step.init_train_state(cfg, "cpu", params=params)
    names = [(sd, n) for sd, module in ((0, single.point), (1, single.ppf))
             for n, _ in module.named_parameters()]

    def flat(tree):
        sds = params_to_state_dicts(jax.tree.map(np.asarray, tree))
        return [sds[sd][n] for sd, n in names]

    comps = step.train_step(single, batch, step.TrainStatics.from_config(cfg))
    ps = single.opt.param_groups[0]["params"]
    mesh_loss, mesh_grads, mesh_weights = _jax_mesh_step(cfg_j, params, batch_j, (2, 2))
    return (dict(loss=float(loss_j), grads=flat(grads_j), weights=flat(state_j.params)),
            dict(loss=float(comps["loss"]), grads=[p.grad.clone() for p in ps],
                 weights=[p.detach().clone() for p in ps]),
            dict(loss=mesh_loss, grads=flat(mesh_grads), weights=flat(mesh_weights)))


def _jax_mesh_step(cfg_j, params, batch_j, shape):
    """JAX's loss, gradients and train_step on a ``shape`` mesh of the CPU
    devices, the batch sharded as __graft_entry__.py shards it (samples over
    data, pairs over pair)."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from cppf_tpu.parallel.mesh import DATA_AXIS, PAIR_AXIS

    mesh = make_mesh_j(shape[0] * shape[1], shape=shape)
    pair_fields = ("point_idxs", "tr_prob", "rot_prob", "aux", "aux_weight", "up_rot_weight")
    batch_s = type(batch_j)(*(
        None if a is None else jax.device_put(a, NamedSharding(
            mesh, P(DATA_AXIS, PAIR_AXIS) if name in pair_fields else P(DATA_AXIS)))
        for name, a in zip(batch_j._fields, batch_j)))
    statics_j = step_j.TrainStatics.from_config(cfg_j)
    tx = step_j.make_optimizer(cfg_j)
    params_r = jax.device_put(jax.tree.map(jnp.asarray, params), NamedSharding(mesh, P()))
    state_j = step_j.TrainState(params_r, tx.init(params_r), jnp.int32(0))
    with mesh:
        (loss, _), grads = jax.jit(jax.value_and_grad(step_j.loss_fn, has_aux=True),
                                   static_argnums=2)(params_r, batch_s, statics_j)
        state_j, _ = step_j.train_step(state_j, batch_s, statics_j, tx)
    return float(loss), grads, state_j.params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both gloo groups' results, JAX's and the port's one-device references."""
    tmp = tmp_path_factory.mktemp("parallel")
    vote = _vote_problem()
    jobs, jax_inputs = {}, {}
    for name in POSES:
        jobs[name], jax_inputs[name] = _pose_job(name)
    cfg_j, cfg = small_configs()
    params = jax_params(cfg_j)
    _, batch_j = jax_batch(cfg_j, jax.random.PRNGKey(1))
    batch = torch_batch(batch_j)
    train = dict(cfg=cfg, batch=batch, params=params)
    args = [jnp.asarray(vote[k]) for k in ("pc", "preds_tr", "probs", "idxs", "corner")]
    jax_grids = {w: np.asarray(sharded_ppf_vote_j(
                     make_mesh_j(w, shape=(1, w)), *args, vote["res"],
                     jnp.asarray(vote["dims"]), vote["grid_shape"], n_rots=vote["n_rots"]))
                 for w in SIZES}
    # the ranks run, JAX compiles and torch computes outside the interpreter lock
    with ThreadPoolExecutor(2 * len(POSES) + 1 + len(SIZES)) as ex:
        groups = {}
        for w in SIZES:
            os.makedirs(tmp / str(w))
            groups[w] = ex.submit(
                run_ranks, torch_parallel.parallel_checks, "gloo", ["cpu"] * w,
                dict(vote=vote, poses=jobs, train=train, meshes=MESHES[w]),
                str(tmp / str(w)), 600.0)
        train_refs = ex.submit(_train_references, cfg_j, cfg, params, batch_j, batch)
        jax_poses = {n: ex.submit(_jax_pose, n, *jax_inputs[n]) for n in POSES}
        port_poses = {n: ex.submit(_port_pose, jobs[n]) for n in POSES}
        jax_train, port_train, jax_mesh_train = train_refs.result()
        jax_poses = {n: f.result() for n, f in jax_poses.items()}
        port_poses = {n: f.result() for n, f in port_poses.items()}
        ranks = {w: g.result() for w, g in groups.items()}
    return dict(ranks=ranks, vote=vote,
                jax_poses=jax_poses, jax_grids=jax_grids, port_poses=port_poses,
                jax_train=jax_train, port_train=port_train, jax_mesh_train=jax_mesh_train,
                jobs=jobs)


def _vote_args(vote):
    return (ts.t(vote["pc"]), ts.t(vote["preds_tr"]), ts.t(vote["probs"]), ts.t(vote["idxs"]),
            ts.t(vote["corner"]), vote["res"], ts.t(vote["dims"]), vote["grid_shape"])


@pytest.mark.parametrize("world_size", SIZES)
def test_sharded_vote_matches_jax(runs, world_size):
    """sharded_ppf_vote equals JAX's on a (1, W) mesh to 1e-3 (the JAX
    test's tolerance), and the one-device ppf_vote to 1e-5 of its maximum
    (float order)."""
    single = ppf_vote(*_vote_args(runs["vote"]), n_rots=runs["vote"]["n_rots"]).numpy()
    for r in runs["ranks"][world_size]:
        grid = r["vote"]["grid"].numpy()
        np.testing.assert_allclose(grid, runs["jax_grids"][world_size], atol=1e-3)
        np.testing.assert_allclose(grid, single, atol=1e-5 * single.max())


@pytest.mark.parametrize("world_size", SIZES)
def test_sharded_peak_is_a_grid_maximum(runs, world_size):
    """The sharded peak is the one-device peak's voxel or a maximum of the
    one-device grid (to float order), its value that maximum, the same on
    every rank by either entry."""
    args = _vote_args(runs["vote"])
    n_rots = runs["vote"]["n_rots"]
    grid = ppf_vote(*args, n_rots=n_rots)
    idx1, peak1 = ppf_vote_peak(*args, n_rots=n_rots)
    ranks = runs["ranks"][world_size]
    idx, peak = ranks[0]["vote"]["peak"]
    for r in ranks:
        for got in (r["vote"]["peak"], r["vote"]["peak_api"]):
            assert torch.equal(got[0], idx) and torch.equal(got[1], peak)
    top = float(grid.max())
    assert torch.equal(idx, idx1) or float(grid[tuple(idx.long())]) >= top * (1 - 1e-5)
    np.testing.assert_allclose(float(peak), float(peak1), rtol=1e-5)
    np.testing.assert_allclose(float(peak), top, rtol=1e-5)


@pytest.mark.parametrize("world_size", SIZES)
def test_reduced_sums_equal_on_every_rank(runs, world_size):
    """Every rank holds the same bits after each reduce of the peak (the
    three projections, then each window), so all run one refine loop."""
    ranks = runs["ranks"][world_size]
    first = ranks[0]["vote"]["reduced"]
    assert len(first) >= 4
    for r in ranks[1:]:
        assert len(r["vote"]["reduced"]) == len(first)
        for a, b in zip(r["vote"]["reduced"], first):
            assert torch.equal(a, b)


def test_reduce_fn_none_is_bit_equal():
    """Without reduce_fn, and with an identity one, the peak is the same to
    the bit; the hook sees the three projections and then every window."""
    args = _vote_args(_vote_problem())
    seen = []

    def identity(t):
        seen.append(tuple(t.shape))
        return t

    for max_rounds in (0, 1):
        plain = ppf_vote_peak(*args, n_rots=16, max_rounds=max_rounds)
        none = ppf_vote_peak(*args, n_rots=16, max_rounds=max_rounds, reduce_fn=None)
        seen.clear()
        hooked = ppf_vote_peak(*args, n_rots=16, max_rounds=max_rounds, reduce_fn=identity)
        for a, b, c in zip(plain, none, hooked):
            assert torch.equal(a, b) and torch.equal(a, c)
        assert seen[:3] == [(24, 24), (24, 24), (24, 24)]
        assert all(s == (16, 256) for s in seen[3:]) and len(seen) > 3
        assert max_rounds == 0 or len(seen) == 4


@pytest.mark.parametrize("world_size", SIZES)
@pytest.mark.parametrize("job", list(POSES))
def test_sharded_pose_matches_jax(runs, job, world_size):
    """The port's sharded pose on every rank equals JAX's sharded pose from
    the same key: T the same voxel (with ``subvoxel_refine`` to 1e-5, JAX's
    own sharded-against-single tolerance), up/right/R to 1e-5, scale to rtol
    1e-5, the back-vote survivors equal; and the port's one-device pose on
    the same draws: up, right and survivors to the bit, T to the bit (with
    ``subvoxel_refine`` to ``SUBVOXEL_T_TOL``: its normal equations are
    summed over the ranks), scale to rtol 1e-5.  Every rank returns the same pose, and the
    pose's traffic is that of its collectives: the back-vote masks gathered
    (a byte a pair); the peak's projections and windows (``center_mode``
    hier) or the dense grid (grid); the Gauss-Newton terms (13 float64s
    a step, 3 steps a center pass, with ``subvoxel_refine``); the sphere
    counts and the BCE and scale sums reduced."""
    want = runs["jax_poses"][job]
    single = runs["port_poses"][job]
    ranks = [r["poses"][job] for r in runs["ranks"][world_size]]
    pcfg = runs["jobs"][job]["pcfg"]
    got = ranks[0]["result"]
    for r in ranks[1:]:
        for k, v in r["result"].items():
            assert torch.equal(v, got[k]), k
        assert r["traffic"] == ranks[0]["traffic"]
    np.testing.assert_allclose(got["T"].numpy(), want["T"],
                               atol=1e-5 if pcfg.subvoxel_refine else 1e-6)
    for k in ("up", "right", "R"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["scale"].numpy(), want["scale"], rtol=1e-5)
    assert int(got["n_filtered"]) == int(want["n_filtered"])
    for k in ("up", "right", "n_filtered"):
        assert torch.equal(got[k], single[k]), k
    if pcfg.subvoxel_refine:
        np.testing.assert_allclose(got["T"].numpy(), single["T"].numpy(), atol=ts.SUBVOXEL_T_TOL)
    else:
        assert torch.equal(got["T"], single["T"])
    np.testing.assert_allclose(got["scale"].numpy(), single["scale"].numpy(), rtol=1e-5)
    np.testing.assert_allclose(float(got["grid_max"]), float(single["grid_max"]), rtol=1e-5)

    traffic = ranks[0]["traffic"]
    passes = 2 if pcfg.asym_center_refine else 1
    axes = 2 if pcfg.regress_right else 1
    k = pcfg.axis_topk
    g = pcfg.grid_shape[0]
    gn = 3 * passes if pcfg.subvoxel_refine else 0
    fixed_calls = gn + axes * (1 + 2 * k) + 1
    fixed_bytes = gn * 13 * 8 + axes * (4 * len(runs["jobs"][job]["sphere"]) + 16 * k) + 16
    assert traffic["all_gather_calls"] == passes
    assert traffic["all_gather_bytes"] == passes * world_size * -(-pcfg.n_pairs // world_size)
    if pcfg.center_mode == "grid":
        assert traffic["all_reduce_calls"] == passes + fixed_calls
        assert traffic["all_reduce_bytes"] == passes * 4 * g ** 3 + fixed_bytes
        return
    # per center pass 3 projections and 1-2 windows (peak_rounds 2)
    proj = 4 * 3 * g * -(-g // _poolf(g))
    assert passes * 4 + fixed_calls <= traffic["all_reduce_calls"] <= passes * 5 + fixed_calls
    assert (passes * (proj + 4 * 16 ** 3) + fixed_bytes <= traffic["all_reduce_bytes"]
            <= passes * (proj + 2 * 4 * 16 ** 3) + fixed_bytes)


def _assert_step(got, ref, w_tol):
    """A rank's step against a reference: loss 1e-5, gradients 1e-4 of each
    tensor's maximum, weights ``w_tol``."""
    np.testing.assert_allclose(float(got["comps"]["loss"]), ref["loss"], rtol=1e-5)
    for g, g_ref in zip(got["grads"], ref["grads"], strict=True):
        g_ref = torch.as_tensor(np.asarray(g_ref))
        assert g.shape == g_ref.shape
        assert float((g - g_ref).abs().max()) <= 1e-4 * max(float(g_ref.abs().max()), 1e-12)
    for w, w_ref in zip(got["weights"], ref["weights"], strict=True):
        np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=0, atol=w_tol)


def _same_on_every_rank(ranks):
    for r in ranks[1:]:
        for a, b in zip(r["weights"], ranks[0]["weights"]):
            assert torch.equal(a, b)
        assert all(torch.equal(r["comps"][k], ranks[0]["comps"][k]) for k in r["comps"])


def test_data_parallel_step_matches_jax_and_one_device(runs):
    """One step at W = 2 data ranks, a sample each, against JAX's train_step
    on the whole batch (loss 1e-5, gradients 1e-4 of each maximum, weights
    1e-5) and the port's one-device step (loss 1e-5, gradients 1e-4 of each
    maximum, weights 1e-6); both ranks hold the same weights."""
    ranks = [r["train"][(2, 1)] for r in runs["ranks"][2]]
    _same_on_every_rank(ranks)
    for ref, w_tol in ((runs["jax_train"], 1e-5), (runs["port_train"], 1e-6)):
        _assert_step(ranks[0], ref, w_tol)
    assert ranks[0]["traffic"]["all_reduce_calls"] == 2


def test_ranks_start_from_the_same_weights(runs):
    """The flax-style init is drawn from cfg.seed: equal on every rank."""
    ranks = [r["train"][(2, 1)]["init"] for r in runs["ranks"][2]]
    assert len(ranks[0]) > 0
    for a, b in zip(ranks[0], ranks[1], strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("world_size", SIZES)
def test_sharded_halfspace_and_pair_training(runs, world_size):
    """The half-space gate over the ranks: the sharded grid equals the
    one-device gated grid to 1e-5 of its maximum, and the sharded peak is
    its maximum (to rtol 1e-5), the same on every rank; a step with the
    pairs split over W pair ranks, a (1, W) mesh, equals the port's
    one-device step (loss 1e-5, gradients 1e-4 of each maximum, weights
    1e-6) and JAX's op by op (weights 1e-5), the same weights on every
    rank, its traffic the pair denominators, the gradients and the
    components summed over the pair group and again over the data group;
    and a tensor on another device than the group's raises ValueError."""
    vote = runs["vote"]
    a, n_out, gate, margin = vote["halfspace"]
    hs = (ts.t(a), ts.t(n_out), ts.t(gate), torch.tensor(margin))
    args = _vote_args(vote)
    grid = ppf_vote(*args, n_rots=vote["n_rots"], halfspace=hs)
    ungated = ppf_vote(*args, n_rots=vote["n_rots"])
    assert float((grid - ungated).abs().max()) > 1e-3 * float(ungated.max())
    ranks = runs["ranks"][world_size]
    idx, peak = ranks[0]["gated"]["peak"]
    for r in ranks:
        np.testing.assert_allclose(r["gated"]["grid"].numpy(), grid.numpy(),
                                   atol=1e-5 * float(grid.max()))
        assert torch.equal(r["gated"]["peak"][0], idx)
        assert torch.equal(r["gated"]["peak"][1], peak)
    np.testing.assert_allclose(float(peak), float(grid.max()), rtol=1e-5)
    assert float(grid[tuple(idx.long())]) >= float(grid.max()) * (1 - 1e-5)

    steps = [r["train"][(1, world_size)] for r in ranks]
    _same_on_every_rank(steps)
    _assert_step(steps[0], runs["port_train"], 1e-6)
    _assert_step(steps[0], runs["jax_train"], 1e-5)
    assert steps[0]["traffic"]["all_reduce_calls"] == 5
    assert runs["ranks"][world_size][0]["raised"] == {"other_device": "ValueError"}


def test_pair_and_data_sharded_step_matches_jax_mesh(runs):
    """One step on a (2, 2) mesh (a sample a data rank, its pairs over two
    pair ranks) against JAX's train_step on a (2, 2) mesh of the CPU
    devices with the batch sharded as __graft_entry__.py shards it, and
    against the port's one-device step: loss 1e-5, gradients 1e-4 of each
    maximum, weights 1e-6; every rank holds the same weights."""
    steps = [r["train"][(2, 2)] for r in runs["ranks"][4]]
    _same_on_every_rank(steps)
    _assert_step(steps[0], runs["jax_mesh_train"], 1e-6)
    _assert_step(steps[0], runs["port_train"], 1e-6)


@pytest.mark.parametrize("flag", POSE_FLAGS)
def test_pose_flag_parity(flag):
    """The flags that raised before they were ported: PoseConfig.from_config
    takes each as JAX's does (every field equal), and a grid center mode is
    a PoseConfig of its own; the sharded pose with the flag is held by
    ``test_sharded_pose_matches_jax[bowl_<flag>-*]``."""
    cfg_j, cfg = ts.runner_configs("bowl")
    setattr(cfg, flag, True)
    setattr(cfg_j, flag, True)
    pj, pt = PoseConfigJ.from_config(cfg_j), PoseConfig.from_config(cfg)
    assert getattr(pt, flag) is True
    for f in dataclasses.fields(pt):
        assert getattr(pt, f.name) == getattr(pj, f.name), f.name
    assert PoseConfig(center_mode="grid").center_mode == "grid"


@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_factoring_and_rows(n):
    """_factor splits n ranks as JAX's; each rank's rows of a P-pair array
    are the rows of its shard of JAX's padded pair axis."""
    assert _factor(n) == _factor_j(n)
    p = 2048 + n
    pad = (-p) % n
    c = (p + pad) // n
    for k in range(n):
        mesh = PairMesh(k, (1, n), (0, k), torch.device("cpu"), None, None)
        rows = shard_rows(p, mesh)
        assert rows == slice(min(k * c, p), min((k + 1) * c, p))
    assert sum(len(range(p)[shard_rows(p, PairMesh(k, (1, n), (0, k), torch.device("cpu"),
                                                    None, None))]) for k in range(n)) == p


def test_shard_dataset_in_two_processes(tmp_path):
    """shard_dataset with the process index and count from a real two-rank
    gloo group gives the model lists and draws of JAX's two-process run
    (tests/test_multihost.py's workers, here with the index and count
    passed)."""
    ranks = run_ranks(torch_parallel.shard_dataset_draws, "gloo", ["cpu"] * 2, None,
                      str(tmp_path), 120.0)
    for pi, got in enumerate(ranks):
        want = input_pipeline_j.shard_dataset(torch_parallel._Models(), seed=7,
                                              process_index=pi, process_count=2)
        assert got["names"] == want.model_names
        assert got["draws"] == want.rng.integers(0, 1_000_000, size=4).tolist()
        assert got["hosts"] == list(range(5))[pi::2]
        assert got["global_batch"] == 6
    assert not set(ranks[0]["names"]) & set(ranks[1]["names"])
    assert ranks[0]["draws"] != ranks[1]["draws"]
