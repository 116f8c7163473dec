"""The port's parallel/ (pair-sharded vote, peak and pose; the data-parallel
train step) in spawned gloo groups of 2 and 4 CPU ranks against
cppf_tpu.parallel on the 8-virtual-device mesh, and against the port's own
one-device functions, at the pose slices' size (``torch_slices``: 512
points, knn 16, 2048 pairs, JAX's draws) and the training tests' width
(``torch_training``).

One group of each size runs everything its ranks are asked here
(``torch_parallel.parallel_checks``), while the parent compiles the JAX
sharded programs in threads.  JAX's sharded pose runs once a category, on
a (1, 2) mesh for bowl and table and a (1, 4) one for mug and laptop (its
mesh size moves only the order of its float sums): both port group sizes
are held to that run."""
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
from cppf_tpu.train import step as step_j
from cppf_tpu.train.checkpoints import load_params
from cppf_tpu_torch.models.convert import ASSETS, load_encoders, load_npz_params
from cppf_tpu_torch.ops.voting import _poolf, ppf_vote, ppf_vote_peak
from cppf_tpu_torch.parallel.launch import run_ranks
from cppf_tpu_torch.parallel.mesh import PairMesh, _factor, shard_rows
from cppf_tpu_torch.pipeline.pose import PoseConfig, estimate_pose
from cppf_tpu_torch.train import step
from torch_training import jax_batch, jax_params, small_configs, torch_batch

torch.set_num_threads(1)

SEED = 7
# category → (view, points, JAX mesh's pair ranks)
POSES = {"bowl": (0, 512, 2), "mug": (0, 512, 4), "table": (1, 2048, 2),
         "laptop": (0, 512, 4)}
SIZES = (2, 4)


def _vote_problem():
    """tests/test_parallel.py's pair-sharded vote: 64 points, 1024 pairs
    aimed at the cloud's mean, 1 cm voxels, 24³, 16 rotations."""
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
    return dict(pc=pc, preds_tr=np.stack([proj, odist], -1).astype(np.float32),
                probs=np.ones(n, np.float32), idxs=idxs, corner=corner, res=0.01,
                dims=((pc.max(0) - corner) / 0.01).astype(np.int32) + 1,
                grid_shape=(24, 24, 24), n_rots=16)


def _pose_job(category):
    view, n_points, _ = POSES[category]
    raw, _ = ts.view(category, view)
    pcfg_j, pcfg_t, cfg = ts.small_configs(category)
    pre = ts.preprocess(raw, cfg.res, n_points)
    key = jax.random.PRNGKey(SEED)
    return dict(category=category, out_dim=cfg.out_dim, pc=np.asarray(pre.pc),
                normals=np.asarray(pre.normals), n_valid=np.asarray(pre.n_valid),
                nbr_idx=np.asarray(pre.nbr_idx), sphere=pcfg_t.sphere_points(), pcfg=pcfg_t,
                draws=ts.jax_draws(key, pcfg_t)), (pcfg_j, pre, key)


def _jax_pose(category, pcfg_j, pre, key):
    params = load_params(os.path.join(ts.ROOT, "checkpoints", category), "params_best")
    w = POSES[category][2]
    out = sharded_estimate_pose_j(make_mesh_j(w, shape=(1, w)), key, params["point"],
                                  params["ppf"], pre.pc, pre.normals, pre.n_valid,
                                  jnp.asarray(pcfg_j.sphere_points()), pcfg_j,
                                  nbr_idx=pre.nbr_idx)
    return jax.tree.map(np.asarray, out._asdict())


def _port_pose(j):
    point, ppf = load_encoders(
        load_npz_params(os.path.join(ASSETS, f"{j['category']}_params_best.npz")),
        j["out_dim"], "cpu")
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
    return (dict(loss=float(loss_j), grads=flat(grads_j), weights=flat(state_j.params)),
            dict(loss=float(comps["loss"]), grads=[p.grad.clone() for p in ps],
                 weights=[p.detach().clone() for p in ps]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both gloo groups' results, JAX's and the port's one-device references."""
    tmp = tmp_path_factory.mktemp("parallel")
    vote = _vote_problem()
    jobs, jax_inputs = {}, {}
    for cat in POSES:
        jobs[cat], jax_inputs[cat] = _pose_job(cat)
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
                dict(vote=vote, poses=jobs, **(dict(train=train) if w == 2 else {})),
                str(tmp / str(w)), 240.0)
        train_refs = ex.submit(_train_references, cfg_j, cfg, params, batch_j, batch)
        jax_poses = {cat: ex.submit(_jax_pose, cat, *jax_inputs[cat]) for cat in POSES}
        port_poses = {cat: ex.submit(_port_pose, jobs[cat]) for cat in POSES}
        jax_train, port_train = train_refs.result()
        jax_poses = {cat: f.result() for cat, f in jax_poses.items()}
        port_poses = {cat: f.result() for cat, f in port_poses.items()}
        ranks = {w: g.result() for w, g in groups.items()}
    return dict(ranks=ranks, vote=vote,
                jax_poses=jax_poses, jax_grids=jax_grids, port_poses=port_poses,
                jax_train=jax_train, port_train=port_train, jobs=jobs)


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
@pytest.mark.parametrize("category", list(POSES))
def test_sharded_pose_matches_jax(runs, category, world_size):
    """The port's sharded pose on every rank equals JAX's sharded pose from
    the same key: T the same voxel, up/right/R to 1e-5, scale to rtol 1e-5,
    the back-vote survivors equal; and the port's one-device pose on the
    same draws: T, up, right and survivors to the bit, scale to rtol 1e-5.
    Every rank returns the same pose, and the pose's traffic is that of
    its collectives: the back-vote masks gathered (a byte a pair), the
    peak's projections and windows, the sphere counts and the BCE and
    scale sums reduced."""
    want = runs["jax_poses"][category]
    single = runs["port_poses"][category]
    ranks = [r["poses"][category] for r in runs["ranks"][world_size]]
    got = ranks[0]["result"]
    for r in ranks[1:]:
        for k, v in r["result"].items():
            assert torch.equal(v, got[k]), k
        assert r["traffic"] == ranks[0]["traffic"]
    for k in ("T", "up", "right", "R"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["scale"].numpy(), want["scale"], rtol=1e-5)
    assert int(got["n_filtered"]) == int(want["n_filtered"])
    for k in ("T", "up", "right", "n_filtered"):
        assert torch.equal(got[k], single[k]), k
    np.testing.assert_allclose(got["scale"].numpy(), single["scale"].numpy(), rtol=1e-5)
    np.testing.assert_allclose(float(got["grid_max"]), float(single["grid_max"]), rtol=1e-5)

    pcfg = runs["jobs"][category]["pcfg"]
    traffic = ranks[0]["traffic"]
    passes = 2 if pcfg.asym_center_refine else 1
    axes = 2 if pcfg.regress_right else 1
    k = pcfg.axis_topk
    g = pcfg.grid_shape[0]
    proj = 4 * 3 * g * -(-g // _poolf(g))
    counts = 4 * len(runs["jobs"][category]["sphere"])
    assert traffic["all_gather_calls"] == passes
    assert traffic["all_gather_bytes"] == passes * world_size * -(-pcfg.n_pairs // world_size)
    # per center pass 3 projections and 1-2 windows (peak_rounds 2); per
    # axis the counts and 2 BCE sums a candidate; the scale sums
    assert (passes * 4 + axes * (1 + 2 * k) + 1 <= traffic["all_reduce_calls"]
            <= passes * 5 + axes * (1 + 2 * k) + 1)
    assert (passes * (proj + 4 * 16 ** 3) + axes * (counts + 16 * k) + 16
            <= traffic["all_reduce_bytes"]
            <= passes * (proj + 2 * 4 * 16 ** 3) + axes * (counts + 16 * k) + 16)


def test_data_parallel_step_matches_jax_and_one_device(runs):
    """One step at W = 2 data ranks, a sample each, against JAX's train_step
    on the whole batch (loss 1e-5, gradients 1e-4 of each maximum, weights
    1e-5) and the port's one-device step (loss 1e-5, gradients 1e-4 of each
    maximum, weights 1e-6); both ranks hold the same weights."""
    ranks = [r["train"] for r in runs["ranks"][2]]
    for r in ranks[1:]:
        for a, b in zip(r["weights"], ranks[0]["weights"]):
            assert torch.equal(a, b)
        assert all(torch.equal(r["comps"][k], ranks[0]["comps"][k]) for k in r["comps"])
    got = ranks[0]
    for ref, w_tol in ((runs["jax_train"], 1e-5), (runs["port_train"], 1e-6)):
        np.testing.assert_allclose(float(got["comps"]["loss"]), ref["loss"], rtol=1e-5)
        for g, g_ref in zip(got["grads"], ref["grads"], strict=True):
            g_ref = torch.as_tensor(np.asarray(g_ref))
            assert g.shape == g_ref.shape
            assert float((g - g_ref).abs().max()) <= 1e-4 * max(float(g_ref.abs().max()), 1e-12)
        for w, w_ref in zip(got["weights"], ref["weights"], strict=True):
            np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=0, atol=w_tol)


def test_ranks_start_from_the_same_weights(runs):
    """The flax-style init is drawn from cfg.seed: equal on every rank."""
    ranks = [r["train"]["init"] for r in runs["ranks"][2]]
    assert len(ranks[0]) > 0
    for a, b in zip(ranks[0], ranks[1], strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("world_size", SIZES)
def test_unported_and_misplaced_raise(runs, world_size):
    """A half-space gate, pair-axis training and a tensor on another device
    than the group's raise in the ranks."""
    assert runs["ranks"][world_size][0]["raised"] == {
        "halfspace": "NotImplementedError", "pair_axis_training": "NotImplementedError",
        "other_device": "ValueError"}


@pytest.mark.parametrize("flag", ["subvoxel_refine", "sharp_axis_votes", "coplanar_halfspace"])
def test_unported_pose_flags_raise(flag):
    _, cfg = ts.runner_configs("bowl")
    setattr(cfg, flag, True)
    with pytest.raises(NotImplementedError, match=flag):
        PoseConfig.from_config(cfg)
    with pytest.raises(TypeError):
        PoseConfig(center_mode="grid")


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
