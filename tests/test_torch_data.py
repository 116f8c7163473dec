"""The port's host data layer (data/synthetic.py, compose.py, native.py,
mesh.py, shapenet.py) against the JAX package's on the same seeds: the
meshes, the native raster, the rendered stream."""
import os

import numpy as np
import pytest
import torch

from cppf_tpu.config import load_config as load_config_j
from cppf_tpu.data import native as native_j
from cppf_tpu.data import shapenet as shapenet_j
from cppf_tpu.data import synthetic as synthetic_j
from cppf_tpu_torch.config import load_config
from cppf_tpu_torch.data import mesh, native, shapenet, synthetic
from cppf_tpu_torch.data.compose import COMPOSITIONAL

torch.set_num_threads(1)

CATEGORIES = ("bottle", "bowl", "camera", "can", "laptop", "mug",
              "bathtub", "bed", "bookshelf", "chair", "sofa", "table")


def _posed(category, seed):
    """A primitive of ``category`` normalised and placed ~1 m in front of
    the raster camera."""
    m = synthetic.random_primitive(category, np.random.default_rng(seed))
    v = m.vertices / np.linalg.norm(m.vertices.max(0) - m.vertices.min(0)) * 0.3
    return (v - v.mean(0) + np.float32([0.02, -0.03, -0.9])).astype(np.float32), m.faces


@pytest.mark.parametrize("category", CATEGORIES)
def test_random_primitive_equal(category):
    assert set(COMPOSITIONAL) == set(CATEGORIES)
    for seed in (0, 3):
        a = synthetic.random_primitive(category, np.random.default_rng(seed))
        b = synthetic_j.random_primitive(category, np.random.default_rng(seed))
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.faces, b.faces)
        assert a.vertices.dtype == b.vertices.dtype and a.faces.dtype == b.faces.dtype


def test_observation_pose_and_oracles_equal():
    for is_nocs in (True, False):
        a = synthetic.observation_pose(np.random.default_rng(2), is_nocs=is_nocs)
        b = synthetic_j.observation_pose(np.random.default_rng(2), is_nocs=is_nocs)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    m = synthetic.random_primitive("mug", np.random.default_rng(1))
    s_a = synthetic.sample_surface(m, 300, np.random.default_rng(4))
    s_b = synthetic_j.sample_surface(m, 300, np.random.default_rng(4))
    np.testing.assert_array_equal(s_a, s_b)
    assert synthetic.mesh_sign_cue(m.vertices, m.faces, 1, 1.0) == \
        synthetic_j.mesh_sign_cue(m.vertices, m.faces, 1, 1.0)
    rng = np.random.default_rng(5)
    nrm = rng.normal(size=(300, 3))
    idxs = rng.integers(0, 300, size=(500, 2))
    R, T = synthetic.random_pose(np.random.default_rng(6))
    bound = np.array([0.9, 0.6, 0.8])
    cfg, cfg_j = load_config("mug"), load_config_j("mug")
    np.testing.assert_array_equal(
        synthetic.oracle_pair_predictions(s_a, nrm, idxs, T, R, bound, 0.2, cfg),
        synthetic_j.oracle_pair_predictions(s_a, nrm, idxs, T, R, bound, 0.2, cfg_j))


@pytest.mark.parametrize("category", ["bowl", "mug", "chair"])
def test_native_raster_equal(category):
    """The port's build of native/rasterizer.cpp gives the depth map of the
    JAX binding's build, bit for bit; the numpy plain version finds the
    same pixels, within float rounding of their depth (it computes its
    barycentrics in float64)."""
    v, f = _posed(category, 1)
    K = shapenet.TRAIN_INTRINSICS
    args = (K[0, 0], K[1, 1], K[0, 2], K[1, 2], 640, 480)
    d = native.rasterize_depth(v, f, *args)
    assert (d > 0).sum() > 1000
    assert native_j.have_native()
    np.testing.assert_array_equal(d, native_j.rasterize_depth(v, f, *args))
    plain = native.rasterize_depth_np(v, f, *args)
    np.testing.assert_array_equal(plain, native_j._rasterize_depth_np(v, f, *args))
    edge = (d > 0) != (plain > 0)
    assert edge.sum() <= 0.002 * (d > 0).sum()
    both = (d > 0) & (plain > 0)
    np.testing.assert_allclose(d[both], plain[both], rtol=0, atol=1e-5)


def test_native_build_raises_without_compiler(monkeypatch, tmp_path):
    """No quiet numpy stand-in: a failed build raises."""
    monkeypatch.setattr(native, "BUILD", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.rasterize_depth(*_posed("bowl", 0), 500.0, 500.0, 320.0, 240.0, 64, 48)


@pytest.mark.parametrize("category,depth_noise", [("bowl", 0.0), ("bowl", 1.0),
                                                  ("table", 0.0), ("table", 1.0)])
def test_dataset_stream_equal(category, depth_noise):
    cfg, cfg_j = load_config(category), load_config_j(category)
    cfg.depth_noise = cfg_j.depth_noise = depth_noise
    ds = shapenet.ShapeNetRenderDataset(cfg, seed=0)
    ds_j = shapenet_j.ShapeNetRenderDataset(cfg_j, seed=0)
    assert ds.model_names == ds_j.model_names == [] and len(ds) == len(ds_j)
    for _ in range(3):
        a, b = ds.sample(), ds_j.sample()
        np.testing.assert_array_equal(a.pc, b.pc)
        np.testing.assert_array_equal(a.bound, b.bound)
        assert a.scale == b.scale
        assert a.pc.dtype == np.float32 and len(a.pc) >= ds.min_points


def test_apply_depth_noise_equal():
    v, f = _posed("bowl", 2)
    K = shapenet.TRAIN_INTRINSICS
    d = native.rasterize_depth(v, f, K[0, 0], K[1, 1], K[0, 2], K[1, 2], 640, 480)
    for strength in (0.5, 1.0):
        np.testing.assert_array_equal(
            shapenet.apply_depth_noise(d, np.random.default_rng(1), strength),
            shapenet_j.apply_depth_noise(d, np.random.default_rng(1), strength))


def test_load_obj_and_obj_dataset(tmp_path):
    """An OBJ with quads, slashed and negative indices loads as JAX's
    loader reads it, and a dataset on an OBJ root renders from it."""
    from cppf_tpu.data.mesh import load_obj as load_obj_j

    v, f = _posed("bowl", 3)
    lines = [f"v {x} {y} {z}" for x, y, z in v.tolist()]
    lines += [f"f {a + 1}/1/1 {b + 1}//2 {c + 1}" for a, b, c in f[:-1].tolist()]
    lines += ["f -1 -2 -3 -4", "g ignored", "vn 0 0 1"]
    root = tmp_path / "shapenet"
    path = root / "04379243" / "m0" / "models" / "model_normalized.obj"
    os.makedirs(path.parent)
    path.write_text("\n".join(lines) + "\n")
    got, want = mesh.load_obj(str(path)), load_obj_j(str(path))
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert len(got.faces) == len(f) - 1 + 2
    moved = mesh.transform_mesh(got, np.diag([2.0, 2.0, 2.0, 1.0]))
    np.testing.assert_allclose(moved.vertices, 2 * got.vertices)
    with pytest.raises(ValueError):
        (tmp_path / "empty.obj").write_text("# nothing\n")
        mesh.load_obj(str(tmp_path / "empty.obj"))

    cfg = load_config("table")
    cfg.shapenet_root = str(root)
    ds = shapenet.ShapeNetRenderDataset(cfg, seed=0)
    assert ds.model_names == ["04379243/m0"]
    cfg_j = load_config_j("table")
    cfg_j.shapenet_root = str(root)
    ds_j = shapenet_j.ShapeNetRenderDataset(cfg_j, seed=0)
    a, b = ds.sample(), ds_j.sample()
    np.testing.assert_array_equal(a.pc, b.pc)
    assert a.scale == b.scale


def test_geometry_helpers_equal():
    """The port's copies of the geometry helpers against JAX's."""
    import jax.numpy as jnp

    from cppf_tpu.core import geometry as geo_j
    from cppf_tpu_torch.core import geometry as geo

    for a in (0.0, 0.3, -2.1):
        np.testing.assert_array_equal(geo.rotx(a), geo_j.rotx(a))
        np.testing.assert_array_equal(geo.roty(a), geo_j.roty(a))
    for scale, shift in ((0.3, 0), ([0.2, 0.1, 0.4], np.array([0.5, -0.2, 1.0]))):
        np.testing.assert_array_equal(geo.get_3d_bbox(scale, shift),
                                      geo_j.get_3d_bbox(scale, shift))
    box = geo.get_3d_bbox([0.2, 0.1, 0.4])
    RT = geo.roty(0.4) @ geo.rotx(0.2)
    RT[:3, 3] = [0.1, -0.05, 0.9]
    moved = geo.transform_coordinates_3d(box, RT)
    np.testing.assert_array_equal(moved, geo_j.transform_coordinates_3d(box, RT))
    K = shapenet.TRAIN_INTRINSICS
    np.testing.assert_array_equal(geo.calculate_2d_projections(moved, K),
                                  geo_j.calculate_2d_projections(moved, K))
    v, f = _posed("bowl", 4)
    depth = native.rasterize_depth(v, f, K[0, 0], K[1, 1], K[0, 2], K[1, 2], 64, 48)
    mask = np.ones_like(depth, bool)
    mask[:10] = False
    pts, valid = geo.backproject_grid(torch.from_numpy(depth).double(), torch.from_numpy(K),
                                      torch.from_numpy(mask))
    pts_j, valid_j = geo_j.backproject_grid(jnp.asarray(depth), jnp.asarray(K, jnp.float32),
                                            jnp.asarray(mask))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    np.testing.assert_allclose(pts.numpy(), np.asarray(pts_j), rtol=1e-5, atol=1e-6)
    ref, _ = geo.backproject(depth, K, mask)
    np.testing.assert_allclose(pts.numpy()[valid.numpy()], ref, rtol=1e-12)
