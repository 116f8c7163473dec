"""The segmenter's training data and trainer in the port
(data/laptop_aux.py, data/exr.py, train/laptop_aux.py) against cppf_tpu's.

- ``make_laptop_mesh`` equal to JAX's;
- the synthetic stream: three samples at each of seeds 0-2 equal to JAX's
  ``LaptopAuxDataset`` (rgb within 1e-5, labels exact);
- the Blender stream on a two-mesh tree made here (renders as PNG, depth
  as EXR through JAX's ``write_exr``, ``.tr.npy`` / ``.rot.npy``, some
  views missing or out of range, so that draws are rejected): equal to
  JAX's;
- ``read_exr`` / ``write_exr`` against JAX's, both ways;
- ``train`` for one short epoch on the CPU writes a ``params_best.npz``
  that ``SegmenterRunner`` serves, and the CLI needs a GPU unless told
  ``device=cpu``."""

import cv2
import numpy as np
import pytest
import torch

from cppf_tpu.data import exr as exr_j
from cppf_tpu.data import laptop_aux as data_j
from cppf_tpu_torch.data import exr, laptop_aux
from cppf_tpu_torch.data import native

torch.set_num_threads(1)


@pytest.mark.parametrize("args", [(100.0,), (70.0, 0.25, 0.18), (135.0, 0.35, 0.26, 0.01)])
def test_make_laptop_mesh_matches_jax(args):
    (v, f), labels = laptop_aux.make_laptop_mesh(*args)
    (v_j, f_j), labels_j = data_j.make_laptop_mesh(*args)
    np.testing.assert_array_equal(v, v_j)
    np.testing.assert_array_equal(f, f_j)
    np.testing.assert_array_equal(labels, labels_j)
    assert v.dtype == v_j.dtype and f.dtype == f_j.dtype


def _assert_stream_equal(ds, ds_j, n):
    for _ in range(n):
        (rgb, lab), (rgb_j, lab_j) = ds.sample(), ds_j.sample()
        assert rgb.dtype == np.float32 and rgb.shape == (224, 224, 3)
        assert lab.dtype == np.int64 and lab.shape == (224, 224)
        np.testing.assert_allclose(rgb, rgb_j, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(lab, lab_j)
    # the generators were left in the same state
    assert ds.rng.random() == ds_j.rng.random()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_stream_matches_jax(seed):
    ds = laptop_aux.LaptopAuxDataset(data_root="/nonexistent", seed=seed)
    ds_j = data_j.LaptopAuxDataset(data_root="/nonexistent", seed=seed)
    assert not ds.use_blender and not ds_j.use_blender
    _assert_stream_equal(ds, ds_j, 3)


def _blender_tree(root):
    """Two laptop meshes, each with views 1-8 (of the 20 the loader draws
    from): depth as Blender's ray depth in EXR, a depth-shaded PNG, the
    pose files; view 3 of each sits at |tr_z| < 0.8, which the loader
    rejects."""
    from scipy.spatial.transform import Rotation

    K = laptop_aux.BLENDER_INTRINSICS
    probe = laptop_aux.LaptopAuxDataset(data_root="/nonexistent")
    u, v = np.meshgrid(np.arange(640), np.arange(480))
    x = (0.5 - u / 640) * probe.camera_sensor_width / probe.camera_lens
    y = (0.5 - v / 480) * (480 / 640 * probe.camera_sensor_width) / probe.camera_lens
    norm = np.sqrt(x**2 + y**2 + 1)
    for m, angle in enumerate((105.0, 125.0)):
        mesh_dir = root / "03642806" / f"mesh{m}"
        mesh_dir.mkdir(parents=True)
        mesh, _ = laptop_aux.make_laptop_mesh(angle)
        for i in range(1, 9):
            rot = Rotation.from_euler("yxy", [40.0 * i + 90 * m, 25.0 + 3 * i, 0],
                                      degrees=True).as_matrix()
            tr = np.array([0.03 * i - 0.1, 0.02 * m, 0.5 if i == 3 else 1.0 + 0.05 * i])
            v_cam = mesh.vertices @ rot.T + np.float32([tr[0], -tr[1], -tr[2]])
            depth = native.rasterize_depth(v_cam, mesh.faces, K[0, 0], K[1, 1], K[0, 2],
                                           K[1, 2], 640, 480)
            ray = np.where(depth > 0, depth * norm, 0).astype(np.float32)
            shade = np.clip(1.6 - ray, 0, 1)[:, :, None] * np.float32([200, 150, 90 + 20 * m])
            cv2.imwrite(str(mesh_dir / f"{i}.png"), shade.astype(np.uint8)[:, :, ::-1])
            exr_j.write_exr(str(mesh_dir / f"{i}_depth0001.exr"), {"R": ray})
            np.save(str(mesh_dir / f"{i}.tr.npy"), tr)
            np.save(str(mesh_dir / f"{i}.rot.npy"), rot)
    return root


def test_blender_stream_matches_jax(tmp_path):
    root = str(_blender_tree(tmp_path / "laptop"))
    ds = laptop_aux.LaptopAuxDataset(data_root=root, seed=4)
    ds_j = data_j.LaptopAuxDataset(data_root=root, seed=4)
    assert ds.use_blender and ds_j.use_blender
    assert ds.model_names == ds_j.model_names == ["03642806/mesh0", "03642806/mesh1"]
    rgb, lab = ds.sample()
    rgb_j, lab_j = ds_j.sample()
    np.testing.assert_allclose(rgb, rgb_j, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(lab, lab_j)
    assert (lab == 0).sum() > 50 and (lab == 1).sum() > 50
    _assert_stream_equal(ds, ds_j, 2)


@pytest.mark.parametrize("compression", [0, 2, 3])
def test_exr_matches_jax(tmp_path, compression):
    rng = np.random.default_rng(compression)
    channels = {"R": rng.uniform(0.5, 3.0, (37, 53)).astype(np.float32),
                "G": rng.uniform(0, 1, (37, 53)).astype(np.float16),
                "B": rng.integers(0, 1 << 30, (37, 53)).astype(np.uint32)}
    mine, theirs = str(tmp_path / "port.exr"), str(tmp_path / "jax.exr")
    exr.write_exr(mine, channels, compression=compression)
    exr_j.write_exr(theirs, channels, compression=compression)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for path in (mine, theirs):
        for read in (exr.read_exr, exr_j.read_exr):
            got = read(path)
            assert got.keys() == channels.keys()
            for name, want in channels.items():
                assert got[name].dtype == want.dtype
                np.testing.assert_array_equal(got[name], want)


def test_short_training_run_is_served(tmp_path):
    from cppf_tpu_torch.models.segmenter import SegmenterRunner
    from cppf_tpu_torch.train.laptop_aux import train

    out = str(tmp_path / "laptop_aux")
    model, losses = train(max_epoch=1, epoch_len=4, batch_size=2, out_dir=out,
                          data_root="/nonexistent", device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))
    runner = SegmenterRunner(out, device="cpu")
    crop = laptop_aux.LaptopAuxDataset(data_root="/nonexistent", seed=9).sample()[0]
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(crop)[None])[0].argmax(-1).numpy()
    np.testing.assert_array_equal(runner.predict(crop), want)


def test_cli_needs_cuda_unless_told_cpu():
    from cppf_tpu_torch.train.laptop_aux import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["max_epoch=1", "epoch_len=2", "batch_size=2", "out_dir=/nonexistent/out"])
