"""The laptop path of the port's NOCS driver against cppf_tpu's, on the
committed laptop frame (``assets/nocs_laptop_frame``: a mug, a laptop and
a bowl, with the JAX driver's full-width run and its laptop path stored).

- ``laptop_crop``: the crop within 1e-6 of JAX's (cv2's) and the same crop
  coordinates;
- ``laptop_up_from_labels`` on JAX's stored labels, the full-width
  preprocessed cloud on JAX's draws: JAX's ``laptop_up`` within 1e-5 rad;
- the composed path (crop, the port's segmenter on the committed weights,
  labels, plane) against ``laptop_up_from_aux``: 1e-5 rad;
- both drivers with ``laptop_aux`` on, at the driver tests' reduced width
  (2048 pairs, 512 points, knn 16; 12 rotations, a 3° sphere): every pose
  to the slice tolerances (T and R 1e-6, scales rtol 1e-5), the laptop's
  up axis to 1e-5 rad, and the override moving the laptop's pose;
- a ``laptop_aux`` directory with neither its orbax ``params_best/`` nor
  ``params_best.npz`` raises at the laptop and names both."""
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from cppf_tpu_torch.data.png import read_png
from cppf_tpu_torch.eval import nocs_inference as port
from test_torch_nocs_driver import WIDTH, _checkpoint_tree

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUX = os.path.join(ROOT, "checkpoints", "laptop_aux")
UP_TOL_RAD = 1e-5


def _angle(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.arccos(np.clip(a @ b / np.linalg.norm(a) / np.linalg.norm(b), -1, 1)))


def _small_tree(root, categories, aux_dir=None):
    """The driver tests' checkpoint tree at the reduced width, and
    ``laptop_aux`` linked to ``aux_dir``."""
    _checkpoint_tree(root, categories)
    if aux_dir is not None:
        os.symlink(aux_dir, os.path.join(root, "laptop_aux"))
    return root


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    """The committed frame unpacked; both packages serve the segmenter from
    the repo's ``checkpoints/laptop_aux`` (its orbax ``params_best/``)."""
    tmp = str(tmp_path_factory.mktemp("laptop_frame"))
    seg_dir, nocs_dir, _, record, stored = chip_smoke.unpack_nocs_frame(
        tmp, "nocs_laptop_frame")
    aux = AUX
    path = os.path.join(nocs_dir, record["image_path"][5:])
    k = int(stored["laptop"])
    return dict(tmp=tmp, seg_dir=seg_dir, nocs_dir=nocs_dir, record=record, stored=stored,
                aux=aux, k=k, img=read_png(path + "_color.png")[:, :, :3],
                depth=read_png(path + "_depth.png"),
                mask_idxs=np.where(record["pred_masks"][:, :, k]),
                categories=sorted({port.SYNSET_NAMES[c] for c in record["pred_class_ids"]}))


def _key(stored, name):
    return tuple(int(v) for v in stored[name])


@pytest.fixture(scope="module")
def laptop_pre(frame):
    """The laptop's cloud preprocessed at full width on the draws of its
    stored key, as the port's driver preprocesses it."""
    runner = port.CategoryRunner("laptop", device="cpu")
    pc = port.frame_crops(frame["depth"], frame["record"], {"laptop": runner})["laptop"][0][1]
    pre = runner.preprocess(pc, runner.draws(_key(frame["stored"], "r_inst")))
    n = int(pre.n_valid)
    return runner, pc, pre, pre.pc[:n].numpy()


def test_laptop_crop_matches_jax(frame):
    crop, idxs, bbox = port.laptop_crop(frame["img"], frame["mask_idxs"])
    assert crop.dtype == np.float32 and crop.shape == (224, 224, 3)
    np.testing.assert_allclose(crop, frame["stored"]["crop"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(idxs, frame["stored"]["idxs_resized"])
    rows, cols = frame["mask_idxs"]
    np.testing.assert_array_equal(bbox, [[rows.min(), rows.max()], [cols.min(), cols.max()]])


def test_laptop_up_from_stored_labels(frame, laptop_pre):
    """JAX's labels and the port's full-width cloud on JAX's draws give
    JAX's ``laptop_up``; under 10 base points there is none."""
    stored = frame["stored"]
    _, _, pre, pc = laptop_pre
    labels = stored["labels"].astype(np.int64)
    up = port.laptop_up_from_labels(labels, stored["idxs_resized"].astype(np.int64), pc, pre,
                                    _key(stored, "r_plane"))
    assert _angle(up, stored["laptop_up"]) <= UP_TOL_RAD
    assert up @ pc[labels[tuple(stored["idxs_resized"][pre.raw_idx[:len(pc)].numpy()].T)]
                   == 0].mean(0) < 0
    assert port.laptop_up_from_labels(np.ones_like(labels), stored["idxs_resized"], pc, pre,
                                      _key(stored, "r_plane")) is None


def test_composed_path_matches_laptop_up_from_aux(frame, laptop_pre):
    """Crop, segmenter, labels and plane against JAX's
    ``laptop_up_from_aux`` on the committed weights, each package on its
    own preprocess of the same draws (the same kept points)."""
    import jax.numpy as jnp

    from cppf_tpu.eval.nocs_inference import laptop_up_from_aux
    from cppf_tpu.models.segmenter import SegmenterRunner as SegmenterRunnerJ
    from cppf_tpu.pipeline.preprocess import preprocess_cloud as preprocess_j
    from cppf_tpu_torch.models.segmenter import SegmenterRunner

    runner, pc_raw, pre, pc = laptop_pre
    cfg = runner.cfg
    pad, n_raw = port._pad_cloud(pc_raw, cfg.npoint_max)
    r_inst = jnp.asarray(frame["stored"]["r_inst"], jnp.uint32)
    pre_j = preprocess_j(jax.random.split(r_inst)[0], jnp.asarray(pad), n_raw, cfg.res,
                         npoint_pad=cfg.npoint_pad, knn=cfg.knn)
    n = int(pre_j.n_valid)
    assert n == len(pc)
    np.testing.assert_array_equal(pre.raw_idx[:n].numpy(), np.asarray(pre_j.raw_idx)[:n])
    r_plane = jnp.asarray(frame["stored"]["r_plane"], jnp.uint32)
    up_j = laptop_up_from_aux(frame["img"], frame["mask_idxs"], np.asarray(pre_j.pc)[:n], pre_j,
                              SegmenterRunnerJ(frame["aux"]), r_plane)
    assert _angle(up_j, frame["stored"]["laptop_up"]) <= UP_TOL_RAD

    crop, idxs, _ = port.laptop_crop(frame["img"], frame["mask_idxs"])
    labels = SegmenterRunner(frame["aux"], device="cpu").predict(crop)
    assert (labels == frame["stored"]["labels"]).mean() >= 0.999
    up = port.laptop_up_from_labels(labels, idxs, pc, pre, _key(frame["stored"], "r_plane"))
    assert _angle(up, up_j) <= UP_TOL_RAD


def _run_drivers(frame, ckpt, out, with_jax=True):
    """Both drivers (or the port's alone) on the frame at ``--seed`` of the
    stored run; returns ({who: pkl}, {who: [laptop_up]}, the port's chunks)."""
    import pickle

    from cppf_tpu.eval import nocs_inference as driver_j

    args = ["--seg_dir", frame["seg_dir"], "--nocs_dir", frame["nocs_dir"], "--ckpt_path", ckpt,
            "--seed", str(int(frame["stored"]["seed"])), *WIDTH]
    ups = {"jax": [], "port": []}
    real_j, real_t = driver_j.laptop_up_from_aux, port.laptop_up_from_labels
    driver_j.laptop_up_from_aux = lambda *a: ups["jax"].append(real_j(*a)) or ups["jax"][-1]
    port.laptop_up_from_labels = lambda *a: ups["port"].append(real_t(*a)) or ups["port"][-1]
    try:
        if with_jax:
            driver_j.main(args + ["--out_dir", os.path.join(out, "jax")])
        chunks = port.main(args + ["--out_dir", os.path.join(out, "port"), "--device", "cpu"])
    finally:
        driver_j.laptop_up_from_aux, port.laptop_up_from_labels = real_j, real_t
    res = {}
    for who in ("jax", "port") if with_jax else ("port",):
        with open(port.result_path(os.path.join(out, who), frame["record"]), "rb") as f:
            res[who] = pickle.load(f)
    return res, ups, chunks[0]


def _rotation(RT):
    return RT[:3, :3] / np.cbrt(np.linalg.det(RT[:3, :3]))


def test_driver_with_segmenter_matches_jax(frame):
    tmp = frame["tmp"]
    ckpt = _small_tree(os.path.join(tmp, "small"), frame["categories"], frame["aux"])
    res, ups, chunks = _run_drivers(frame, ckpt, os.path.join(tmp, "runs"))
    assert [(c.category, c.instances, c.batched) for c in chunks] == [
        ("mug", 1, False), ("laptop", 1, False), ("bowl", 1, False)]
    assert len(ups["jax"]) == len(ups["port"]) == 1 and ups["jax"][0] is not None
    assert _angle(ups["port"][0], ups["jax"][0]) <= UP_TOL_RAD
    res_j, res_t = res["jax"], res["port"]
    for i in range(len(frame["record"]["pred_class_ids"])):
        RT_j, RT_t = res_j["pred_RTs"][i], res_t["pred_RTs"][i]
        assert not np.allclose(RT_t, np.eye(4)), f"instance {i} was not posed"
        np.testing.assert_allclose(RT_t[:3, 3], RT_j[:3, 3], atol=1e-6)
        np.testing.assert_allclose(_rotation(RT_t), _rotation(RT_j), atol=1e-6)
        np.testing.assert_allclose(res_t["pred_scales"][i], res_j["pred_scales"][i], rtol=1e-5)

    # without the segmenter the laptop keeps its voted axes: the override moved them
    plain = _small_tree(os.path.join(tmp, "small_plain"), frame["categories"])
    res_plain = _run_drivers(frame, plain, os.path.join(tmp, "runs_plain"), with_jax=False)[0]
    k = frame["k"]
    np.testing.assert_array_equal(np.delete(res_plain["port"]["pred_RTs"], k, 0),
                                  np.delete(res_t["pred_RTs"], k, 0))
    assert _angle(_rotation(res_plain["port"]["pred_RTs"][k])[:, 1],
                  _rotation(res_t["pred_RTs"][k])[:, 1]) > np.radians(5)


def test_laptop_aux_without_weights_raises(frame, tmp_path):
    """A ``laptop_aux`` directory with neither an orbax ``params_best/`` nor
    ``params_best.npz``: the laptop is never posed without the override JAX
    would use; the error names both."""
    empty = tmp_path / "aux_without_weights"
    empty.mkdir()
    ckpt = _small_tree(str(tmp_path / "ckpt"), frame["categories"], str(empty))
    args = ["--seg_dir", frame["seg_dir"], "--nocs_dir", frame["nocs_dir"], "--ckpt_path", ckpt,
            "--out_dir", str(tmp_path / "out"), "--device", "cpu", *WIDTH]
    with pytest.raises(FileNotFoundError, match=r"params_best/ \(orbax\) or .*params_best\.npz"):
        port.main(args)
    assert not os.listdir(tmp_path / "out")
