"""The port's orbax reader (train/orbax.py over csrc/zstd_decode.cpp) against
the JAX package's own restore and libzstd.

- The zstd decoder is byte-equal to libzstd (loaded here by ctypes, and
  only here) on hypothesis-drawn and structured buffers: float32 weights,
  text, runs, random bytes, 0 B to past two 128 KB blocks; levels 1, 3, 9
  and 19; with and without the checksum and the content size; two frames
  back to back.  Truncated and corrupt frames raise ``ValueError``.
- ``restore_numpy`` of each of the repo's 33 orbax checkpoints equals
  ``cppf_tpu.train.checkpoints._restore_numpy`` in keys, their order,
  containers, shapes, dtypes and bits; so do checkpoints that JAX's
  ``save_params`` and ``save_train_state`` write here (orbax writes an
  array sharded over the 8 CPU devices as one chunk a shard: 8 chunks), a
  zarr array of a ragged chunk grid with absent chunks that tensorstore
  writes, and a database of interior nodes and inline values.
- A truncated or corrupt data file or node and a missing data file raise
  ``ValueError``; ``maybe_load_any`` logs them and treats them as missing.
- The exported assets equal the orbax reads to the bit, and the laptop
  segmenter served from ``checkpoints/laptop_aux`` gives JAX's stored
  labels on the laptop frame.
"""
import ctypes
import ctypes.util
import glob
import json
import logging
import os
import shutil
from typing import NamedTuple

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from cppf_tpu_torch.models.convert import ASSETS, load_npz_params
from cppf_tpu_torch.train import checkpoints as ckpt_t
from cppf_tpu_torch.train import orbax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = sorted(os.path.relpath(os.path.dirname(p), os.path.join(ROOT, "checkpoints"))
                     for p in glob.glob(os.path.join(ROOT, "checkpoints", "*", "*", "_METADATA")))
CATEGORIES = ("bathtub", "bed", "bookshelf", "bottle", "bowl", "camera", "can", "chair",
              "laptop", "mug", "sofa", "table")
LEVELS = (1, 3, 9, 19)
BLOCK = 128 * 1024
LABELS_EQUAL = 0.999          # phase 14's limit on the laptop frame's labels


# ---- libzstd, the decoder's oracle -------------------------------------------

def _libzstd():
    name = ctypes.util.find_library("zstd") or "libzstd.so.1"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        pytest.skip("libzstd is not installed")
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ZSTD_CCtx_setParameter.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.c_char_p, ctypes.c_size_t]
    lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    return lib


def _compress(data: bytes, level: int, checksum: bool, content_size: bool) -> bytes:
    lib = _libzstd()
    cctx = lib.ZSTD_createCCtx()
    try:
        # ZSTD_c_compressionLevel, ZSTD_c_contentSizeFlag, ZSTD_c_checksumFlag
        for param, value in ((100, level), (200, int(content_size)), (201, int(checksum))):
            assert not lib.ZSTD_isError(lib.ZSTD_CCtx_setParameter(cctx, param, value))
        cap = lib.ZSTD_compressBound(len(data))
        out = ctypes.create_string_buffer(cap)
        n = lib.ZSTD_compress2(cctx, out, cap, data, len(data))
        assert not lib.ZSTD_isError(n)
        return out.raw[:n]
    finally:
        lib.ZSTD_freeCCtx(cctx)


def _structured(kind: str, size: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == "weights":  # a layer's float32 weights: the checkpoints' chunks
        return (rng.standard_normal(size // 4 + 1) * 0.05).astype(np.float32).tobytes()[:size]
    if kind == "text":
        words = [b"orbax", b"zarr", b"chunk", b"kernel", b"bias", b"scale", b"params"]
        return b" ".join(words[i] for i in rng.integers(0, len(words), size))[:size]
    if kind == "runs":  # long runs of few values: RLE blocks and literals
        return np.repeat(rng.integers(0, 3, size // 500 + 1, dtype=np.uint8),
                         500).tobytes()[:size]
    if kind == "random":  # incompressible: raw blocks
        return rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    return bytes(size)


SIZES = (0, 1, 1000, BLOCK - 1, BLOCK + 1, 2 * BLOCK + 12345)
KINDS = ("weights", "text", "runs", "random", "zeros")


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("kind", KINDS)
def test_decoder_equals_libzstd_on_structured_buffers(kind, level):
    for size in SIZES:
        data = _structured(kind, size, seed=size)
        for checksum in (False, True):
            for content_size in (False, True):
                frame = _compress(data, level, checksum, content_size)
                got = orbax.zstd_decompress(frame, len(data))
                assert got.tobytes() == data, (kind, size, level, checksum, content_size)


def test_decoder_frames_back_to_back_and_skippable():
    a, b = _structured("weights", 70_000, 1), _structured("text", 300_000, 2)
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"xxxxx"
    stream = _compress(a, 3, True, False) + skippable + _compress(b, 19, False, True)
    assert orbax.zstd_decompress(stream, len(a) + len(b)).tobytes() == a + b
    with pytest.raises(ValueError, match="limit"):
        orbax.zstd_decompress(stream, len(a) + len(b) - 1)


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(parts=st.lists(st.tuples(st.sampled_from(KINDS), st.integers(0, 90_000),
                                st.integers(0, 2 ** 31)), max_size=5),
       level=st.sampled_from(LEVELS), checksum=st.booleans(), content_size=st.booleans())
def test_decoder_equals_libzstd_on_drawn_buffers(parts, level, checksum, content_size):
    data = b"".join(_structured(kind, size, seed) for kind, size, seed in parts)
    frame = _compress(data, level, checksum, content_size)
    assert orbax.zstd_decompress(frame, len(data)).tobytes() == data


def test_decoder_raises_on_truncated_and_corrupt_frames():
    data = _structured("weights", 200_000) + _structured("text", 100_000)
    for level in (1, 19):
        frame = _compress(data, level, True, True)
        for cut in range(0, len(frame), max(1, len(frame) // 200)):
            with pytest.raises(ValueError):
                orbax.zstd_decompress(frame[:cut], len(data))
        rng = np.random.default_rng(level)
        for _ in range(200):
            bad = bytearray(frame)
            for i in rng.integers(0, len(bad), 3):
                bad[i] ^= int(rng.integers(1, 256))
            try:  # a flipped bit may still decode: it must never crash
                out = orbax.zstd_decompress(bytes(bad), len(data))
            except ValueError:
                continue
            assert out.size <= len(data)
    with pytest.raises(ValueError, match="magic"):
        orbax.zstd_decompress(b"\x00" * 16, 100)


# ---- the repo's checkpoints against JAX's restore ---------------------------

def _assert_same_tree(got, want, path=""):
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}[{i}]")
    elif want is not None:
        assert got.shape == want.shape and got.dtype == want.dtype, path
        assert got.tobytes() == want.tobytes(), path


def test_the_repo_holds_33_orbax_checkpoints():
    assert len(CHECKPOINTS) == 33
    assert sum(c.endswith("/best_decode") for c in CHECKPOINTS) == 7


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_restore_equals_jax_on_committed_checkpoints(name):
    from cppf_tpu.train.checkpoints import _restore_numpy

    path = os.path.join(ROOT, "checkpoints", name)
    _assert_same_tree(orbax.restore_numpy(path), _restore_numpy(path))


class _State(NamedTuple):
    params: dict
    opt_state: tuple
    step: object


def test_restore_equals_jax_on_checkpoints_jax_writes(tmp_path):
    """A seeded tree of nested dicts, a list, an int32 step, None in the
    optimizer state, a float64 numpy leaf and an array sharded over the 8
    CPU devices, which orbax writes as 8 chunks."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from cppf_tpu.train.checkpoints import _restore_numpy, load_params, save_params, \
        save_train_state

    rng = np.random.default_rng(16)
    mesh = Mesh(np.array(jax.devices()), ("d",))
    n_dev = len(jax.devices())
    sharded = jax.device_put(jnp.asarray(rng.standard_normal((8 * n_dev, 33)), jnp.float32),
                             NamedSharding(mesh, PartitionSpec("d", None)))
    params = {"enc": {"kernel": jnp.asarray(rng.standard_normal((5, 7)), jnp.float32),
                      "bias": jnp.asarray(rng.standard_normal(7), jnp.float32)},
              "layers": [{"k": jnp.asarray(rng.standard_normal(3), jnp.float32)},
                         {"k": jnp.arange(4, dtype=jnp.int32)}],
              "wide": sharded,
              "host": np.arange(6, dtype=np.float64).reshape(2, 3)}
    state = _State(params, (None, {"count": jnp.int32(3),
                                   "mu": {"a": jnp.asarray(rng.standard_normal(2),
                                                           jnp.float32)}}),
                   jnp.int32(12000))
    save_params(str(tmp_path), params, "params_best")
    save_train_state(str(tmp_path), state, "best_decode")
    with orbax.Database(str(tmp_path / "params_best")) as db:
        wide = [k for k in db.items() if k.startswith(b"params.wide/") and b".zarray" not in k]
    assert len(wide) == n_dev == 8
    for name in ("params_best", "best_decode"):
        path = str(tmp_path / name)
        _assert_same_tree(orbax.restore_numpy(path), _restore_numpy(path))
        got, want = ckpt_t.load_params(str(tmp_path), name), load_params(str(tmp_path), name)
        _assert_same_tree(got, jax.tree_util.tree_map(np.asarray, want))
    step = orbax.restore_numpy(str(tmp_path / "best_decode"))["step"]
    assert step.dtype == np.int32 and step.shape == () and int(step) == 12000


def test_zarr_chunk_grid_with_absent_chunks(tmp_path):
    """A 5×7 float64 array in 2×3 chunks (a ragged edge) of which two were
    never written, fill value 1.5, as tensorstore stores it in OCDBT."""
    import tensorstore as ts

    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/"},
            "path": "a.b", "metadata": {"shape": [5, 7], "chunks": [2, 3], "dtype": "<f8",
                                        "fill_value": 1.5, "compressor": {"id": "zstd",
                                                                          "level": 3}},
            "create": True}
    arr = ts.open(spec).result()
    data = np.random.default_rng(0).standard_normal((5, 7))
    arr[0:2, :].write(data[0:2, :]).result()
    arr[4:5, 3:7].write(data[4:5, 3:7]).result()
    want = arr.read().result()
    with orbax.Database(str(tmp_path)) as db:
        items = db.items()
        assert sum(k.startswith(b"a.b/") for k in items) == 1 + 5  # of 9 chunks
        got = orbax.read_zarr(db, items, "a.b")
    assert got.dtype == np.float64 and np.array_equal(got, want)
    assert np.all(got[2:4] == 1.5)


@pytest.mark.parametrize("metadata,match", [
    ({"dtype": "<i2"}, "zarr dtype '<i2'"),
    ({"compressor": {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1}},
     "zarr compressor 'blosc'"),
    ({"order": "F"}, "zarr order 'F'")])
def test_unknown_zarr_constructs_raise_by_name(metadata, match, tmp_path):
    import tensorstore as ts

    meta = {"shape": [4, 3], "chunks": [2, 3], "dtype": "<f4", **metadata}
    arr = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/"},
                   "path": "x", "metadata": meta, "create": True}).result()
    arr.write(np.ones((4, 3), arr.dtype.numpy_dtype)).result()
    with orbax.Database(str(tmp_path)) as db:
        with pytest.raises(ValueError, match=match):
            orbax.read_zarr(db, db.items(), "x")


def test_database_of_interior_nodes_and_inline_values(tmp_path):
    """Small nodes force a B-tree of height > 0 with prefix-stripped child
    keys; small values are stored inline, large ones in data files."""
    import tensorstore as ts

    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_decoded_node_bytes": 300,
                                     "max_inline_value_bytes": 20,
                                     "version_tree_arity_log2": 1}}).result()
    want = {}
    for gen in range(4):
        with ts.Transaction() as txn:
            for i in range(50):
                key = f"key{gen:02d}_{i:03d}".encode()
                want[key] = bytes([i]) * (i % 40)
                kv.with_transaction(txn)[key] = want[key]
    with orbax.Database(str(tmp_path)) as db:
        assert db.root_height > 0
        items = db.items()
        got = {k: db.value(v) for k, v in items.items()}
    assert got == want


# ---- faults ------------------------------------------------------------------

def _copy(tmp_path, name="bowl/params_best"):
    dst = tmp_path / "bowl"
    dst.mkdir()
    shutil.copytree(os.path.join(ROOT, "checkpoints", name), dst / "params_best")
    return dst


def _largest_value(ckpt_dir):
    with orbax.Database(str(ckpt_dir / "params_best")) as db:
        refs = [v for v in db.items().values() if isinstance(v, orbax.NodeRef)]
    return max(refs, key=lambda r: r.length)


def _truncate_data_file(d):
    ref = _largest_value(d)
    path = d / "params_best" / ref.path
    with open(path, "r+b") as f:
        f.truncate(ref.offset + ref.length // 2)


def _corrupt_frame(d):
    ref = _largest_value(d)
    with open(d / "params_best" / ref.path, "r+b") as f:
        f.seek(ref.offset)
        f.write(b"\x00\x00\x00\x00")


def _corrupt_node(d):
    _corrupt_node_dir(d / "params_best")


def _missing_data_file(d):
    os.remove(d / "params_best" / _largest_value(d).path)


FAULTS = {"truncated data file": (_truncate_data_file, "shorter"),
          "corrupt frame": (_corrupt_frame, "zstd"),
          "corrupt node": (_corrupt_node, "CRC"),
          "missing data file": (_missing_data_file, "missing data file")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_raise_and_count_as_missing(fault, tmp_path, caplog):
    d = _copy(tmp_path)
    make, match = FAULTS[fault]
    make(d)
    with pytest.raises(ValueError, match=match):
        orbax.restore_numpy(str(d / "params_best"))
    with caplog.at_level(logging.WARNING, logger="cppf_tpu_torch.checkpoints"):
        assert ckpt_t.maybe_load_any(str(d), "params_best") is None
    assert "unreadable checkpoint" in caplog.text
    # the port's own .npz of the name is served next, as JAX's order has it
    shutil.copy(os.path.join(ASSETS, "bowl_params_best.npz"), d / "params_best.npz")
    _assert_same_tree(ckpt_t.maybe_load_any(str(d), "params_best"),
                      load_npz_params(os.path.join(ASSETS, "bowl_params_best.npz")))


@pytest.mark.parametrize("field,value,match", [("use_zarr3", True, "zarr3"),
                                               ("use_ocdbt", False, "without OCDBT")])
def test_unknown_constructs_raise_by_name(field, value, match, tmp_path):
    d = _copy(tmp_path)
    path = d / "params_best" / "_METADATA"
    meta = json.loads(path.read_text())
    meta[field] = value
    path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match=match):
        orbax.restore_numpy(str(d / "params_best"))
    shutil.rmtree(d / "params_best")
    with pytest.raises(ValueError, match="_METADATA"):
        (d / "params_best").mkdir()
        orbax.restore_numpy(str(d / "params_best"))


# ---- what the port serves -----------------------------------------------------

@pytest.mark.parametrize("asset,name", [(f"{c}_params_best.npz", f"{c}/params_best")
                                        for c in CATEGORIES]
                         + [("bowl_reg_params_zs.npz", "bowl_reg/params_zs")])
def test_assets_equal_the_orbax_read(asset, name):
    cat_dir, state = os.path.split(os.path.join(ROOT, "checkpoints", name))
    got = ckpt_t.load_params(cat_dir, state)
    want = load_npz_params(os.path.join(ASSETS, asset))

    def flat(tree, prefix=""):
        for k, v in tree.items():
            yield from (flat(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)])

    got, want = dict(flat(got)), dict(flat(want))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


def test_committed_laptop_segmenter_gives_jax_labels(monkeypatch):
    """``SegmenterRunner(checkpoints/laptop_aux)``, read from its orbax
    ``params_best/`` (no ``.npz`` export is read), on the laptop frame's
    crop: JAX's stored labels on at least 99.9 % of 224² (phase 14's
    limit)."""
    from cppf_tpu_torch.models.segmenter import SegmenterRunner

    def no_npz(path):
        raise AssertionError(f"read {path}")

    monkeypatch.setattr(ckpt_t, "load_npz_params", no_npz)
    with np.load(os.path.join(ASSETS, "nocs_laptop_frame", "jax_driver.npz")) as z:
        crop, labels = z["crop"], z["labels"]
    runner = SegmenterRunner(os.path.join(ROOT, "checkpoints", "laptop_aux"), device="cpu")
    got = runner.predict(crop)
    assert got.shape == (224, 224)
    assert (got == labels).mean() >= LABELS_EQUAL


def test_runner_serves_a_jax_train_state(tmp_path):
    """``CategoryRunner(ckpt_name="best_decode")`` (``eval_checkpoints
    --name best_decode``) on a directory that holds only a ``*_r5*``
    experiment's JAX train state (params, optax state, step) and its
    config serves the state's ``params``."""
    from cppf_tpu_torch.eval.nocs_inference import CategoryRunner
    from cppf_tpu_torch.models.convert import params_to_state_dicts

    src = os.path.join(ROOT, "checkpoints", "mug_r5boost")
    (tmp_path / "mug").mkdir()
    os.symlink(os.path.join(src, "best_decode"), tmp_path / "mug" / "best_decode")
    shutil.copy(os.path.join(src, "config.yaml"), tmp_path / "mug")
    runner = CategoryRunner("mug", device="cpu", ckpt_path=str(tmp_path),
                            ckpt_name="best_decode")
    state = orbax.restore_numpy(os.path.join(src, "best_decode"))
    assert sorted(state) == ["opt_state", "params", "step"] and int(state["step"]) == 12000
    point, ppf = params_to_state_dicts(state["params"])
    for want, module in ((point, runner.point_encoder), (ppf, runner.ppf_encoder)):
        got = module.state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_promote_installs_an_orbax_state(tmp_path):
    """An orbax state is read, then copied as ``params_best/`` (as the JAX
    script copies it) and the stale ``params_best.npz`` goes, so that the
    runner serves the promoted state; promoting an ``.npz`` afterwards
    removes the orbax directory again."""
    from cppf_tpu_torch.scripts import promote

    exp = tmp_path / "mug_r5boost"
    shutil.copytree(os.path.join(ROOT, "checkpoints", "mug_r5boost"), exp)
    prod = tmp_path / "prod" / "mug"
    prod.mkdir(parents=True)
    shutil.copy(os.path.join(ASSETS, "mug_params_best.npz"), prod / "params_best.npz")
    dst = promote.promote("mug", str(exp), "best_decode", str(tmp_path / "prod"))
    assert dst == str(prod / "params_best") and not (prod / "params_best.npz").exists()
    assert (prod / "config.yaml").exists()
    _assert_same_tree(ckpt_t.load_params(str(prod), "params_best"),
                      orbax.restore_numpy(str(exp / "best_decode"))["params"])
    shutil.copy(os.path.join(ASSETS, "mug_params_best.npz"), exp / "params_npz.npz")
    dst = promote.promote("mug", str(exp), "params_npz", str(tmp_path / "prod"))
    assert dst == str(prod / "params_best.npz") and not (prod / "params_best").exists()
    _corrupt_node_dir(exp / "best_decode")
    with pytest.raises(ValueError, match="CRC"):
        promote.promote("mug", str(exp), "best_decode", str(tmp_path / "prod"))
    assert (prod / "params_best.npz").exists()


def _corrupt_node_dir(state_dir):
    node = glob.glob(str(state_dir / "d" / "*"))[0]
    data = bytearray(open(node, "rb").read())
    data[len(data) // 2] ^= 0x40
    open(node, "wb").write(bytes(data))
