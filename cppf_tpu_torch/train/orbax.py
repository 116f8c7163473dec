"""Read orbax checkpoints without JAX, orbax or tensorstore (the restore
half of cppf_tpu/train/checkpoints.py::_restore_numpy).

An orbax checkpoint directory, as the JAX package's ``save_params`` and
``save_train_state`` write it (``StandardCheckpointer``: OCDBT on, zarr
v2), holds
    _METADATA            JSON; ``tree_metadata`` lists every leaf in the
                         tree's order with its key path (``key_type`` 2 a
                         dict key, 1 a sequence index) and its value type
    manifest.ocdbt       the OCDBT manifest of the root database
    d/<file>             its B-tree nodes
    ocdbt.process_<i>/   the databases that each writing process filled;
                         the root's leaves point into their ``d/`` files
Each array leaf ``a.b.c`` (key path joined by ``.``) is two or more keys of
the database: ``a.b.c/.zarray``, the zarr v2 array description, and one
key per chunk (``a.b.c/0.0``; ``0`` for a 0-d array), each chunk one zstd
frame of C-order bytes.

OCDBT (tensorstore's key-value database): every manifest and node file is
an envelope ``magic (u32 BE) | length (u64 LE) | version (varint) |
compression (varint: 0 none, 1 zstd) | body | CRC-32C (u32 LE)`` with the
CRC over all bytes before it.  The manifest body holds the config, a table
of data files and the latest versions, each naming the root node
(file, offset, length) and its height.  A node body is its height, its own
table of data files and its entries: prefix-compressed keys (each key's
length shared with the key before it, then the rest), for an interior node
each child's common key prefix and reference, for a leaf each value's
length and kind (0 inline, stored at the end of the node; 1 indirect: a
file, offset and length).  A child's keys are stored without the prefix
its parent's entry gives them.

The zstd frames decode in ``csrc/zstd_decode.cpp``, a decoder written from
RFC 8878 that compiles with ``g++`` at first use into ``_build/`` (as
``data/native.py`` builds the rasterizer; a failed build raises) and binds
by ``ctypes``; CRC-32C comes from the same library.  Anything this reader
does not know (an envelope or manifest version, a compression id, a
numbered manifest, a zarr filter, compressor or order, a dtype outside
``<f4 <f8 <i4 <i8 <u4 |b1``) raises ``ValueError`` naming it, as do a
checksum that does not match, a truncated or corrupt frame or node and a
missing data file.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from cppf_tpu_torch.data.native import build_host_library
from cppf_tpu_torch.ops.cuda_build import CSRC

ZSTD_SOURCE = os.path.join(CSRC, "zstd_decode.cpp")
# no -march=native: the library may be built on one host and loaded on another
ZSTD_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
MANIFEST_MAGIC, NODE_MAGIC = 0x0CDB3A2A, 0x0CDB20DE
DTYPES = ("<f4", "<f8", "<i4", "<i8", "<u4", "|b1")
MAX_MANIFEST_BYTES = 1 << 26

_lib: Optional[ctypes.CDLL] = None


def load_zstd() -> ctypes.CDLL:
    """The decoder's library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_host_library("cppf_zstd", [ZSTD_SOURCE], ZSTD_FLAGS))
        lib.cppf_zstd_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.c_char_p, ctypes.c_int64]
        lib.cppf_zstd_decode.restype = ctypes.c_int64
        lib.cppf_zstd_release.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.cppf_zstd_release.restype = None
        lib.cppf_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.cppf_crc32c.restype = ctypes.c_uint32
        _lib = lib
    return _lib


def zstd_decompress(data: bytes, max_out: int) -> np.ndarray:
    """Every zstd frame of ``data`` decoded, back to back, as a writable
    uint8 array.  Raises ``ValueError`` on corrupt or truncated input, or
    when the output would pass ``max_out`` bytes."""
    lib = load_zstd()
    out = ctypes.POINTER(ctypes.c_uint8)()
    err = ctypes.create_string_buffer(256)
    n = lib.cppf_zstd_decode(data, len(data), max_out, ctypes.byref(out), err, len(err))
    if n < 0:
        raise ValueError(f"zstd: {err.value.decode()}")
    arr = np.empty(n, np.uint8)
    if n:
        ctypes.memmove(arr.ctypes.data, out, n)
    lib.cppf_zstd_release(out)
    return arr


def crc32c(data: bytes) -> int:
    return int(load_zstd().cppf_crc32c(data, len(data)))


class _Reader:
    """Bounds-checked reads from a byte string; an overrun raises."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError(f"{self.what} truncated")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = 0
        for shift in range(0, 70, 7):
            b = self.u8()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
        raise ValueError(f"{self.what}: varint longer than 10 bytes")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _envelope(data: bytes, magic: int, what: str, max_body: int) -> bytes:
    """The body of an OCDBT manifest or node file, checked and decoded."""
    if len(data) < 18:
        raise ValueError(f"{what} truncated")
    r = _Reader(data, what)
    if struct.unpack(">I", r.take(4))[0] != magic:
        raise ValueError(f"{what}: bad magic number")
    if struct.unpack("<Q", r.take(8))[0] != len(data):
        raise ValueError(f"{what}: length field does not match the file (truncated?)")
    if struct.unpack("<I", data[-4:])[0] != crc32c(data[:-4]):
        raise ValueError(f"{what}: CRC-32C mismatch")
    version = r.varint()
    if version != 0:
        raise ValueError(f"{what}: unknown OCDBT version {version}")
    compression = r.varint()
    body = data[r.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd_decompress(body, max_body).tobytes()
    raise ValueError(f"{what}: unknown OCDBT compression id {compression}")


def _data_files(r: _Reader) -> List[str]:
    """A table of data files: each path is its base path + relative path,
    prefix-compressed against the path before it."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)  # base path lengths: the split does not change the path
    paths: List[bytes] = []
    for i in range(n):
        if i and prefix[i] > len(paths[-1]):
            raise ValueError(f"{r.what}: data file prefix longer than the path before it")
        paths.append((paths[-1][:prefix[i]] if i else b"") + r.take(suffix[i]))
    out = []
    for p in paths:
        path = p.decode()
        if os.path.isabs(path) or ".." in path.split("/"):
            raise ValueError(f"{r.what}: data file {path!r} outside the database")
        out.append(path)
    return out


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys: List[bytes] = []
    for i in range(n):
        if i and prefix[i] > len(keys[-1]):
            raise ValueError(f"{r.what}: key prefix longer than the key before it")
        keys.append((keys[-1][:prefix[i]] if i else b"") + r.take(suffix[i]))
    for k, c in zip(keys, common):
        if c > len(k):
            raise ValueError(f"{r.what}: subtree prefix longer than its key")
    return keys, common


class NodeRef(NamedTuple):
    path: str      # data file, relative to the database directory
    offset: int
    length: int


class Database:
    """An OCDBT database directory, read at its latest version."""

    def __init__(self, root: str):
        self.root = root
        self._files: Dict[str, object] = {}
        data = self._read_whole("manifest.ocdbt")
        r = _Reader(_envelope(data, MANIFEST_MAGIC, "OCDBT manifest", MAX_MANIFEST_BYTES),
                    "OCDBT manifest")
        r.take(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"OCDBT manifest kind {kind} (numbered manifests) is not read")
        r.varint()  # max inline value bytes
        self.max_node_bytes = r.varint()
        r.u8()  # version tree arity log2
        compression = r.varint()
        if compression == 1:
            r.take(4)  # zstd level
        elif compression != 0:
            raise ValueError(f"OCDBT config compression id {compression}")
        files = _data_files(r)
        n = r.varint()
        gen, height = r.varints(n), [r.u8() for _ in range(n)]
        fid, offset, length = r.varints(n), r.varints(n), r.varints(n)
        self.root_ref: Optional[NodeRef] = None
        self.root_height = 0
        if n:
            i = max(range(n), key=gen.__getitem__)
            if length[i]:
                if fid[i] >= len(files):
                    raise ValueError("OCDBT manifest: data file id out of range")
                self.root_ref = NodeRef(files[fid[i]], offset[i], length[i])
                self.root_height = height[i]

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _read_whole(self, rel: str) -> bytes:
        path = os.path.join(self.root, rel)
        if not os.path.isfile(path):
            raise ValueError(f"missing OCDBT file {path}")
        with open(path, "rb") as f:
            return f.read()

    def read_range(self, ref: NodeRef) -> bytes:
        f = self._files.get(ref.path)
        if f is None:
            path = os.path.join(self.root, ref.path)
            if not os.path.isfile(path):
                raise ValueError(f"missing data file {path}")
            f = self._files[ref.path] = open(path, "rb")
        f.seek(ref.offset)
        data = f.read(ref.length)
        if len(data) != ref.length:
            raise ValueError(f"data file {ref.path} shorter than a reference into it")
        return data

    def items(self) -> Dict[bytes, object]:
        """Every key of the database → its value: inline bytes, or the
        :class:`NodeRef` of an indirect value."""
        out: Dict[bytes, object] = {}
        if self.root_ref is not None:
            self._walk(self.root_ref, self.root_height, b"", out)
        return out

    def _walk(self, ref: NodeRef, height: int, prefix: bytes, out: Dict[bytes, object]) -> None:
        what = f"OCDBT node {ref.path}@{ref.offset}"
        r = _Reader(_envelope(self.read_range(ref), NODE_MAGIC, what, self.max_node_bytes), what)
        if r.u8() != height:
            raise ValueError(f"{what}: height differs from its reference")
        files = _data_files(r)
        n = r.varint()
        keys, common = _keys(r, n, interior=height > 0)

        def refs(k: int) -> List[NodeRef]:
            fid, offset = r.varints(k), r.varints(k)
            if any(f >= len(files) for f in fid):
                raise ValueError(f"{what}: data file id out of range")
            return [NodeRef(files[f], o, 0) for f, o in zip(fid, offset)]

        if height > 0:
            children = refs(n)
            lengths = r.varints(n)
            for _ in range(3):  # key, tree byte and indirect byte counts
                r.varints(n)
            for key, c, child, length in zip(keys, common, children, lengths):
                self._walk(child._replace(length=length), height - 1, prefix + key[:c], out)
            return
        lengths = r.varints(n)
        kinds = r.varints(n)
        if any(k > 1 for k in kinds):
            raise ValueError(f"{what}: unknown value kind {max(kinds)}")
        indirect = iter(refs(sum(kinds)))
        for key, kind, length in zip(keys, kinds, lengths):
            out[prefix + key] = (next(indirect)._replace(length=length) if kind
                                 else r.take(length))
        if r.pos != len(r.data):
            raise ValueError(f"{what}: bytes after its last value")

    def value(self, v) -> bytes:
        return self.read_range(v) if isinstance(v, NodeRef) else v


def _fill(value, dtype: np.dtype):
    if value is None:
        return 0
    if isinstance(value, str):
        return {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}[value]
    return value


def read_zarr(db: Database, items: Dict[bytes, object], name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of the database (``items`` its
    :meth:`Database.items`): its ``.zarray`` and its chunk grid, absent
    chunks at the fill value."""
    key = f"{name}/.zarray".encode()
    if key not in items:
        raise ValueError(f"no array {name!r} in the checkpoint")
    meta = json.loads(db.value(items[key]))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr format {meta.get('zarr_format')}")
    if meta.get("dtype") not in DTYPES:
        raise ValueError(f"{name}: zarr dtype {meta.get('dtype')!r}")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{name}: zarr order {meta['order']!r}")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filter {meta['filters'][0].get('id')!r}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: zarr compressor {comp.get('id')!r}")
    sep = meta.get("dimension_separator", ".")
    dtype = np.dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise ValueError(f"{name}: zarr chunks {chunks} do not fit shape {shape}")
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = tuple(-(-s // c) for s, c in zip(shape, chunks))
    out = None
    for idx in np.ndindex(*grid):
        ckey = f"{name}/{sep.join(map(str, idx)) if idx else '0'}".encode()
        if ckey not in items:
            continue
        raw = db.value(items[ckey])
        flat = (zstd_decompress(raw, chunk_bytes) if comp is not None
                else np.frombuffer(raw, np.uint8).copy())
        if flat.size != chunk_bytes:
            raise ValueError(f"{name}: chunk {idx} holds {flat.size} bytes, not {chunk_bytes}")
        block = flat.view(dtype).reshape(chunks)
        if chunks == shape:  # one chunk is the whole array
            return block
        if out is None:
            out = np.full(shape, _fill(meta.get("fill_value"), dtype), dtype)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out if out is not None else np.full(shape, _fill(meta.get("fill_value"), dtype),
                                               dtype)


def restore_numpy(path: str):
    """The checkpoint at ``path`` as nested dicts (dict keys) and lists
    (sequence indices) of numpy arrays, None where orbax stored none, in the
    leaf order of its ``_METADATA``: what the JAX package's
    ``_restore_numpy`` returns."""
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise ValueError(f"no orbax _METADATA in {path}")
    with open(meta_path) as f:
        meta = json.load(f)
    if "tree_metadata" not in meta:
        raise ValueError(f"{meta_path}: no tree_metadata (an older orbax layout)")
    if not meta.get("use_ocdbt", True):
        raise ValueError(f"{path}: a checkpoint without OCDBT (use_ocdbt false) is not read")
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: zarr3 arrays are not read")
    leaves = []
    with Database(path) as db:
        items = db.items()
        for entry in meta["tree_metadata"].values():
            keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
            vtype = entry["value_metadata"]["value_type"]
            if vtype == "None":
                value = None
            elif vtype in ("jax.Array", "np.ndarray"):
                value = read_zarr(db, items, ".".join(k for k, _ in keys))
            else:
                raise ValueError(f"{path}: orbax value type {vtype!r}")
            leaves.append((keys, value))
    return _build_tree(leaves)


def _build_tree(leaves):
    root: dict = {}
    for keys, value in leaves:
        node = root
        for depth, (key, kind) in enumerate(keys):
            if kind not in (1, 2):
                raise ValueError(f"orbax key type {kind}")
            last = depth == len(keys) - 1
            slot = ("seq", int(key)) if kind == 1 else key
            if last:
                node[slot] = value
            else:
                node = node.setdefault(slot, {})
    return _containers(root)


def _containers(node):
    """Dicts keyed by ("seq", i) become lists."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, tuple) for k in node):
        idx = sorted(i for _, i in node)
        if idx != list(range(len(idx))):
            raise ValueError(f"orbax sequence indices {idx} are not 0..{len(idx) - 1}")
        return [_containers(node[("seq", i)]) for i in idx]
    if any(isinstance(k, tuple) for k in node):
        raise ValueError("orbax node mixes dict keys and sequence indices")
    return {k: _containers(v) for k, v in node.items()}
