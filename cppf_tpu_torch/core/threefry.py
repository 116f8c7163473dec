"""JAX's default random numbers, reproduced in torch.

``jax.random`` with its default generator (threefry2x32, with the
partitionable bit layout of ``jax_threefry_partitionable``, the default
since JAX 0.5): element ``i`` of a draw of shape ``s`` from key ``(k1, k2)``
is the xor of the two words of threefry2x32((k1, k2), (i >> 32, i & 0xffffffff)),
i the row-major index; ``split`` hashes the counters 0..n-1 the same way
and keeps both words.  Uniform floats take the top 23 bits as a mantissa in
[1, 2), minus 1.  The bits and uniforms are exact on every device; the
gumbel transform goes through torch's ``log`` and the normal one through
XLA's float32 polynomial for erfinv (:func:`erfinv`), each of which can
differ from XLA's in the last bit.

A key is a pair of Python ints.  This lets the port consume the very draws
that a JAX run consumed from the same key (``PoseDraws.from_jax_key``);
:func:`draw_many` makes several draws in one pass of the hash.  On CUDA
tensors that pass is one launch of ``csrc/threefry_draws.cu`` (a table of
up to ``MAX_REQUESTS`` requests a launch, given by value: no upload and no
host sync), whose floats equal :func:`draw_many_plain`'s on the same card to
the bit; everywhere else it is :func:`draw_many_plain`, int64 PyTorch.
``LAUNCHES["draws"]`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from cppf_tpu_torch.ops import cuda_build
from cppf_tpu_torch.utils import prof

Key = Tuple[int, int]
_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
MAX_REQUESTS = 64  # rows of one launch's table (csrc/threefry_draws.cu kMaxRequests)
LAUNCHES = {"draws": 0}
_lib = None


def key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^32) (JAX's default
    32-bit mode)."""
    return 0, seed & _MASK


def threefry2x32(k: Key, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter words ``x0``,
    ``x1`` (uint32 values as Python ints or int64 tensors) under key ``k``:
    two ints, or two int64 tensors that give each counter its own key."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for r in range(5):
        for rot in _ROTATIONS[r % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << rot) | (x1 >> (32 - rot))) & _MASK
            x1 = x0 ^ x1
        x0 = (x0 + ks[(r + 1) % 3]) & _MASK
        x1 = (x1 + ks[(r + 2) % 3] + r + 1) & _MASK
    return x0, x1


def split(k: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(key, num)``, hashed in Python ints (a few keys:
    cheaper than tensor operations)."""
    return [threefry2x32(k, i >> 32, i & _MASK) for i in range(num)]


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``: the hash of
    the counter words (0, data)."""
    return threefry2x32(k, 0, data & _MASK)


# the float32 [lo, hi) of each kind's uniform
_LO_HI = {"uniform": (0.0, 1.0), "bernoulli": (0.0, 1.0),
          "gumbel": (float(torch.finfo(torch.float32).tiny), 1.0),
          "normal": (float(np.nextafter(np.float32(-1.0), np.float32(0.0))), 1.0)}


def _uniform(bits: torch.Tensor, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 from 32 random bits an element."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    prof.host_sync(bits.device, n=2)  # the uploads of lo and hi
    return torch.maximum(lo, floats * (hi - lo) + lo)


def _gumbel(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.gumbel`` (its default "low" mode) in float32."""
    return -torch.log(-torch.log(_uniform(bits, *_LO_HI["gumbel"])))


def _normal(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal`` in float32: √2 · erfinv(u), u uniform on
    (-1, 1)."""
    prof.host_sync(bits.device)  # the upload of √2
    return (torch.tensor(math.sqrt(2), dtype=torch.float32, device=bits.device)
            * erfinv(_uniform(bits, *_LO_HI["normal"])))


# XLA's float32 ErfInv: Giles' single-precision approximation, a degree-8
# polynomial in w - 2.5 (w = -log(1 - x²) < 5) or in sqrt(w) - 3
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """Inverse error function of float32 ``x`` in (-1, 1), as XLA computes
    it (torch.erfinv is another approximation, ~1e-5 apart)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.full_like(x, _ERFINV_GE5[0]).masked_fill_(lt, _ERFINV_LT5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return p * x


def _bernoulli(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.bernoulli`` at p = ½ (the trainer's random normal
    signs): a uniform below ½."""
    return _uniform(bits) < 0.5


_KINDS = {"uniform": _uniform, "gumbel": _gumbel, "normal": _normal, "bernoulli": _bernoulli}


def draw_many(requests, device) -> List[torch.Tensor]:
    """Several draws, each ``(kind, key, shape)`` with kind ``"uniform"``,
    ``"gumbel"``, ``"normal"`` or ``"bernoulli"`` (p = ½), from one pass of
    the hash over all their counters, each counter with its own draw's key:
    float32 tensors (bool for bernoulli) of the requests' shapes, in their
    order.  On a CUDA device one launch of ``csrc/threefry_draws.cu`` a
    ``MAX_REQUESTS`` requests, equal to :func:`draw_many_plain` to the bit;
    elsewhere :func:`draw_many_plain`."""
    if torch.device(device).type == "cuda":
        return _draw_many_cuda(requests, device)
    return draw_many_plain(requests, device)


def draw_many_plain(requests, device) -> List[torch.Tensor]:
    """Plain version of :func:`draw_many`, on any device: the hash in int64
    tensors, in one set of launches for all the requests.  Equal element
    for element to the draws made one at a time (the hash is elementwise)."""
    sizes = [math.prod(shape) for _, _, shape in requests]
    prof.host_sync(device, n=2)  # the uploads of the keys and the sizes
    keys = torch.repeat_interleave(
        torch.tensor([k for _, k, _ in requests], dtype=torch.int64, device=device),
        torch.tensor(sizes, device=device), dim=0, output_size=sum(sizes))
    i = torch.cat([torch.arange(n, dtype=torch.int64, device=device) for n in sizes])
    b0, b1 = threefry2x32((keys[:, 0], keys[:, 1]), i >> 32, i & _MASK)
    return [_KINDS[kind](bits.reshape(shape))
            for (kind, _, shape), bits in zip(requests, (b0 ^ b1).split(sizes))]


# the kernel's kind codes (csrc/threefry_draws.cu Kind)
_KIND_CODES = {"uniform": 0, "bernoulli": 0, "gumbel": 1, "normal": 2}


class DrawTable(NamedTuple):
    """The kernel's request table: row ``r`` is request ``order[r]``, and
    owns the elements ``[starts[r], starts[r + 1])`` of the flat output.
    The bernoulli requests come last, so that one comparison with ½ makes
    all their booleans."""

    order: List[int]     # row → index of the request
    starts: np.ndarray   # int64 [n + 1]
    keys: np.ndarray     # uint32 [n, 2]
    kinds: np.ndarray    # int32 [n], _KIND_CODES
    lo: np.ndarray       # float32 [n]
    hi: np.ndarray       # float32 [n]
    n_float: int         # rows before the first bernoulli one


def draw_table(requests) -> DrawTable:
    """The request table of :func:`draw_many`'s CUDA route (host memory:
    the launch takes it by value)."""
    for kind, _, _ in requests:
        if kind not in _KIND_CODES:
            raise ValueError(f"unknown draw kind {kind!r}; one of {sorted(_KIND_CODES)}")
    order = sorted(range(len(requests)), key=lambda j: requests[j][0] == "bernoulli")
    rows = [requests[j] for j in order]
    starts = np.zeros(len(rows) + 1, np.int64)
    starts[1:] = np.cumsum([math.prod(shape) for _, _, shape in rows], dtype=np.int64)
    keys = np.array([k for _, k, _ in rows], np.uint32).reshape(len(rows), 2)
    kinds = np.array([_KIND_CODES[kind] for kind, _, _ in rows], np.int32)
    lo = np.array([_LO_HI[kind][0] for kind, _, _ in rows], np.float32)
    hi = np.array([_LO_HI[kind][1] for kind, _, _ in rows], np.float32)
    n_float = sum(kind != "bernoulli" for kind, _, _ in rows)
    return DrawTable(order, starts, keys, kinds, lo, hi, n_float)


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("threefry_draws")
        p = ctypes.c_void_p
        lib.cppf_threefry_draws.argtypes = [ctypes.c_int, p, p, p, p, p, p, p]
        lib.cppf_threefry_draws.restype = ctypes.c_int
        lib.cppf_error_string.argtypes = [ctypes.c_int]
        lib.cppf_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _draw_many_cuda(requests, device) -> List[torch.Tensor]:
    """:func:`draw_many` on a CUDA device: every float written once into one
    flat buffer by one launch a ``MAX_REQUESTS`` rows of the table, the
    bernoulli rows compared with ½ at once; the draws are views."""
    t = draw_table(requests)
    out = torch.empty(int(t.starts[-1]), dtype=torch.float32, device=device)
    lib = _library()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    for a in range(0, len(t.order), MAX_REQUESTS):
        b = min(a + MAX_REQUESTS, len(t.order))
        base = int(t.starts[a])
        if int(t.starts[b]) == base:
            continue
        starts = t.starts[a:b + 1] - base
        rc = lib.cppf_threefry_draws(b - a, starts.ctypes.data, t.keys[a:b].ctypes.data,
                                     t.kinds[a:b].ctypes.data, t.lo[a:b].ctypes.data,
                                     t.hi[a:b].ctypes.data, out.data_ptr() + 4 * base, stream)
        if rc != 0:
            raise RuntimeError("threefry_draws launch failed: "
                               + lib.cppf_error_string(rc).decode())
        LAUNCHES["draws"] += 1
        prof.device_count("draw_kernel_launches", 1)
    split = int(t.starts[t.n_float])
    flags = out[split:] < 0.5 if t.n_float < len(t.order) else None
    draws = [None] * len(requests)
    for r, j in enumerate(t.order):
        lo, hi = int(t.starts[r]), int(t.starts[r + 1])
        flat = out[lo:hi] if r < t.n_float else flags[lo - split:hi - split]
        draws[j] = flat.view(requests[j][2])
    return draws
