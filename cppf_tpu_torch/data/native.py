"""ctypes binding of the native host depth rasterizer
(``native/rasterizer.cpp``; counterpart of cppf_tpu/data/native.py).

The source compiles with ``g++`` and the flags of ``native/Makefile`` at
first use into ``cppf_tpu_torch/_build/`` (listed in .gitignore), the
library named by a hash of the source and flags, so an edited source
rebuilds.  Nothing builds at import.  A failed build raises: the renders
of the training stream must be the native ones, never a slower numpy
stand-in chosen quietly.  ``rasterize_depth_np`` is the plain version the
tests hold the library to.  The voxel hash of ``native/voxel.cpp`` has its
port in ``ops/quantize.py::voxel_downsample_host``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

from cppf_tpu_torch.config import REPO_ROOT
from cppf_tpu_torch.ops.cuda_build import BUILD

NATIVE_DIR = os.path.join(REPO_ROOT, "native")
SOURCES = ("rasterizer.cpp",)
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-march=native", "-shared")

_lib: Optional[ctypes.CDLL] = None


def host_library_path(stem: str, sources: Sequence[str], flags: Sequence[str]) -> str:
    """Where the library ``lib<stem>`` of ``sources`` built with ``flags``
    goes: ``_build/lib<stem>-<hash of the flags and sources>.so``."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def build_host_library(stem: str, sources: Sequence[str], flags: Sequence[str]) -> str:
    """Compile ``sources`` with ``g++`` unless an up-to-date library exists;
    returns its path.  Raises ``RuntimeError`` with the compiler's output
    when ``g++`` fails or is missing."""
    path = host_library_path(stem, sources, flags)
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", *flags, "-o", tmp, *sources]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: lib{stem} cannot be built") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for lib{stem}:\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def library_path() -> str:
    return host_library_path("cppf_native", [os.path.join(NATIVE_DIR, n) for n in SOURCES],
                             CXX_FLAGS)


def build() -> str:
    """Compile the rasterizer unless an up-to-date library exists; returns
    its path.  Raises ``RuntimeError`` with the compiler's output when
    ``g++`` fails."""
    return build_host_library("cppf_native", [os.path.join(NATIVE_DIR, n) for n in SOURCES],
                              CXX_FLAGS)


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.rasterize_depth.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.rasterize_depth.restype = None
        _lib = lib
    return _lib


def rasterize_depth(verts: np.ndarray, tris: np.ndarray, fx: float, fy: float,
                    cx: float, cy: float, width: int, height: int) -> np.ndarray:
    """Depth map [H, W] (0 = background) of camera-space triangles: the
    camera looks down −z, a point projects to u = cx + fx·x/d,
    v = cy − fy·y/d with d = −z, and the buffer keeps the nearest d."""
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    if tris.size and (tris.min() < 0 or tris.max() >= len(verts)):
        raise ValueError("triangle index out of range")
    depth = np.zeros(height * width, np.float32)
    load().rasterize_depth(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(verts),
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(tris),
        fx, fy, cx, cy, width, height,
        depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return depth.reshape(height, width)


def rasterize_depth_np(verts, tris, fx, fy, cx, cy, width, height) -> np.ndarray:
    """Plain numpy version of :func:`rasterize_depth`, a triangle at a time."""
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    depth = np.full((height, width), np.inf, np.float32)
    p = verts[tris]                      # [T, 3, 3]
    d = -p[..., 2]
    ok = np.all(d > 1e-6, axis=-1)
    p, d = p[ok], d[ok]
    u = cx + fx * p[..., 0] / d
    v = cy - fy * p[..., 1] / d
    inv_d = 1.0 / d
    for t in range(len(p)):
        xmin = max(0, int(np.floor(u[t].min())))
        xmax = min(width - 1, int(np.ceil(u[t].max())))
        ymin = max(0, int(np.floor(v[t].min())))
        ymax = min(height - 1, int(np.ceil(v[t].max())))
        if xmin > xmax or ymin > ymax:
            continue
        xs, ys = np.meshgrid(np.arange(xmin, xmax + 1) + 0.5, np.arange(ymin, ymax + 1) + 0.5)
        u0, v0 = u[t, 0], v[t, 0]
        u1, v1 = u[t, 1], v[t, 1]
        u2, v2 = u[t, 2], v[t, 2]
        area = (u1 - u0) * (v2 - v0) - (v1 - v0) * (u2 - u0)
        if abs(area) < 1e-12:
            continue
        w0 = ((u2 - u1) * (ys - v1) - (v2 - v1) * (xs - u1)) / area
        w1 = ((u0 - u2) * (ys - v2) - (v0 - v2) * (xs - u2)) / area
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        dd = 1.0 / (w0 * inv_d[t, 0] + w1 * inv_d[t, 1] + w2 * inv_d[t, 2])
        sub = depth[ymin: ymax + 1, xmin: xmax + 1]
        np.minimum(sub, np.where(inside, dd, np.inf), out=sub)
    depth[np.isinf(depth)] = 0.0
    return depth

