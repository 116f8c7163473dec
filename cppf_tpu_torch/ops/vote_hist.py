"""The center-vote peak's accumulation kernels (counterpart of
cppf_tpu/ops/pallas/vote_hist.py).

Inputs are flat [V] vote vectors from ``voting._vote_coords``: floors
``fx, fy, fz`` (int32, clipped to [0, g-2]), fractions ``rx, ry, rz`` and
weight ``w`` (float32, 0 for a masked vote).  The splat is separable,
``hat_x ⊗ hat_y ⊗ hat_z``: two taps an axis, ``(f, 1-r)`` and ``(f+1, r)``,
for ``"trilinear"``; one, ``f + (r > 0.5)``, for ``"nearest"``.

- :func:`bound_projections`: the three 2D projections Mxy [gx, by_n],
  Mxz [gx, bz_n], Myz [gy, bz_n] of the splat grid, y/z columns pooled by
  ``pfy``/``pfz``.
- :func:`refine_window`: the exact fine splat mass in the ``w8``³ window at
  origin ``o`` (int32 [3] tensor on the votes' device), as [w8, w8·w8].
- :func:`dense_hist`: the dense splat histogram [cx, cy, cz], each axis
  pooled by an integer factor with exact mass pooling.

Each wrapper takes the plain PyTorch version (``*_plain``, an
``index_add_`` over the splat taps) for CPU tensors, and launches the CUDA
kernel of ``csrc/vote_hist.cu`` for CUDA tensors — there is no fallback
between the two.  ``LAUNCHES`` counts kernel launches per wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from cppf_tpu_torch.ops import cuda_build

LAUNCHES = {"bound_projections": 0, "refine_window": 0, "dense_hist": 0}
SMEM_MAX = 232448  # bytes of shared memory one H100 block may opt in to
_SPLATS = ("trilinear", "nearest")
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _taps(f: torch.Tensor, r: torch.Tensor, splat: str):
    """[(index, weight or None for 1)] along one axis."""
    if splat == "nearest":
        return [(torch.where(r > 0.5, f + 1, f).long(), None)]
    f = f.long()
    return [(f, 1.0 - r), (f + 1, r)]


def _mul(a, b):
    return a if b is None else a * b


def bound_projections_plain(fx, fy, fz, rx, ry, rz, w, *, gx: int, gy: int, by_n: int,
                            bz_n: int, pfy: int, pfz: int, splat: str = "trilinear"):
    """Plain version of :func:`bound_projections`."""
    kw = dict(dtype=torch.float32, device=w.device)
    mxy = torch.zeros(gx * by_n, **kw)
    mxz = torch.zeros(gx * bz_n, **kw)
    myz = torch.zeros(gy * bz_n, **kw)
    tx, ty, tz = _taps(fx, rx, splat), _taps(fy, ry, splat), _taps(fz, rz, splat)
    for ix, hx in tx:
        wx = _mul(w, hx)
        for iy, hy in ty:
            mxy.index_add_(0, ix * by_n + iy // pfy, _mul(wx, hy))
        for iz, hz in tz:
            mxz.index_add_(0, ix * bz_n + iz // pfz, _mul(wx, hz))
    for iy, hy in ty:
        wy = _mul(w, hy)
        for iz, hz in tz:
            myz.index_add_(0, iy * bz_n + iz // pfz, _mul(wy, hz))
    return mxy.view(gx, by_n), mxz.view(gx, bz_n), myz.view(gy, bz_n)


def refine_window_plain(o, fx, fy, fz, rx, ry, rz, w, *, w8: int = 16,
                        splat: str = "trilinear"):
    """Plain version of :func:`refine_window`."""
    win = torch.zeros(w8 * w8 * w8, dtype=torch.float32, device=w.device)
    o = o.long()
    taps = [[(i - o[k], h) for i, h in _taps(f, r, splat)]
            for k, (f, r) in enumerate(((fx, rx), (fy, ry), (fz, rz)))]
    for lx, hx in taps[0]:
        wx = _mul(w, hx)
        for ly, hy in taps[1]:
            for lz, hz in taps[2]:
                ok = ((lx >= 0) & (lx < w8) & (ly >= 0) & (ly < w8)
                      & (lz >= 0) & (lz < w8))
                ids = torch.where(ok, (lx * w8 + ly) * w8 + lz, 0)
                hyz = hy if hz is None else _mul(hz, hy)
                win.index_add_(0, ids, torch.where(ok, _mul(wx, hyz), 0.0))
    return win.view(w8, w8 * w8)


def _dense_out(out, cx: int, cy: int, cz: int, device):
    if out is None:
        return torch.zeros((cx, cy, cz), dtype=torch.float32, device=device)
    if (out.device != device or out.dtype != torch.float32 or out.shape != (cx, cy, cz)
            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 [{cx}, {cy}, {cz}] tensor on "
                         f"{device}, got {out.dtype} {tuple(out.shape)} on {out.device}")
    return out


def dense_hist_plain(fx, fy, fz, rx, ry, rz, w, *, cx: int, cy: int, cz: int, px: int = 1,
                     py: int = 1, pz: int = 1, splat: str = "trilinear", out=None):
    """Plain version of :func:`dense_hist`."""
    out = _dense_out(out, cx, cy, cz, w.device)
    flat = out.view(-1)
    tx, ty, tz = _taps(fx, rx, splat), _taps(fy, ry, splat), _taps(fz, rz, splat)
    for ix, hx in tx:
        wx = _mul(w, hx)
        for iy, hy in ty:
            wxy = _mul(wx, hy)
            row = (ix // px * cy + iy // py) * cz
            for iz, hz in tz:
                flat.index_add_(0, row + iz // pz, _mul(wxy, hz))
    return out


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("vote_hist")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.cppf_bound_projections.argtypes = [p] * 7 + [ll] + [i] * 7 + [p, p]
        lib.cppf_bound_projections.restype = i
        lib.cppf_refine_window.argtypes = [p] * 8 + [ll, i, i, p, p]
        lib.cppf_refine_window.restype = i
        lib.cppf_dense_hist.argtypes = [p] * 7 + [ll] + [i] * 7 + [p, p]
        lib.cppf_dense_hist.restype = i
        lib.cppf_error_string.argtypes = [i]
        lib.cppf_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_votes(fx, fy, fz, rx, ry, rz, w, splat):
    if splat not in _SPLATS:
        raise ValueError(f"splat must be one of {_SPLATS}, got {splat!r}")
    v = fx.shape[0]
    for name, t, dt in (("fx", fx, torch.int32), ("fy", fy, torch.int32),
                        ("fz", fz, torch.int32), ("rx", rx, torch.float32),
                        ("ry", ry, torch.float32), ("rz", rz, torch.float32),
                        ("w", w, torch.float32)):
        if t.device != w.device:
            raise ValueError(f"{name} on {t.device}, w on {w.device}")
        if t.dtype != dt or t.shape != (v,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} vector of length {v}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {w.device}")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.cppf_error_string(rc).decode()}")


def bound_projections(fx, fy, fz, rx, ry, rz, w, *, gx: int, gy: int, by_n: int,
                      bz_n: int, pfy: int, pfz: int, splat: str = "trilinear"):
    """(Mxy [gx, by_n], Mxz [gx, bz_n], Myz [gy, bz_n]) of the vote splat."""
    _check_votes(fx, fy, fz, rx, ry, rz, w, splat)
    if w.device.type == "cpu":
        return bound_projections_plain(fx, fy, fz, rx, ry, rz, w, gx=gx, gy=gy, by_n=by_n,
                                       bz_n=bz_n, pfy=pfy, pfz=pfz, splat=splat)
    n_xy, n_xz, n_yz = gx * by_n, gx * bz_n, gy * bz_n
    if 4 * (n_xy + n_xz + n_yz) > SMEM_MAX:
        raise ValueError(f"projections of {gx}x{gy} rows by {by_n}+{bz_n} columns do not "
                         f"fit one block's {SMEM_MAX} bytes of shared memory")
    out = torch.zeros(n_xy + n_xz + n_yz, dtype=torch.float32, device=w.device)
    if w.shape[0]:
        lib = _library()
        rc = lib.cppf_bound_projections(
            fx.data_ptr(), fy.data_ptr(), fz.data_ptr(), rx.data_ptr(), ry.data_ptr(),
            rz.data_ptr(), w.data_ptr(), w.shape[0], gx, gy, by_n, bz_n, pfy, pfz,
            int(splat == "nearest"), out.data_ptr(),
            torch.cuda.current_stream(w.device).cuda_stream)
        _raise_on(lib, rc, "bound_projections")
        LAUNCHES["bound_projections"] += 1
    return (out[:n_xy].view(gx, by_n), out[n_xy:n_xy + n_xz].view(gx, bz_n),
            out[n_xy + n_xz:].view(gy, bz_n))


def refine_window(o, fx, fy, fz, rx, ry, rz, w, *, w8: int = 16, splat: str = "trilinear"):
    """Exact fine counts [w8, w8·w8] in the window at origin ``o``."""
    _check_votes(fx, fy, fz, rx, ry, rz, w, splat)
    if o.device != w.device or o.dtype != torch.int32 or o.shape != (3,):
        raise ValueError(f"o must be an int32 [3] tensor on {w.device}")
    if w.device.type == "cpu":
        return refine_window_plain(o, fx, fy, fz, rx, ry, rz, w, w8=w8, splat=splat)
    if 4 * w8 ** 3 > SMEM_MAX:
        raise ValueError(f"a {w8}^3 window does not fit one block's shared memory")
    o = o.contiguous()
    out = torch.zeros(w8 * w8 * w8, dtype=torch.float32, device=w.device)
    if w.shape[0]:
        lib = _library()
        rc = lib.cppf_refine_window(
            o.data_ptr(), fx.data_ptr(), fy.data_ptr(), fz.data_ptr(), rx.data_ptr(),
            ry.data_ptr(), rz.data_ptr(), w.data_ptr(), w.shape[0], w8,
            int(splat == "nearest"), out.data_ptr(),
            torch.cuda.current_stream(w.device).cuda_stream)
        _raise_on(lib, rc, "refine_window")
        LAUNCHES["refine_window"] += 1
    return out.view(w8, w8 * w8)


def dense_hist(fx, fy, fz, rx, ry, rz, w, *, cx: int, cy: int, cz: int, px: int = 1,
               py: int = 1, pz: int = 1, splat: str = "trilinear", out=None):
    """Dense splat histogram [cx, cy, cz], axis k pooled by ``p_k``.

    Trilinear taps ``(f, 1-r)`` and ``(f+1, r)`` land in cells ``f // p``
    and ``(f+1) // p`` (exact mass pooling: the result equals pool-summing
    the unpooled histogram); nearest lands ``f + (r > 0.5)``.  The caller
    guarantees ``(f+1) // p < c`` on every axis (floors clipped to g-2 and
    ``c = ceil(g/p)``, as ``ppf_vote_dense`` does).  The sums are added
    into ``out`` in place when it is given (so pair chunks accumulate into
    one grid), else into a new zeroed grid.  Unlike the Pallas kernel, no
    cap on the (y, z) plane: the grid only has to fit device memory.
    """
    _check_votes(fx, fy, fz, rx, ry, rz, w, splat)
    if min(px, py, pz) < 1:
        raise ValueError(f"pool factors must be >= 1, got {(px, py, pz)}")
    out = _dense_out(out, cx, cy, cz, w.device)
    if w.device.type == "cpu":
        return dense_hist_plain(fx, fy, fz, rx, ry, rz, w, cx=cx, cy=cy, cz=cz, px=px, py=py,
                                pz=pz, splat=splat, out=out)
    if w.shape[0]:
        lib = _library()
        rc = lib.cppf_dense_hist(
            fx.data_ptr(), fy.data_ptr(), fz.data_ptr(), rx.data_ptr(), ry.data_ptr(),
            rz.data_ptr(), w.data_ptr(), w.shape[0], cx, cy, cz, px, py, pz,
            int(splat == "nearest"), out.data_ptr(),
            torch.cuda.current_stream(w.device).cuda_stream)
        _raise_on(lib, rc, "dense_hist")
        LAUNCHES["dense_hist"] += 1
    return out
