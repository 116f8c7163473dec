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

Each kernel has a second front end that takes pairs instead of votes
(:func:`bound_projections_pairs`, :func:`refine_window_pairs`,
:func:`dense_hist_pairs`): a ``voting.pair_vote_params`` block [P, 12] and
the grid's frame (:func:`vote_frame`), from which the kernel makes each
vote in registers, so that no [P, R] vote vector exists.  Their plain
version is ``voting.votes_from_pair_params`` followed by the votes' plain
version.

Each wrapper takes the plain PyTorch version (``*_plain``, an
``index_add_`` over the splat taps) for CPU tensors, and launches the CUDA
kernel of ``csrc/vote_hist.cu`` for CUDA tensors — there is no fallback
between the two.  ``LAUNCHES`` counts kernel launches per wrapper.

:func:`sphere_count` launches the axis vote's kernel (``csrc/
sphere_count.cu``) and takes CUDA tensors only: its caller,
``voting.rot_vote_sphere_count``, takes the plain version
(``voting.rot_vote_sphere_count_plain``) for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from cppf_tpu_torch.ops import cuda_build

LAUNCHES = {"bound_projections": 0, "refine_window": 0, "dense_hist": 0,
            "bound_projections_pairs": 0, "refine_window_pairs": 0, "dense_hist_pairs": 0,
            "sphere_count": 0}
SMEM_MAX = 232448  # bytes of shared memory one H100 block may opt in to
_SMEM_FIXED = 256  # a peak kernel's static shared memory (its reduction scratch), rounded up
_STAGE_BYTES = 32 * 52 * 32  # dense_hist_pairs: 32 pairs and their run starts a warp, 32 warps
_SPLATS = ("trilinear", "nearest")
_lib = None
_sphere_lib = None


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
    """Plain version of :func:`bound_projections`.  Sums in the dtype of
    ``w``: float64 fractions and weights give a float64 reference."""
    kw = dict(dtype=w.dtype, device=w.device)
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
    """Plain version of :func:`refine_window`; sums in the dtype of ``w``."""
    win = torch.zeros(w8 * w8 * w8, dtype=w.dtype, device=w.device)
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


def _dense_out(out, cx: int, cy: int, cz: int, device, dtype=torch.float32):
    if out is None:
        return torch.zeros((cx, cy, cz), dtype=dtype, device=device)
    if (out.device != device or out.dtype != dtype or out.shape != (cx, cy, cz)
            or not out.is_contiguous() or out.data_ptr() % 16):
        raise ValueError(f"out must be a contiguous, 16-byte aligned {dtype} [{cx}, {cy}, {cz}] "
                         f"tensor on {device}, got {out.dtype} {tuple(out.shape)} on {out.device}")
    return out


def _check_pools(px: int, py: int, pz: int) -> None:
    if min(px, py, pz) < 1:
        raise ValueError(f"pool factors must be >= 1, got {(px, py, pz)}")


def dense_hist_plain(fx, fy, fz, rx, ry, rz, w, *, cx: int, cy: int, cz: int, px: int = 1,
                     py: int = 1, pz: int = 1, splat: str = "trilinear", out=None):
    """Plain version of :func:`dense_hist`; sums in the dtype of ``w``."""
    out = _dense_out(out, cx, cy, cz, w.device, w.dtype)
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


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``csrc/vote_hist.cu``."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cppf_bound_projections.argtypes = [p] * 7 + [ll] + [i] * 7 + [p, p]
    lib.cppf_refine_window.argtypes = [p] * 8 + [ll, i, i, p, p]
    lib.cppf_bound_projections_pairs.argtypes = [p, ll, i, p] + [i] * 8 + [p, p]
    lib.cppf_refine_window_pairs.argtypes = [p, p, ll, i, p] + [i] * 5 + [p, p]
    lib.cppf_dense_hist.argtypes = [p] * 7 + [ll] + [i] * 7 + [p, p]
    lib.cppf_dense_hist_pairs.argtypes = [p, ll, i, p] + [i] * 10 + [p, p]
    for fn in (lib.cppf_bound_projections, lib.cppf_refine_window,
               lib.cppf_bound_projections_pairs, lib.cppf_refine_window_pairs,
               lib.cppf_dense_hist, lib.cppf_dense_hist_pairs):
        fn.restype = i
    lib.cppf_error_string.argtypes = [i]
    lib.cppf_error_string.restype = ctypes.c_char_p
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = _bind(cuda_build.load("vote_hist"))
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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` at an address the kernels' 16-byte loads accept (a fresh tensor
    always is; a slice that starts mid-row is copied)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, *args) -> None:
    """Call the C entry point ``cppf_<name>`` with ``args`` (the output tensor
    last) and the current stream; raise unless it launched, else count it."""
    lib = _library()
    *head, out = args
    rc = getattr(lib, "cppf_" + name)(*head, out.data_ptr(),
                             torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.cppf_error_string(rc).decode()}")
    LAUNCHES[name] += 1


def _projection_views(out, gx, gy, by_n, bz_n):
    n_xy, n_xz = gx * by_n, gx * bz_n
    return (out[:n_xy].view(gx, by_n), out[n_xy:n_xy + n_xz].view(gx, bz_n),
            out[n_xy + n_xz:].view(gy, bz_n))


def _projection_buffer(gx, gy, by_n, bz_n, extra_bytes, device):
    n = gx * by_n + gx * bz_n + gy * bz_n
    if 4 * n + extra_bytes > SMEM_MAX:
        raise ValueError(f"projections of {gx}x{gy} rows by {by_n}+{bz_n} columns do not "
                         f"fit one block's {SMEM_MAX} bytes of shared memory")
    return torch.zeros(n, dtype=torch.float32, device=device)


def bound_projections(fx, fy, fz, rx, ry, rz, w, *, gx: int, gy: int, by_n: int,
                      bz_n: int, pfy: int, pfz: int, splat: str = "trilinear"):
    """(Mxy [gx, by_n], Mxz [gx, bz_n], Myz [gy, bz_n]) of the vote splat."""
    _check_votes(fx, fy, fz, rx, ry, rz, w, splat)
    if w.device.type == "cpu":
        return bound_projections_plain(fx, fy, fz, rx, ry, rz, w, gx=gx, gy=gy, by_n=by_n,
                                       bz_n=bz_n, pfy=pfy, pfz=pfz, splat=splat)
    out = _projection_buffer(gx, gy, by_n, bz_n, _SMEM_FIXED, w.device)
    if w.shape[0]:
        votes = [_aligned(t) for t in (fx, fy, fz, rx, ry, rz, w)]
        _launch("bound_projections", *(t.data_ptr() for t in votes),
                w.shape[0], gx, gy, by_n, bz_n, pfy, pfz, int(splat == "nearest"), out)
    return _projection_views(out, gx, gy, by_n, bz_n)


def _check_origin(o, device):
    if o.device != device or o.dtype != torch.int32 or o.shape != (3,):
        raise ValueError(f"o must be an int32 [3] tensor on {device}")


def refine_window(o, fx, fy, fz, rx, ry, rz, w, *, w8: int = 16, splat: str = "trilinear"):
    """Exact fine counts [w8, w8·w8] in the window at origin ``o``."""
    _check_votes(fx, fy, fz, rx, ry, rz, w, splat)
    _check_origin(o, w.device)
    if w.device.type == "cpu":
        return refine_window_plain(o, fx, fy, fz, rx, ry, rz, w, w8=w8, splat=splat)
    if 4 * w8 ** 3 + _SMEM_FIXED > SMEM_MAX:
        raise ValueError(f"a {w8}^3 window does not fit one block's shared memory")
    o = o.contiguous()
    out = torch.zeros(w8 * w8 * w8, dtype=torch.float32, device=w.device)
    if w.shape[0]:
        votes = [_aligned(t) for t in (fx, fy, fz, rx, ry, rz, w)]
        _launch("refine_window", o.data_ptr(),
                *(t.data_ptr() for t in votes), w.shape[0], w8, int(splat == "nearest"), out)
    return out.view(w8, w8 * w8)


def vote_frame(corner, res, dims_f) -> torch.Tensor:
    """The grid's frame as the pairs front ends read it: float32 [7] =
    corner [3] | res | runtime grid dims [3], on the corner's device (built
    there: nothing is read to the host)."""
    res = torch.as_tensor(res, dtype=torch.float32, device=corner.device)
    return torch.cat([corner.reshape(3).float(), res.reshape(1), dims_f.reshape(3).float()])


def _table_bytes(n_rots: int) -> int:
    """Shared memory of the pairs kernels' circle table: (cos, sin) of every
    angle i·2π/m, m ≤ n_rots, i < m."""
    return 4 * n_rots * (n_rots + 1)


def _check_pairs(params, frame, grid_shape, n_rots, splat):
    if splat not in _SPLATS:
        raise ValueError(f"splat must be one of {_SPLATS}, got {splat!r}")
    if (params.dtype != torch.float32 or params.dim() != 2 or params.shape[1] != 12
            or not params.is_contiguous()):
        raise ValueError(f"params must be a contiguous float32 [P, 12] block, got "
                         f"{params.dtype} {tuple(params.shape)}")
    if (frame.device != params.device or frame.dtype != torch.float32 or frame.shape != (7,)
            or not frame.is_contiguous()):
        raise ValueError(f"frame must be a contiguous float32 [7] tensor on {params.device}")
    if params.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {params.device}")
    if len(grid_shape) != 3 or min(grid_shape) < 2 or n_rots < 1:
        raise ValueError(f"bad grid shape {grid_shape} or rotation count {n_rots}")
    if _table_bytes(n_rots) + _STAGE_BYTES + _SMEM_FIXED > SMEM_MAX:
        raise ValueError(f"the circle table of {n_rots} rotations does not fit one block's "
                         f"shared memory")


def _plain_votes(params, frame, grid_shape, n_rots):
    from cppf_tpu_torch.ops.voting import votes_from_pair_params  # voting imports this module

    f, r, w = votes_from_pair_params(params, frame[:3], frame[3], frame[4:], grid_shape, n_rots)
    return [a.reshape(-1) for a in (*f, *r, w)]


def bound_projections_pairs(params, frame, *, n_rots: int, grid_shape, by_n: int, bz_n: int,
                            pfy: int, pfz: int, splat: str = "trilinear"):
    """:func:`bound_projections` of the votes of a ``pair_vote_params`` block
    in the grid ``frame`` (:func:`vote_frame`), without the votes: the kernel
    makes them in registers."""
    _check_pairs(params, frame, grid_shape, n_rots, splat)
    gx, gy, gz = grid_shape
    kw = dict(gx=gx, gy=gy, by_n=by_n, bz_n=bz_n, pfy=pfy, pfz=pfz, splat=splat)
    if params.device.type == "cpu":
        return bound_projections_plain(*_plain_votes(params, frame, grid_shape, n_rots), **kw)
    out = _projection_buffer(gx, gy, by_n, bz_n, _SMEM_FIXED + _table_bytes(n_rots),
                             params.device)
    if params.shape[0]:
        params = _aligned(params)
        _launch("bound_projections_pairs", params.data_ptr(),
                params.shape[0], n_rots, frame.data_ptr(), gx, gy, gz, by_n, bz_n, pfy, pfz,
                int(splat == "nearest"), out)
    return _projection_views(out, gx, gy, by_n, bz_n)


def window_cull_plain(params, frame, o, w8: int) -> torch.Tensor:
    """[P] bool: False for the pairs the window kernel skips before it makes
    a vote.  A pair's votes lie on an ellipse about ``c`` with semi-axes
    ``|x|`` and ``|y|``; the votes that reach the window have coordinates in
    ``[o-1, o+w8)``, a box of half diagonal ``√3/2·(w8+1)`` voxels about
    ``o + (w8-1)/2``.  With one more voxel of margin, a pair whose shell
    ``min(|x|,|y|) ≤ distance ≤ max(|x|,|y|)`` misses the ball around that
    box casts nothing into the window."""
    corner, res = frame[:3], frame[3]
    centre = corner + (o.to(torch.float32) + 0.5 * (w8 - 1)) * res
    reach = (0.8660254 * (w8 + 1) + 1.0) * res
    d = torch.linalg.norm(params[:, 2:5] - centre, dim=-1)
    rx = torch.linalg.norm(params[:, 5:8], dim=-1)
    ry = torch.linalg.norm(params[:, 8:11], dim=-1)
    return (d - reach <= torch.maximum(rx, ry)) & (d + reach >= torch.minimum(rx, ry))


def refine_window_pairs(o, params, frame, *, n_rots: int, grid_shape, w8: int = 16,
                        splat: str = "trilinear"):
    """:func:`refine_window` of the votes of a ``pair_vote_params`` block,
    without the votes.  Pairs that :func:`window_cull_plain` drops are
    skipped before any vote is made."""
    _check_pairs(params, frame, grid_shape, n_rots, splat)
    _check_origin(o, params.device)
    if params.device.type == "cpu":
        culled = params.clone()
        culled[:, 0] = torch.where(window_cull_plain(params, frame, o, w8), params[:, 0], 0.0)
        return refine_window_plain(o, *_plain_votes(culled, frame, grid_shape, n_rots), w8=w8,
                                   splat=splat)
    if 4 * w8 ** 3 + _SMEM_FIXED + _table_bytes(n_rots) > SMEM_MAX:
        raise ValueError(f"a {w8}^3 window does not fit one block's shared memory")
    o = o.contiguous()
    out = torch.zeros(w8 * w8 * w8, dtype=torch.float32, device=params.device)
    if params.shape[0]:
        params = _aligned(params)
        _launch("refine_window_pairs", o.data_ptr(),
                params.data_ptr(), params.shape[0], n_rots, frame.data_ptr(), *grid_shape, w8,
                int(splat == "nearest"), out)
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
    _check_pools(px, py, pz)
    out = _dense_out(out, cx, cy, cz, w.device)
    if w.device.type == "cpu":
        return dense_hist_plain(fx, fy, fz, rx, ry, rz, w, cx=cx, cy=cy, cz=cz, px=px, py=py,
                                pz=pz, splat=splat, out=out)
    if w.shape[0]:
        _launch("dense_hist", fx.data_ptr(), fy.data_ptr(), fz.data_ptr(),
                rx.data_ptr(), ry.data_ptr(), rz.data_ptr(), w.data_ptr(), w.shape[0], cx, cy, cz,
                px, py, pz, int(splat == "nearest"), out)
    return out


def dense_hist_pairs(params, frame, *, n_rots: int, grid_shape, cx: int, cy: int, cz: int,
                     px: int = 1, py: int = 1, pz: int = 1, splat: str = "trilinear", out=None):
    """:func:`dense_hist` of the votes of a ``pair_vote_params`` block in the
    fine grid ``grid_shape`` with frame ``frame`` (:func:`vote_frame`),
    without the votes: the kernel makes them in registers.  The cells must
    cover the pooled fine grid, ``c_k >= ceil(g_k / p_k)``; the sums are
    added into ``out`` as :func:`dense_hist` adds them."""
    _check_pairs(params, frame, grid_shape, n_rots, splat)
    _check_pools(px, py, pz)
    if any(c < -(-g // p) for c, g, p in zip((cx, cy, cz), grid_shape, (px, py, pz))):
        raise ValueError(f"cells {(cx, cy, cz)} do not cover the grid {tuple(grid_shape)} "
                         f"pooled by {(px, py, pz)}")
    out = _dense_out(out, cx, cy, cz, params.device)
    if params.device.type == "cpu":
        return dense_hist_plain(*_plain_votes(params, frame, grid_shape, n_rots), cx=cx, cy=cy,
                                cz=cz, px=px, py=py, pz=pz, splat=splat, out=out)
    if params.shape[0]:
        params = _aligned(params)
        _launch("dense_hist_pairs", params.data_ptr(), params.shape[0], n_rots,
                frame.data_ptr(), *grid_shape, cx, cy, cz, px, py, pz, int(splat == "nearest"), out)
    return out


def _sphere_library():
    global _sphere_lib
    if _sphere_lib is None:
        lib = cuda_build.load("sphere_count")
        p = ctypes.c_void_p
        lib.cppf_sphere_count.argtypes = [p, ctypes.c_longlong, ctypes.c_int, p, p, ctypes.c_int,
                                          ctypes.c_float, p, p, p]
        lib.cppf_sphere_count.restype = ctypes.c_int
        lib.cppf_error_string.argtypes = [ctypes.c_int]
        lib.cppf_error_string.restype = ctypes.c_char_p
        _sphere_lib = lib
    return _sphere_lib


def fixed_shift(weights: torch.Tensor, n_terms: int) -> torch.Tensor:
    """int32 0-d ``k`` on the weights' device with ``max|w|·2^k·n_terms``
    in [2^60, 2^62) (``k = 62 - n_terms.bit_length()`` for zero weights), so
    that ``n_terms`` weights, each rounded to whole units of 2^-k, sum
    inside int64 with 2^60 / n_terms units to the largest weight."""
    return (62 - int(n_terms).bit_length()) - torch.frexp(weights.abs().max()).exponent


def sphere_count(pairs, table, sphere, cos_tol, *, weighted: bool = False) -> torch.Tensor:
    """Counts float32 [S] of the cone axes of a ``voting.sphere_pair_params``
    block [P, 12] with the rotation table ``table`` [2, R] (cos, sin of
    i·2π/R) on the directions ``sphere`` [S, 3] within ``cos_tol`` (a
    number, compared in float32), made and tested in registers by one
    kernel launch.  Unweighted counts are whole numbers summed in int32;
    ``weighted`` sums column 11 of each hit in int64 fixed point
    (:func:`fixed_shift`)."""
    for name, t, shape, fits in (("pairs", pairs, "[P, 12]", pairs.shape[-1:] == (12,)),
                                 ("table", table, "[2, R]", table.shape[:1] == (2,)),
                                 ("sphere", sphere, "[S, 3]", sphere.shape[-1:] == (3,))):
        if t.device != pairs.device:
            raise ValueError(f"{name} on {t.device}, pairs on {pairs.device}")
        if t.dtype != torch.float32 or t.dim() != 2 or not fits or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {shape} tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if pairs.device.type != "cuda":
        raise ValueError(f"sphere_count launches a CUDA kernel; on {pairs.device} take "
                         f"voting.rot_vote_sphere_count_plain")
    n_pairs, n_rots, n_sphere = pairs.shape[0], table.shape[1], sphere.shape[0]
    if n_rots < 1:
        raise ValueError("the rotation table is empty")
    shift = fixed_shift(pairs[:, 11], n_pairs * n_rots) if weighted and n_pairs else None
    out = torch.zeros(n_sphere, dtype=torch.int64 if weighted else torch.int32,
                      device=pairs.device)
    if n_pairs:
        lib = _sphere_library()
        pairs = _aligned(pairs)
        rc = lib.cppf_sphere_count(pairs.data_ptr(), n_pairs, n_rots, table.data_ptr(),
                                   sphere.data_ptr(), n_sphere, float(cos_tol),
                                   None if shift is None else shift.data_ptr(), out.data_ptr(),
                                   torch.cuda.current_stream(out.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"sphere_count launch failed: {lib.cppf_error_string(rc).decode()}")
        LAUNCHES["sphere_count"] += 1
    if shift is not None:
        return torch.ldexp(out.to(torch.float64), -shift.to(torch.float64)).to(torch.float32)
    return out.to(torch.float32)
