"""Time the center-vote peak kernels beside another checkout's, on one NVIDIA GPU.

Both front ends (votes, pairs) of ``bound_projections`` and ``refine_window``
of ``cppf_tpu_torch`` run on the bowl main path's own inputs (100 000 pairs,
72 rotations, 64³), on the same pairs with adaptive rotations, and on the
same pairs in bottle's pooled 120³ grid.  With ``--earlier DIR`` both front
ends of ``DIR/cppf_tpu_torch/csrc/vote_hist.cu`` (another checkout, whose
four entry points take the same arguments) join them.
Every kernel is first held against the plain version (1e-3 of the maximum),
then all are timed in turns (a, b, c, a, b, c, ...) by CUDA events, device
time only, median of 25, so that clocks and neighbours treat them alike.

Usage: python scripts/time_vote_kernels.py [--earlier DIR]
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from cppf_tpu_torch.ops import cuda_build  # noqa: E402
from cppf_tpu_torch.ops import vote_hist as vh  # noqa: E402
from cppf_tpu_torch.ops.voting import _poolf  # noqa: E402

W8 = 16


def earlier_library(tree: str) -> ctypes.CDLL:
    """Build ``tree``'s vote_hist.cu and bind its entry points."""
    src = os.path.join(tree, "cppf_tpu_torch", "csrc", "vote_hist.cu")
    os.makedirs(cuda_build.BUILD, exist_ok=True)
    lib_path = os.path.join(cuda_build.BUILD, "earlier_vote_hist.so")
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([cuda_build._nvcc(), *flags, "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cppf_bound_projections.argtypes = [p] * 7 + [ll] + [i] * 7 + [p, p]
    lib.cppf_refine_window.argtypes = [p] * 8 + [ll, i, i, p, p]
    lib.cppf_bound_projections_pairs.argtypes = [p, ll, i, p] + [i] * 8 + [p, p]
    lib.cppf_refine_window_pairs.argtypes = [p, p, ll, i, p] + [i] * 5 + [p, p]
    return lib


def kernels(inp, earlier):
    """[(label, "bound" or "refine", fn returning the output tensors)]."""
    votes, o, params, frame = inp["votes"], inp["o"], inp["params"], inp["frame"]
    g = inp["grid_shape"][0]
    pf = _poolf(g)
    bn = -(-g // pf)
    kw = dict(by_n=bn, bz_n=bn, pfy=pf, pfz=pf)
    pkw = dict(n_rots=inp["n_rots"], grid_shape=inp["grid_shape"])
    out = [
        ("bound_projections, votes", "bound",
         lambda: vh.bound_projections(*votes, gx=g, gy=g, **kw)),
        ("bound_projections, pairs", "bound",
         lambda: vh.bound_projections_pairs(params, frame, **pkw, **kw)),
        ("refine_window, votes", "refine", lambda: [vh.refine_window(o, *votes, w8=W8)]),
        ("refine_window, pairs", "refine",
         lambda: [vh.refine_window_pairs(o, params, frame, **pkw, w8=W8)]),
    ]
    if earlier is not None:
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in votes]
        n = votes[6].shape[0]

        def old_bound():
            buf = torch.zeros(3 * g * bn, device=o.device)
            rc = earlier.cppf_bound_projections(*ptrs, n, g, g, bn, bn, pf, pf, 0,
                                                buf.data_ptr(), stream)
            cs.check(rc == 0, f"earlier bound_projections: error {rc}")
            return [buf[:g * bn], buf[g * bn:2 * g * bn], buf[2 * g * bn:]]

        def old_refine():
            buf = torch.zeros(W8 ** 3, device=o.device)
            rc = earlier.cppf_refine_window(o.data_ptr(), *ptrs, n, W8, 0, buf.data_ptr(), stream)
            cs.check(rc == 0, f"earlier refine_window: error {rc}")
            return [buf]

        def old_bound_pairs():
            buf = torch.zeros(3 * g * bn, device=o.device)
            rc = earlier.cppf_bound_projections_pairs(
                params.data_ptr(), params.shape[0], inp["n_rots"], frame.data_ptr(),
                *inp["grid_shape"], bn, bn, pf, pf, 0, buf.data_ptr(), stream)
            cs.check(rc == 0, f"earlier bound_projections_pairs: error {rc}")
            return [buf[:g * bn], buf[g * bn:2 * g * bn], buf[2 * g * bn:]]

        def old_refine_pairs():
            buf = torch.zeros(W8 ** 3, device=o.device)
            rc = earlier.cppf_refine_window_pairs(
                o.data_ptr(), params.data_ptr(), params.shape[0], inp["n_rots"],
                frame.data_ptr(), *inp["grid_shape"], W8, 0, buf.data_ptr(), stream)
            cs.check(rc == 0, f"earlier refine_window_pairs: error {rc}")
            return [buf]

        out += [("bound_projections, votes, earlier checkout", "bound", old_bound),
                ("bound_projections, pairs, earlier checkout", "bound", old_bound_pairs),
                ("refine_window, votes, earlier checkout", "refine", old_refine),
                ("refine_window, pairs, earlier checkout", "refine", old_refine_pairs)]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier", help="checkout whose vote_hist.cu is timed beside this one's")
    args = ap.parse_args()
    cs.check(torch.cuda.is_available(), "needs one GPU")
    from cppf_tpu_torch.eval.nocs_inference import CategoryRunner
    from cppf_tpu_torch.models.convert import ASSETS

    print(f"card: {cs.smi_line()}", flush=True)
    earlier = earlier_library(args.earlier) if args.earlier else None
    runner = CategoryRunner("bowl")
    pc = np.load(os.path.join(ASSETS, "bowl_views.npz"))["pc_0"]
    for label, grid_shape, adaptive in (("bowl 64^3", (64, 64, 64), False),
                                        ("bowl 64^3, adaptive rotations", (64, 64, 64), True),
                                        ("bottle pooled 120^3", (120, 120, 120), False)):
        inp = cs.main_path_inputs(runner, pc, grid_shape, adaptive)
        votes, o = inp["votes"], inp["o"]
        g = grid_shape[0]
        pf = _poolf(g)
        bn = -(-g // pf)
        expect = {"bound": vh.bound_projections_plain(*votes, gx=g, gy=g, by_n=bn, bz_n=bn,
                                                      pfy=pf, pfz=pf),
                  "refine": [vh.refine_window_plain(o, *votes, w8=W8)]}
        todo = kernels(inp, earlier)
        for name, kind, fn in todo:
            cs._max_err(fn(), expect[kind], f"{name} [{label}]")
        for (name, _, _), ms in zip(todo, cs.cuda_ms_turns([fn for _, _, fn in todo])):
            print(f"{name} [{label}]: {ms:.4f} ms", flush=True)
    print(cs.smi_line())


if __name__ == "__main__":
    main()
