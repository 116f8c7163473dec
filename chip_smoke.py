"""Smoke run of the PyTorch port (cppf_tpu_torch) on one NVIDIA GPU.

Drives the port's two paths and holds every CUDA kernel of them against its
plain PyTorch version: the main path, ``CategoryRunner("bowl").estimate``
(single-instance 9D pose at bowl's full width: 4096 points, knn 60,
100 000 pairs, 72 rotations = 7.2 M center votes, 64³ grid) on the
committed rendered views, and the zero-shot path, ``zero_shot_detect`` (the
whole demo frame at the width of ``checkpoints/bowl_reg``: res 4 mm, knn
60, 5 M pairs, 72 rotations, adaptive voting, a 320×218×164 heatmap).
Phases:

1. card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: every ``cppf_tpu_torch/csrc/*.cu``, one ``nvcc`` each, together;
3. kernels: each kernel against its plain version on the same CUDA votes
   from the main path (bowl: V = 7.2 M, 64³; and the same votes on bottle's
   pooled 120³ grid), with times by CUDA events (median of 25), the
   memory/operation bound, and one ``index_add_`` call as the library
   yardstick; fails beyond 1e-3 relative;
4. main path: the 4 views on the card, launch counts (reset just before),
   errors against ground truth and against the stored JAX estimates, warm
   ms per pose; fails if a kernel never launched, if the median T error
   exceeds 2 cm or the median up error 15°;
5. CPU against CUDA: one view with identical draws through the plain
   versions and through the kernels; fails unless the peak voxel and the up
   direction are the same;
6. ``dense_hist`` against its plain version on the demo frame's own CUDA
   votes at three shapes: one 2^20-pair chunk (75 M votes) on the unpooled
   whole-frame grid, the same chunk on the pool-8 coarse grid of the sparse
   route, and one 48³ window; fails beyond 1e-3 of the maximum; times as in
   phase 3, and the vote atomics a second;
7. the zero-shot path on the demo frame (launch counts reset just before):
   fails unless ``dense_hist`` launched, there are exactly 2 detections,
   each within 4 cm of the two real bowls, with bowl-sized scales, and
   within 1 cm and 5° of the stored JAX detection; warm seconds a frame by
   stage (median of 3) and the peak device memory; the ``sparse=True``
   route at its defaults (its proposals and detections are printed beside
   the dense route's) and without its pair budget, where every voxel it
   writes must equal the dense grid's to 1e-3 of the maximum; and a
   reduced run (200 000 pairs) on the CPU and on the card, which must give
   the same detections to 1 mm.

``--profile`` adds the warm time of each stage of one pose, and a
torch.profiler table of the kernels of one pose and of one zero-shot
frame.  Prints the
kernels JSON line, the ``nvidia-smi`` line, and last the result line.
Usage: python3 chip_smoke.py [--profile]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM data-sheet peaks
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
KERNEL_RTOL = 1e-3
TIMING_REPS = 25
TPU_KERNELS = {
    "bound_projections": "cppf_tpu/ops/pallas/vote_hist.py:126",
    "refine_window": "cppf_tpu/ops/pallas/vote_hist.py:200",
    "dense_hist": "cppf_tpu/ops/pallas/vote_hist.py:310",
}
# the two real bowls of data/demo/0000_depth.png (tests/test_demo_frame.py:26-29)
BOWL_CENTERS = np.array([[0.0799, -0.1865, 1.2541], [0.1599, -0.0345, 1.1941]])
ZS_PAIRS = 5_000_000
REDUCED_PAIRS = 200_000


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def cuda_ms(fn) -> float:
    """Median device time of one call, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main_path_votes(runner, pc_raw, grid_shape):
    """The flat vote vectors ppf_vote_peak builds for one view, and the
    origin of its first refine window."""
    from cppf_tpu_torch.ops.voting import _vote_coords, ppf_vote_peak
    from cppf_tpu_torch.pipeline.pose import (PoseDraws, decode_translation, grid_frame,
                                              pair_predictions)
    from cppf_tpu_torch.pipeline.preprocess import preprocess_cloud

    pcfg, cfg, dev = runner.pcfg, runner.cfg, runner.device
    draws = PoseDraws.sample(pcfg, torch.Generator(device=dev).manual_seed(1), dev,
                             n_raw=cfg.npoint_max)
    pad = np.zeros((cfg.npoint_max, 3), np.float32)
    pad[: len(pc_raw)] = pc_raw[: cfg.npoint_max]
    with torch.no_grad():
        pre = preprocess_cloud(torch.from_numpy(pad).to(dev), min(len(pc_raw), cfg.npoint_max),
                               cfg.res, npoint_pad=cfg.npoint_pad, knn=cfg.knn,
                               noise=draws.jitter)
        idxs, preds = pair_predictions(runner.point_encoder, runner.ppf_encoder, pre.pc,
                                       pre.normals, pre.n_valid, pcfg, draws.pair_u,
                                       pre.nbr_idx)
        preds_tr = decode_translation(preds, draws.tr_gumbel, pcfg)
        corner, dims = grid_frame(pre.pc, pre.valid_mask, pcfg)
        probs = torch.ones(pre.pc.shape[0], device=dev)
        mask = torch.ones(idxs.shape[0], dtype=torch.bool, device=dev)
        f, r, w = _vote_coords(pre.pc, preds_tr, probs, idxs, corner, pcfg.res,
                               dims.float(), grid_shape, pcfg.num_rots, False, mask)
        peak, _ = ppf_vote_peak(pre.pc, preds_tr, probs, idxs, corner, pcfg.res, dims,
                                grid_shape, n_rots=pcfg.num_rots, max_rounds=1)
    votes = [a.reshape(-1).contiguous() for a in (*f, *r, w)]
    return votes, (peak // 16 * 16).to(torch.int32)


def _bound_taps(votes, gx, gy, by_n, bz_n, pfy, pfz):
    """Flat ids and values of every trilinear term of bound_projections,
    for the one-call index_add_ yardstick."""
    fx, fy, fz, rx, ry, rz, w = votes
    hx = [(fx.long(), (1 - rx) * w), (fx.long() + 1, rx * w)]
    hy = [(fy.long(), 1 - ry), (fy.long() + 1, ry)]
    hz = [(fz.long(), 1 - rz), (fz.long() + 1, rz)]
    n_xy, n_xz = gx * by_n, gx * bz_n
    ids, vals = [], []
    for ix, vx in hx:
        for iy, vy in hy:
            ids.append(ix * by_n + iy // pfy), vals.append(vx * vy)
        for iz, vz in hz:
            ids.append(n_xy + ix * bz_n + iz // pfz), vals.append(vx * vz)
    for iy, vy in hy:
        for iz, vz in hz:
            ids.append(n_xy + n_xz + iy * bz_n + iz // pfz), vals.append(vy * w * vz)
    return torch.cat(ids), torch.cat(vals)


def _refine_taps(votes, o, w8):
    """Flat ids and values of the 8 corners of every vote; corners outside
    the window go to one spare slot at index w8³."""
    fx, fy, fz, rx, ry, rz, w = votes
    o = o.long()
    ids, vals = [], []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                lx, ly, lz = fx - o[0] + dx, fy - o[1] + dy, fz - o[2] + dz
                ok = ((lx >= 0) & (lx < w8) & (ly >= 0) & (ly < w8) & (lz >= 0) & (lz < w8))
                ids.append(torch.where(ok, (lx * w8 + ly) * w8 + lz, w8 ** 3).long())
                vals.append(((rx if dx else 1 - rx) * w) * ((ry if dy else 1 - ry)
                                                            * (rz if dz else 1 - rz)))
    return torch.cat(ids), torch.cat(vals)


def _max_err(got, expect, name):
    got = torch.cat([g.reshape(-1) for g in got])
    expect = torch.cat([e.reshape(-1) for e in expect])
    err = (got - expect).abs().max().item()
    scale = expect.abs().max().item()
    check(scale > 0, f"{name}: plain version is all zero")
    check(err <= KERNEL_RTOL * scale, f"{name}: kernel differs from plain by {err} "
          f"(> {KERNEL_RTOL} of {scale})")
    return err, err / scale


def kernel_phase(votes, o, grid, label):
    """Compare and time both kernels on one set of votes; returns their
    records for the kernels line."""
    from cppf_tpu_torch.ops import vote_hist as vh
    from cppf_tpu_torch.ops.voting import _poolf

    fx, fy, fz, rx, ry, rz, w = votes
    V = w.shape[0]
    pf = _poolf(grid)
    bn = -(-grid // pf)
    kw = dict(gx=grid, gy=grid, by_n=bn, bz_n=bn, pfy=pf, pfz=pf, splat="trilinear")
    w8 = 16
    records = {}

    got = vh.bound_projections(*votes, **kw)
    expect = vh.bound_projections_plain(*votes, **kw)
    err, rel = _max_err(got, expect, f"bound_projections {label}")
    ids, vals = _bound_taps(votes, grid, grid, bn, bn, pf, pf)
    out = torch.zeros(3 * grid * bn, device=w.device)
    live = int((w != 0).sum())
    n_out = 3 * grid * bn
    bytes_ = 4 * V + 6 * 4 * live + 4 * n_out     # w of every vote, the rest of the live ones
    ops = 31 * live                               # 6 hats, 3 weighted, 12 products, 12 adds
    records["bound_projections"] = dict(
        max_abs_err=err, rel_err=rel,
        ms=cuda_ms(lambda: vh.bound_projections(*votes, **kw)),
        plain_ms=cuda_ms(lambda: vh.bound_projections_plain(*votes, **kw)),
        library_ms=cuda_ms(lambda: out.index_add_(0, ids, vals)),
        bytes=bytes_, ops=ops)
    del ids, vals

    got = vh.refine_window(o, *votes, w8=w8)
    expect = vh.refine_window_plain(o, *votes, w8=w8)
    err, rel = _max_err([got], [expect], f"refine_window {label}")
    ids, vals = _refine_taps(votes, o, w8)
    out = torch.zeros(w8 ** 3 + 1, device=w.device)
    lx = fx - o[0]
    near = (lx >= -1) & (lx < w8) & (w != 0)
    inside = near & (fy - o[1] >= -1) & (fy - o[1] < w8) & (fz - o[2] >= -1) & (fz - o[2] < w8)
    n_near, n_in = int(near.sum()), int(inside.sum())
    # fx of every vote, w/fy/fz of those in the window's x range, the
    # fractions of those that reach the window; 8 corners of 3 products
    # and an add for each of those
    bytes_ = 4 * V + 3 * 4 * n_near + 3 * 4 * n_in + 4 * w8 ** 3
    records["refine_window"] = dict(
        max_abs_err=err, rel_err=rel,
        ms=cuda_ms(lambda: vh.refine_window(o, *votes, w8=w8)),
        plain_ms=cuda_ms(lambda: vh.refine_window_plain(o, *votes, w8=w8)),
        library_ms=cuda_ms(lambda: out.index_add_(0, ids, vals)),
        bytes=bytes_, ops=8 * 4 * n_in)
    for name, rec in records.items():
        t_bytes = rec["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = rec["ops"] / FP32_OPS_PER_S * 1e3
        rec["bound_ms"] = max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"kernel {name} [{label}, V={V}, live={live}]: max abs err "
              f"{rec['max_abs_err']:.3e} (rel {rec['rel_err']:.3e}), kernel {rec['ms']:.4f} ms, "
              f"plain {rec['plain_ms']:.4f} ms, index_add_ {rec['library_ms']:.4f} ms, "
              f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})", flush=True)
    return records


def errors(out, z, i):
    T, R = z[f"T_{i}"], z[f"R_{i}"]
    t_err = float(np.linalg.norm(out.T.cpu().numpy() - T))
    up = out.up.cpu().numpy()
    up_err = float(np.degrees(np.arccos(np.clip(up @ R[:, 1], -1, 1))))
    bound = z[f"bound_{i}"]
    s_err = float(abs(np.linalg.norm(out.scale.cpu().numpy()) - np.linalg.norm(bound))
                  / np.linalg.norm(bound))
    t_jax = float(np.linalg.norm(out.T.cpu().numpy() - z[f"jax_T_{i}"]))
    up_jax = float(np.degrees(np.arccos(np.clip(up @ z[f"jax_up_{i}"], -1, 1))))
    return t_err, up_err, s_err, t_jax, up_jax


def stage_times(runner, pc_raw, reps: int = 5):
    """Warm wall time of each stage of one pose (synchronised, median of
    ``reps``), called in the order estimate_pose calls them."""
    from cppf_tpu_torch.ops.voting import backvote, ppf_vote_peak
    from cppf_tpu_torch.pipeline.pose import (PoseDraws, _vote_axis, decode_translation,
                                              grid_frame, pair_predictions)
    from cppf_tpu_torch.pipeline.preprocess import preprocess_cloud

    pcfg, cfg, dev = runner.pcfg, runner.cfg, runner.device
    draws = PoseDraws.sample(pcfg, runner.generator, dev, n_raw=cfg.npoint_max)
    pad = np.zeros((cfg.npoint_max, 3), np.float32)
    pad[: len(pc_raw)] = pc_raw
    res = torch.tensor(pcfg.res, device=dev)
    probs = torch.ones(cfg.npoint_pad, device=dev)
    B, R = pcfg.tr_num_bins, pcfg.rot_num_bins
    st = {}
    steps = [
        ("preprocess (voxel, KNN, normals)", lambda: st.update(pre=preprocess_cloud(
            torch.from_numpy(pad).to(dev), len(pc_raw), cfg.res, npoint_pad=cfg.npoint_pad,
            knn=cfg.knn, noise=draws.jitter))),
        ("network (SPRIN + pairs + PPF head)", lambda: st.update(net=pair_predictions(
            runner.point_encoder, runner.ppf_encoder, st["pre"].pc, st["pre"].normals,
            st["pre"].n_valid, pcfg, draws.pair_u, st["pre"].nbr_idx))),
        ("translation decode + grid frame", lambda: st.update(
            tr=decode_translation(st["net"][1], draws.tr_gumbel, pcfg),
            frame=grid_frame(st["pre"].pc, st["pre"].valid_mask, pcfg))),
        ("center-vote peak (ppf_vote_peak)", lambda: st.update(peak=ppf_vote_peak(
            st["pre"].pc, st["tr"], probs, st["net"][0], st["frame"][0], pcfg.res,
            st["frame"][1], pcfg.grid_shape, n_rots=pcfg.num_rots,
            max_rounds=pcfg.peak_rounds))),
        ("back-vote filter", lambda: st.update(mask=backvote(
            st["pre"].pc, st["tr"], st["net"][0], st["frame"][0], res, st["frame"][1],
            st["frame"][0] + st["peak"][0].float() * pcfg.res, 3.0 * pcfg.res,
            n_rots=pcfg.num_rots)[1])),
        ("up-axis vote (sphere count + aux sign)", lambda: _vote_axis(
            st["pre"].pc, st["pre"].normals, st["net"][0], st["mask"],
            st["net"][1][:, 2 * B: 2 * B + R], st["net"][1][:, -5], runner.sphere, pcfg,
            draws.up)),
    ]
    total = 0.0
    with torch.no_grad():
        for name, fn in steps:
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            total += statistics.median(times)
            print(f"  stage {name}: {statistics.median(times):.3f} ms", flush=True)
    print(f"  stages total {total:.3f} ms", flush=True)


def profile_pose(runner, pc_raw):
    """Device time by kernel over one warm pose, and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    runner.estimate(pc_raw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.estimate(pc_raw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"profile: wall {wall_ms:.2f} ms under the profiler, device busy {busy_ms:.2f} ms "
          f"over {launches} kernel launches (idle share {1 - busy_ms / wall_ms:.3f})")
    for e in kernels[:15]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  {e.count:5d}x  {e.key[:100]}")


def zero_shot_stages(encoders, cfg, z, n_pairs, device, prop_thresh=50.0, contrib_thresh=12):
    """The zero-shot path stage by stage on the demo frame, each stage
    synchronised.  Returns (HeatmapState, detections, {stage: seconds},
    the network cloud's point count)."""
    from cppf_tpu_torch.eval import zero_shot as zs

    rng = np.random.default_rng(0)
    times = {}

    def timed(name, fn):
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if device != "cpu":
            torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    def prep():
        clouds = zs.frame_clouds(z["depth"], z["intrinsics"], cfg.res, cfg.knn, rng, device)
        pc, nrm = clouds.high_pc[clouds.lo_idx], clouds.high_normal[clouds.lo_idx]
        return clouds, pc, nrm, zs.sample_pairs(pc, nrm, n_pairs, rng)

    with torch.no_grad():
        clouds, pc, nrm, pairs = timed("prep (cloud, voxels, KNN, normals, pairs)", prep)
        preds = timed("network (SPRIN + PPF head)",
                      lambda: zs.frame_predictions(*encoders, clouds, pairs))
        grid, corner, dims = timed("heatmap (ppf_vote_dense)", lambda: zs.frame_heatmap(
            pc, preds[:, :2].contiguous(), pairs, cfg.res, 72))
        hm = zs.HeatmapState(pc, nrm, pairs, preds, grid, corner, dims)
        dets = timed("detect (proposals, re-rank, back-vote, axes)",
                     lambda: zs.detect_from_heatmap(hm, cfg, prop_thresh=prop_thresh,
                                                    contrib_thresh=contrib_thresh,
                                                    plane_u=z["plane_u"]))
    return hm, dets, times, clouds.high_pc.shape[0]


def _dense_taps(votes, c, pool):
    """Flat pooled ids and values of the 8 trilinear taps of every vote,
    for the one-call index_add_ yardstick."""
    fx, fy, fz, rx, ry, rz, w = votes
    ids, vals = [], []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ids.append((((fx.long() + dx) // pool[0] * c[1] + (fy.long() + dy) // pool[1])
                            * c[2] + (fz.long() + dz) // pool[2]))
                vals.append(((rx if dx else 1 - rx) * w) * (ry if dy else 1 - ry)
                            * (rz if dz else 1 - rz))
    return torch.cat(ids), torch.cat(vals)


def dense_record(votes, c, pool, label):
    """dense_hist against its plain version on one set of votes, timed."""
    from cppf_tpu_torch.ops import vote_hist as vh

    w = votes[6]
    V = w.shape[0]
    kw = dict(cx=c[0], cy=c[1], cz=c[2], px=pool[0], py=pool[1], pz=pool[2])
    got = vh.dense_hist(*votes, **kw)
    expect = vh.dense_hist_plain(*votes, **kw)
    err, rel = _max_err([got], [expect], f"dense_hist {label}")
    del got, expect
    live = w != 0
    # distinct pooled taps of each live vote: the kernel's atomics
    n_ax = [1 + ((f.long() + 1) // p != f.long() // p).long() for f, p in zip(votes[:3], pool)]
    taps = (n_ax[0] * n_ax[1] * n_ax[2])[live]
    atomics = int(taps.sum())
    n_live = int(live.sum())
    ops = int((3 + n_ax[0][live] + (n_ax[0] * n_ax[1])[live] + 2 * taps).sum())
    cells = c[0] * c[1] * c[2]
    buf = torch.zeros(tuple(c), device=w.device)
    rec = dict(max_abs_err=err, rel_err=rel,
               ms=cuda_ms(lambda: vh.dense_hist(*votes, **kw, out=buf)),
               plain_ms=cuda_ms(lambda: vh.dense_hist_plain(*votes, **kw, out=buf)),
               bytes=4 * V + 6 * 4 * n_live + 4 * cells, ops=ops)
    ids, vals = _dense_taps(votes, c, pool)
    flat = torch.zeros(cells, device=w.device)
    rec["library_ms"] = cuda_ms(lambda: flat.index_add_(0, ids, vals))
    del ids, vals
    t_bytes = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = rec["ops"] / FP32_OPS_PER_S * 1e3
    rec["bound_ms"] = max(t_bytes, t_ops)
    rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    print(f"kernel dense_hist [{label}, grid {tuple(c)}, pool {pool}, V={V}, live={n_live}]: "
          f"max abs err {err:.3e} (rel {rel:.3e}), kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, index_add_ {rec['library_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), {atomics} vote atomics = "
          f"{atomics / rec['ms'] * 1e3:.3e} atomics/s", flush=True)
    return rec


def dense_phase(hm, res):
    """Phase 6: dense_hist at the zero-shot path's three shapes, on the votes
    of the frame's first 2^20 pairs."""
    from cppf_tpu_torch.eval import zero_shot as zs
    from cppf_tpu_torch.ops.voting import _vote_coords

    dev = hm.pc.device
    n = hm.pc.shape[0]
    sel = slice(0, 1 << 20)
    preds_tr = hm.preds[:, :2].contiguous()
    dims = hm.dims

    def votes(idxs, grid_shape, corner, gdims, comp=1.0):
        f, r, w = _vote_coords(hm.pc, preds_tr[idxs], torch.full((n,), comp, device=dev),
                               hm.point_idxs[idxs], torch.as_tensor(corner, device=dev), res,
                               torch.as_tensor(gdims, device=dev).float(), grid_shape, 72, True,
                               torch.ones(hm.point_idxs[idxs].shape[0], dtype=torch.bool,
                                          device=dev))
        return [a.reshape(-1).contiguous() for a in (*f, *r, w)]

    gshape = tuple(int(np.ceil(d / 8) * 8) for d in dims)
    records = {"frame": dense_record(votes(sel, gshape, hm.corner, dims), gshape, (1, 1, 1),
                                     "frame chunk, unpooled")}
    gshape_c = tuple(int(np.ceil(d / 64) * 64) for d in dims)
    v = votes(sel, gshape_c, hm.corner, dims)
    c = tuple(g // 8 for g in gshape_c)
    records["coarse"] = dense_record(v, c, (8, 8, 8), "frame chunk, pool-8 coarse grid")
    from cppf_tpu_torch.ops import vote_hist as vh

    coarse = vh.dense_hist(*v, cx=c[0], cy=c[1], cz=c[2], px=8, py=8, pz=8)
    del v
    cell = np.array(np.unravel_index(int(torch.argmax(coarse)), c))
    wo = zs._window_origin(cell, dims, 48, 8)
    keep, comp = zs._window_pairs(wo, zs._pair_circles(hm.pc, preds_tr, hm.point_idxs, res, 48),
                                  hm.corner, res, 48, 1 << 17)
    records["window"] = dense_record(
        votes(keep, (48, 48, 48), (hm.corner + wo * res).astype(np.float32),
              np.minimum(dims - wo, 48), comp), (48, 48, 48), (1, 1, 1),
        f"48^3 window at {tuple(int(x) for x in wo)}, {keep.numel()} pairs")
    return records


def _match(dets, centers):
    """Each of ``centers`` with its nearest detection: (distance, detection)."""
    out = []
    for c in centers:
        d = [float(np.linalg.norm(x.T - c)) for x in dets]
        out.append((min(d), dets[int(np.argmin(d))]))
    return out


def profile_frame(encoders, cfg, z, device):
    """Device time by kernel over one warm zero-shot frame, and the device's
    idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, times, _ = zero_shot_stages(encoders, cfg, z, ZS_PAIRS, device)
    wall_ms = sum(times.values()) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile: zero-shot frame {wall_ms:.1f} ms under the profiler, device busy "
          f"{busy_ms:.1f} ms over {sum(e.count for e in kernels)} kernel launches (idle share "
          f"{1 - busy_ms / wall_ms:.3f})", flush=True)
    for e in kernels[:12]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  {e.count:5d}x  {e.key[:100]}")


def zero_shot_phase(z, device, profile=False):
    """Phase 7: the zero-shot path at full width on the demo frame."""
    from cppf_tpu_torch.config import load_config
    from cppf_tpu_torch.eval import zero_shot as zs
    from cppf_tpu_torch.models.convert import ASSETS, load_encoders, load_npz_params
    from cppf_tpu_torch.ops import vote_hist as vh

    cfg = load_config("bowl", snapshot=os.path.join(ROOT, "checkpoints", "bowl_reg",
                                                    "config.yaml"))
    cfg.cls_bins = False
    check(cfg.res == 0.004 and cfg.knn == 60, f"not bowl_reg's width: {cfg}")
    params = load_npz_params(os.path.join(ASSETS, "bowl_reg_params_zs.npz"))
    encoders = load_encoders(params, 9, device)
    # warm-up, and the votes of phase 6
    hm, _, _, n_high = zero_shot_stages(encoders, cfg, z, ZS_PAIRS, device)
    print(f"zero-shot frame: network cloud {n_high} points, voting cloud {hm.pc.shape[0]} "
          f"points, {hm.point_idxs.shape[0]} "
          f"pairs after the degenerate filter (JAX CPU: {int(z['jax_n_pairs'])}), heatmap "
          f"{tuple(int(d) for d in hm.dims)}", flush=True)
    records = dense_phase(hm, cfg.res)
    del hm

    # ---- 7. the zero-shot path --------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    vh.reset_launches()
    dets = zs.zero_shot_detect(z["depth"], encoders, cfg, intrinsics=z["intrinsics"],
                               n_pairs=ZS_PAIRS, device=device, plane_u=z["plane_u"])
    torch.cuda.synchronize()
    launches = dict(vh.LAUNCHES)
    print(f"zero-shot path launches over 1 frame: {launches}", flush=True)
    check(launches["dense_hist"] > 0, "dense_hist never launched on the zero-shot path")
    for d in dets:
        print(f"detection: T {np.round(d.T, 4)}, scale {np.round(d.scale, 4)}, "
              f"up {np.round(d.R[:, 1], 4)}, score {d.score:.1f}, mask {int(d.mask.sum())} points",
              flush=True)
    check(len(dets) == 2, f"{len(dets)} detections, not the 2 demo bowls")
    for dist, d in _match(dets, BOWL_CENTERS):
        check(dist < 0.04, f"a detection is {dist * 1e3:.1f} mm from its bowl (>= 40 mm)")
        check(0.10 < d.scale[0] < 0.22 and 0.10 < d.scale[2] < 0.22 and 0.02 < d.scale[1] < 0.09,
              f"scale {d.scale} is not a bowl's")
    for T, R in zip(z["jax_T"], z["jax_R"]):
        dist, d = _match(dets, [T])[0]
        up = float(np.degrees(np.arccos(np.clip(d.R[:, 1] @ R[:, 1], -1, 1))))
        print(f"against the JAX CPU detection at {np.round(T, 4)}: T {dist * 1e3:.3f} mm, "
              f"up {up:.3f} deg", flush=True)
        check(dist < 0.01 and up < 5.0, "a detection is > 1 cm or > 5 deg from JAX's")

    stage_runs = []
    for _ in range(3):
        hm, _, times, _ = zero_shot_stages(encoders, cfg, z, ZS_PAIRS, device)
        stage_runs.append(times)
    totals = [sum(t.values()) for t in stage_runs]
    print(f"zero-shot path: warm {statistics.median(totals):.4f} s/frame (median of 3, "
          f"{', '.join(f'{t:.4f}' for t in totals)}), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for name in stage_runs[0]:
        print(f"  stage {name}: {statistics.median(t[name] for t in stage_runs):.4f} s",
              flush=True)
    if profile:
        profile_frame(encoders, cfg, z, device)

    # the sparse route (coarse pool-8 pass, then 48³ windows): once at its
    # defaults, whose candidate cap and pair budget make it approximate on
    # this frame (reported, not held to the dense route), and once with no
    # pair budget, where every voxel it writes must equal the dense grid's
    t0 = time.perf_counter()
    grid_s, corner, dims = zs.frame_heatmap(hm.pc, hm.preds[:, :2].contiguous(), hm.point_idxs,
                                            cfg.res, 72, sparse=True)
    torch.cuda.synchronize()
    t_sparse = time.perf_counter() - t0
    p_dense = zs.extract_proposals_host(hm.grid, corner, cfg.res)
    p_sparse = zs.extract_proposals_host(grid_s, corner, cfg.res)
    d_sparse = zs.detect_from_heatmap(hm._replace(grid=grid_s), cfg, plane_u=z["plane_u"])
    print(f"sparse route at its defaults: heatmap {t_sparse:.4f} s, {len(p_sparse)} proposals "
          f"against the dense route's {len(p_dense)}, {len(d_sparse)} detections at "
          f"{[np.round(d.T, 4).tolist() for d in d_sparse]}", flush=True)
    exact = zs._sparse_frame_grid(hm.pc, hm.preds[:, :2].contiguous(), hm.point_idxs, corner,
                                  dims, cfg.res, 72, pair_budget=1 << 62)
    written = exact != 0
    err = float(np.abs(exact - hm.grid)[written].max())
    print(f"sparse route without a pair budget: {int(written.sum())} voxels written, max abs "
          f"difference from the dense grid {err:.3e} (max {hm.grid.max():.3f})", flush=True)
    check(written.sum() > 0 and err <= KERNEL_RTOL * hm.grid.max(),
          "the sparse route's exact windows differ from the dense grid")
    del hm, grid_s, exact

    # CPU (plain versions) against CUDA (kernels) at 200 000 pairs; the
    # vote thresholds scale with the pairs (proposal contrast 50 and
    # membership count 12 at 5 M pairs become 2 and 0)
    ratio = REDUCED_PAIRS / ZS_PAIRS
    thresh = dict(prop_thresh=50.0 * ratio, contrib_thresh=int(12 * ratio))
    cpu_enc = load_encoders(params, 9, "cpu")
    _, d_cpu, t_cpu, _ = zero_shot_stages(cpu_enc, cfg, z, REDUCED_PAIRS, "cpu", **thresh)
    _, d_gpu, _, _ = zero_shot_stages(encoders, cfg, z, REDUCED_PAIRS, device, **thresh)
    dT = [float(np.linalg.norm(a.T - b.T)) for a, b in zip(d_cpu, d_gpu)]
    print(f"cpu vs cuda at {REDUCED_PAIRS} pairs: {len(d_cpu)} vs {len(d_gpu)} detections, "
          f"|dT| {dT} m (cpu run {sum(t_cpu.values()):.1f} s)", flush=True)
    check(len(d_cpu) == len(d_gpu) > 0, "CPU and CUDA detection counts differ")
    check(max(dT) < 1e-3, "CPU and CUDA detections are more than 1 mm apart")
    return records, launches


def main():
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU")
    ap.add_argument("--profile", action="store_true", help="profile one warm pose")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs one GPU")
    sys.path.insert(0, ROOT)
    from cppf_tpu_torch.eval.nocs_inference import CategoryRunner
    from cppf_tpu_torch.models.convert import ASSETS
    from cppf_tpu_torch.ops import cuda_build
    from cppf_tpu_torch.ops import vote_hist as vh
    from cppf_tpu_torch.pipeline.pose import PoseDraws

    # ---- 1. card -------------------------------------------------------------
    smi = smi_line()
    device = torch.cuda.get_device_name(0)
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {device}",
          flush=True)

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    sources = sorted(os.path.basename(p)[:-3] for p in
                     glob.glob(os.path.join(ROOT, "cppf_tpu_torch", "csrc", "*.cu")))
    cuda_build.build(sources)
    print(f"build: {sources} in {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 3. kernels against their plain versions -----------------------------
    runner = CategoryRunner("bowl")
    pcfg = runner.pcfg
    check(pcfg.n_pairs == 100000 and pcfg.num_rots == 72 and pcfg.grid_shape == (64, 64, 64)
          and runner.cfg.npoint_pad == 4096 and pcfg.knn == 60, f"not full width: {pcfg}")
    z = np.load(os.path.join(ASSETS, "bowl_views.npz"))
    n_views = int(z["n_views"])
    votes, o = main_path_votes(runner, z["pc_0"], pcfg.grid_shape)
    check(votes[0].shape[0] == 7_200_000, f"V = {votes[0].shape[0]}")
    records = kernel_phase(votes, o, 64, "bowl 64^3")
    votes, o = main_path_votes(runner, z["pc_0"], (120, 120, 120))
    kernel_phase(votes, o, 120, "bottle pooled 120^3")
    del votes

    # ---- 4. the main path on the card ----------------------------------------
    vh.reset_launches()
    outs = [runner.estimate(z[f"pc_{i}"])[0] for i in range(n_views)]
    torch.cuda.synchronize()
    launches = dict(vh.LAUNCHES)
    print(f"main path launches over {n_views} poses: {launches}", flush=True)
    for name in ("bound_projections", "refine_window"):
        check(launches[name] > 0, f"{name} never launched on the main path")
    errs = [errors(out, z, i) for i, out in enumerate(outs)]
    for i, (t_err, up_err, s_err, t_jax, up_jax) in enumerate(errs):
        print(f"view {i}: T err {t_err * 1e3:.2f} mm, up err {up_err:.2f} deg, scale err "
              f"{s_err * 100:.2f} %; against the JAX CPU estimate: T {t_jax * 1e3:.2f} mm, "
              f"up {up_jax:.2f} deg; back-vote survivors {int(outs[i].n_filtered)}")
    t_med = float(np.median([e[0] for e in errs]))
    up_med = float(np.median([e[1] for e in errs]))
    times = []
    for _ in range(3):
        for i in range(n_views):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, _ = runner.estimate(z[f"pc_{i}"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    print(f"main path: median T err {t_med * 1e3:.2f} mm, median up err {up_med:.2f} deg, "
          f"warm {statistics.median(times):.2f} ms/pose (median of {len(times)}, "
          f"min {min(times):.2f})", flush=True)
    check(t_med < 0.02, f"median T error {t_med * 1e3:.1f} mm >= 20 mm")
    check(up_med < 15.0, f"median up error {up_med:.1f} deg >= 15 deg")
    if args.profile:
        stage_times(runner, z["pc_0"])
        profile_pose(runner, z["pc_0"])

    # ---- 5. CPU (plain versions) against CUDA (kernels), identical draws ----
    draws = PoseDraws.sample(pcfg, torch.Generator().manual_seed(5), "cpu",
                             n_raw=runner.cfg.npoint_max)
    out_cpu, pre_cpu = CategoryRunner("bowl", device="cpu").estimate(z["pc_1"], draws=draws)
    out_gpu, pre_gpu = runner.estimate(z["pc_1"], draws=draws.to("cuda"))
    same_pts = bool(torch.equal(pre_cpu.raw_idx, pre_gpu.raw_idx.cpu()))
    dT = float((out_cpu.T - out_gpu.T.cpu()).abs().max())
    dup = float((out_cpu.up - out_gpu.up.cpu()).abs().max())
    print(f"cpu vs cuda, identical draws: same kept points {same_pts}, |dT| {dT:.2e}, "
          f"|d up| {dup:.2e}, survivors {int(out_cpu.n_filtered)} vs "
          f"{int(out_gpu.n_filtered)}", flush=True)
    check(dT < 1e-6, "CPU and CUDA peak voxels differ")
    check(dup < 1e-6, "CPU and CUDA up directions differ")

    # ---- 6-7. dense_hist, the zero-shot path ------------------------------
    zs_z = np.load(os.path.join(ASSETS, "demo_frame.npz"))
    dense, zs_launches = zero_shot_phase(zs_z, runner.device, args.profile)
    records["dense_hist"] = dense["frame"]
    launches["dense_hist"] = zs_launches["dense_hist"]

    kernels = [dict(name=name, route="cuda", source="cppf_tpu_torch/csrc/vote_hist.cu",
                    replaces=TPU_KERNELS[name], launches=launches[name],
                    max_abs_err=rec["max_abs_err"], ms=rec["ms"], plain_ms=rec["plain_ms"],
                    bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
                    library_ms=rec["library_ms"])
               for name, rec in records.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
