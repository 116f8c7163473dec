"""Stage times, launch count, idle share and peak memory of one bowl pose, or
of one zero-shot frame, for one or more checkouts of the port in turns on one
NVIDIA GPU.

``--trees A B B A`` runs each named checkout (a directory that holds
``chip_smoke.py`` and ``cppf_tpu_torch/``) in a process of its own, in that
order, so that two versions are compared inside one call on one card.  Per
tree it prints: warm ms/pose (median of 12 over the 4 committed views), the
stage times and profiler summary of that tree's own ``chip_smoke.py``
(``stage_times``, ``profile_pose``), the peak device memory of one warm
pose, and the peak device memory of the center-vote stage above what is
allocated when it starts.  With ``--frame``, the zero-shot path on the demo
frame instead: warm seconds of each stage of that tree's
``chip_smoke.zero_shot_stages`` (median of 5), the peak device memory of a
frame and of the heatmap stage above its inputs, and ``profile_frame``.

Usage: python scripts/pose_stages.py [--frame] --trees _parent . . _parent
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time


def run_tree(tree: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from cppf_tpu_torch.eval.nocs_inference import CategoryRunner
    from cppf_tpu_torch.models.convert import ASSETS
    from cppf_tpu_torch.ops import cuda_build
    from cppf_tpu_torch.pipeline import pose

    cs.check(torch.cuda.is_available(), "needs one GPU")
    cs.check(os.path.dirname(os.path.abspath(cs.__file__)) == tree, "wrong chip_smoke imported")
    print(f"tree {tree}: card {cs.smi_line()}", flush=True)
    cuda_build.build(["vote_hist"])
    runner = CategoryRunner("bowl")
    z = np.load(os.path.join(ASSETS, "bowl_views.npz"))
    views = [z[f"pc_{i}"] for i in range(int(z["n_views"]))]

    stage_peak = []
    inner = pose.ppf_vote_peak

    def measured_peak(*args, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = inner(*args, **kw)
        torch.cuda.synchronize()
        stage_peak.append(torch.cuda.max_memory_allocated() - base)
        return out

    for pc in views:
        runner.estimate(pc)
    times = []
    for _ in range(3):
        for pc in views:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.estimate(pc)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    print(f"  warm {statistics.median(times):.3f} ms/pose (median of {len(times)}, min "
          f"{min(times):.3f})", flush=True)
    cs.stage_times(runner, views[0])
    cs.profile_pose(runner, views[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runner.estimate(views[0])
    torch.cuda.synchronize()
    print(f"  peak device memory of one warm pose {torch.cuda.max_memory_allocated() / 2**20:.2f}"
          f" MiB", flush=True)
    pose.ppf_vote_peak = measured_peak
    runner.estimate(views[0])
    pose.ppf_vote_peak = inner
    print(f"  center-vote stage: peak device memory {stage_peak[0] / 2**20:.2f} MiB above its "
          f"inputs", flush=True)


def run_frame(tree: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from cppf_tpu_torch.config import load_config
    from cppf_tpu_torch.eval import zero_shot as zs
    from cppf_tpu_torch.models.convert import ASSETS, load_encoders, load_npz_params
    from cppf_tpu_torch.ops import cuda_build

    cs.check(torch.cuda.is_available(), "needs one GPU")
    cs.check(os.path.dirname(os.path.abspath(cs.__file__)) == tree, "wrong chip_smoke imported")
    print(f"tree {tree}: card {cs.smi_line()}", flush=True)
    cuda_build.build(["vote_hist"])
    cfg = load_config("bowl", snapshot=os.path.join(tree, "checkpoints", "bowl_reg",
                                                    "config.yaml"))
    cfg.cls_bins = False
    encoders = load_encoders(load_npz_params(os.path.join(ASSETS, "bowl_reg_params_zs.npz")), 9,
                             "cuda")
    z = np.load(os.path.join(ASSETS, "demo_frame.npz"))
    cs.zero_shot_stages(encoders, cfg, z, cs.ZS_PAIRS, "cuda")
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hm, _, times, _ = cs.zero_shot_stages(encoders, cfg, z, cs.ZS_PAIRS, "cuda")
        runs.append(times)
    totals = sorted(sum(t.values()) for t in runs)
    print(f"  warm {statistics.median(totals):.4f} s/frame (median of 5, "
          f"{', '.join(f'{t:.4f}' for t in totals)}), peak device memory of a frame "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    for name in runs[0]:
        print(f"  stage {name}: {statistics.median(t[name] for t in runs) * 1e3:.3f} ms",
              flush=True)
    preds_tr = hm.preds[:, :2].contiguous()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zs.frame_heatmap(hm.pc, preds_tr, hm.point_idxs, cfg.res, 72)
    torch.cuda.synchronize()
    print(f"  heatmap stage: peak device memory "
          f"{(torch.cuda.max_memory_allocated() - base) / 2**20:.2f} MiB above its inputs",
          flush=True)
    profile_heatmap(zs, hm, preds_tr, cfg.res)
    cs.profile_frame(encoders, cfg, z, "cuda")


def profile_heatmap(zs, hm, preds_tr, res) -> None:
    """Wall time, device busy time and the largest device kernels and host
    operators of one heatmap stage under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zs.frame_heatmap(hm.pc, preds_tr, hm.point_idxs, res, 72)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = sorted((e for e in events
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"  heatmap stage under the profiler: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms over {sum(e.count for e in kernels)} launches", flush=True)
    for e in kernels[:6]:
        print(f"    device {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x  {e.key[:90]}")
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    for e in host[:6]:
        print(f"    host   {e.self_cpu_time_total / 1e3:8.3f} ms {e.count:5d}x  {e.key[:90]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", help="checkouts to run, in this order")
    ap.add_argument("--tree", help="run this one checkout in this process")
    ap.add_argument("--frame", action="store_true", help="the zero-shot frame, not a pose")
    args = ap.parse_args()
    if args.tree:
        (run_frame if args.frame else run_tree)(args.tree)
        return
    for tree in args.trees or ["."]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree]
                       + (["--frame"] if args.frame else []), check=True)


if __name__ == "__main__":
    main()
