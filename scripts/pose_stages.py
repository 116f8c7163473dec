"""Stage times, launch count, idle share and peak memory of one bowl pose, for
one or more checkouts of the port in turns on one NVIDIA GPU.

``--trees A B B A`` runs each named checkout (a directory that holds
``chip_smoke.py`` and ``cppf_tpu_torch/``) in a process of its own, in that
order, so that two versions are compared inside one call on one card.  Per
tree it prints: warm ms/pose (median of 12 over the 4 committed views), the
stage times and profiler summary of that tree's own ``chip_smoke.py``
(``stage_times``, ``profile_pose``), the peak device memory of one warm
pose, and the peak device memory of the center-vote stage above what is
allocated when it starts.

Usage: python scripts/pose_stages.py --trees _parent . . _parent
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", help="checkouts to run, in this order")
    ap.add_argument("--tree", help="run this one checkout in this process")
    args = ap.parse_args()
    if args.tree:
        run_tree(args.tree)
        return
    for tree in args.trees or ["."]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree], check=True)


if __name__ == "__main__":
    main()
