"""Phase 18 of chip_smoke.py alone: build the kernels, then the quality
gauges of the port on the card: (a) ``eval_checkpoints`` at 4 poses, seed
0, for all 12 categories against the committed views and JAX's stored
estimates, with bowl's view 0 under ``--set center_mode=grid`` and sofa's
under ``--set coplanar_halfspace=true`` against JAX's estimates under those
flags; (b) the synthetic NOCS, SUN RGB-D and
zero-shot runs against the stored JAX run (``assets/gauge_runs.npz``);
(c) the gauges at their defaults, ``bench_zero_shot`` and the demo in both
modes, with the ``gauges`` JSON line and the card's ``nvidia-smi`` line.

Usage (needs one GPU): python3 scripts/gauges_smoke.py
"""
import argparse
import glob
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    import torch

    import chip_smoke as cs
    from cppf_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        raise SystemExit("gauges_smoke: needs a GPU")
    smi = cs.smi_line()
    print(smi, flush=True)
    cuda_build.build(sorted(os.path.basename(p)[:-3] for p in
                            glob.glob(os.path.join(ROOT, "cppf_tpu_torch", "csrc", "*.cu"))))
    t0 = time.perf_counter()
    records, launches = cs.gauges_phase(smi)
    print(f"phase 18: {time.perf_counter() - t0:.1f} s; launches {launches}", flush=True)
    print(json.dumps(records, default=str), flush=True)


if __name__ == "__main__":
    main()
