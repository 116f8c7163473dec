"""Phases 16 and 17 of chip_smoke.py alone: build the kernels, then pose
the committed views at full width with the pose flags that no category
config turns on (against JAX's stored estimates, assets/flag_views.npz),
hold and time the votes front ends of the three kernels on sofa's gated
votes, compare the CPU and the card, run the two flag sets over 4 gloo
ranks of the card; then the entry points of cppf_tpu_torch/entry.py:
``entry()`` on the card, ``dryrun_multichip(4)`` over 4 gloo ranks of the
card, and the pair-sharded train step at bowl's training width on a (2, 2)
mesh against one rank.

Usage (needs one GPU): python3 scripts/flags_smoke.py
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
        raise SystemExit("flags_smoke: needs a GPU")
    smi = cs.smi_line()
    print(smi, flush=True)
    cuda_build.build(sorted(os.path.basename(p)[:-3] for p in
                            glob.glob(os.path.join(ROOT, "cppf_tpu_torch", "csrc", "*.cu"))))
    t0 = time.perf_counter()
    records, launches = cs.flags_phase(smi)
    print(f"phase 16: {time.perf_counter() - t0:.1f} s; launches {launches}", flush=True)
    print(json.dumps(records, default=str), flush=True)
    t0 = time.perf_counter()
    launches = cs.entry_phase(smi)
    print(f"phase 17: {time.perf_counter() - t0:.1f} s; entry() launches {launches}", flush=True)


if __name__ == "__main__":
    main()
