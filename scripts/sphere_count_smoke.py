"""Phase 22 of chip_smoke.py alone: build the kernels, then hold the axis
vote's sphere count (``cppf_tpu_torch/csrc/sphere_count.cu``) to its plain
version, to the bit, on the calls of bottle's and mug's view 0 at full
width, and time the kernel, the whole CUDA route and the plain version in
turns; prints the ``sphere_count`` JSON line with the card's ``nvidia-smi``
line.

Usage (needs one GPU): python3 scripts/sphere_count_smoke.py
"""
import argparse
import glob
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
        raise SystemExit("sphere_count_smoke: needs a GPU")
    smi = cs.smi_line()
    print(smi, flush=True)
    cuda_build.build(sorted(os.path.basename(p)[:-3] for p in
                            glob.glob(os.path.join(ROOT, "cppf_tpu_torch", "csrc", "*.cu"))))
    for kernel, usage in cuda_build.resource_usage("sphere_count").items():
        print(f"ptxas {kernel}: {usage}", flush=True)
        cs.check("0 bytes spill stores, 0 bytes spill loads" in usage, f"{kernel} spills")
    t0 = time.perf_counter()
    cs.sphere_count_phase(smi)
    print(f"phase 22: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
