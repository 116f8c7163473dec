"""Phase 14 of chip_smoke.py alone: build the kernels, then train the laptop
segmenter on the card for about 45 s, serve it, and run the NOCS driver's
laptop override on the committed laptop frame (assets/nocs_laptop_frame),
against the stored JAX run and against the CPU.

Usage (needs one GPU): python3 scripts/laptop_smoke.py [--profile]
"""
import argparse
import glob
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true", help="profile one warm train step")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from cppf_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        raise SystemExit("laptop_smoke: needs a GPU")
    smi = cs.smi_line()
    print(smi, flush=True)
    cuda_build.build(sorted(os.path.basename(p)[:-3] for p in
                            glob.glob(os.path.join(ROOT, "cppf_tpu_torch", "csrc", "*.cu"))))
    t0 = time.perf_counter()
    records, launches = cs.laptop_phase(smi, args.profile)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s; launches {launches}", flush=True)
    print(records, flush=True)


if __name__ == "__main__":
    main()
