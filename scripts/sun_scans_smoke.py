"""Phase 11 of chip_smoke.py alone: build the kernels, then run the SUN RGB-D
driver and eval on the committed scans (assets/sun_scans) at full width on
the card, against the stored JAX driver's output.

Usage (needs one GPU): python3 scripts/sun_scans_smoke.py [--profile]
"""
import argparse
import glob
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true", help="profile one warm pass of the loop")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from cppf_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        raise SystemExit("sun_scans_smoke: needs a GPU")
    print(cs.smi_line(), flush=True)
    cuda_build.build(sorted(os.path.basename(p)[:-3] for p in
                            glob.glob(os.path.join(ROOT, "cppf_tpu_torch", "csrc", "*.cu"))))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cs.sun_driver_phase(tmp, args.profile)
    print(f"phase 11: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
