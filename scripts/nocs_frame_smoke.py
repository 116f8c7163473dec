"""Phase 10 of chip_smoke.py alone: build the kernels, then run the NOCS
REAL275 driver and eval on the committed frame (assets/nocs_frame) at full
width on the card, against the stored JAX driver's output (about 30 s,
against chip_smoke.py's 5 minutes).

Usage (needs one GPU): python3 scripts/nocs_frame_smoke.py [--profile]
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
    ap.add_argument("--profile", action="store_true", help="profile one warm frame")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from cppf_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        raise SystemExit("nocs_frame_smoke: needs a GPU")
    print(cs.smi_line(), flush=True)
    cuda_build.build(sorted(os.path.basename(p)[:-3] for p in
                            glob.glob(os.path.join(ROOT, "cppf_tpu_torch", "csrc", "*.cu"))))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cs.nocs_driver_phase(tmp, args.profile)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
