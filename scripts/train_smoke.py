"""Phase 12 of chip_smoke.py alone: build the kernels, then train bowl at
full width on the card (one epoch of 20 steps with a decode validation,
a fixed batch, CPU against CUDA, the committed params' decode validation,
the served checkpoint, both peak kernels at a decode-val pose's shapes).

Usage (needs one GPU): python3 scripts/train_smoke.py [--profile]
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
    ap.add_argument("--profile", action="store_true", help="profile one warm loop step")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from cppf_tpu_torch.device import pin_float32
    from cppf_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        raise SystemExit("train_smoke: needs a GPU")
    smi = cs.smi_line()
    print(smi, flush=True)
    cuda_build.build(sorted(os.path.basename(p)[:-3] for p in
                            glob.glob(os.path.join(ROOT, "cppf_tpu_torch", "csrc", "*.cu"))))
    pin_float32()
    t0 = time.perf_counter()
    cs.training_phase(smi, args.profile)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
