"""Phase 15 of chip_smoke.py alone: build the kernels, then score the
committed zero-shot weights on the proposal-contrast val scene against the
stored JAX run, train the regression head on the card with a validation an
epoch, and run the zero-shot CLI at full width on the demo frame.

Usage (needs one GPU): python3 scripts/zero_shot_train_smoke.py
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
        raise SystemExit("zero_shot_train_smoke: needs a GPU")
    smi = cs.smi_line()
    print(smi, flush=True)
    cuda_build.build(sorted(os.path.basename(p)[:-3] for p in
                            glob.glob(os.path.join(ROOT, "cppf_tpu_torch", "csrc", "*.cu"))))
    t0 = time.perf_counter()
    records, launches = cs.zero_shot_train_phase(smi)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s; trainer launches {launches}", flush=True)
    print(json.dumps({k: {f: v for f, v in r.items() if not isinstance(v, torch.Tensor)}
                      for k, r in records.items()}, default=str), flush=True)


if __name__ == "__main__":
    main()
