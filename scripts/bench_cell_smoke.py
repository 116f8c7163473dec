"""Phase 21 of chip_smoke.py alone: build the kernels, then pose bench.py's
main cell on the card at full width (``cppf_tpu_torch/scripts/bench_cell.py``:
bottle, 100 000 pairs, 4 keys with nearest and with trilinear splat, the
B = 4 batch with nearest splat) and hold every pose to JAX's stored
estimates (``cppf_tpu_torch/assets/bench_cell.npz``), the launches of the
peak kernels to their rule and CPU to CUDA at 20 000 pairs; prints the
``bench_cell`` JSON line and the card's ``nvidia-smi`` line.

Usage (needs one GPU): python3 scripts/bench_cell_smoke.py
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
        raise SystemExit("bench_cell_smoke: needs a GPU")
    smi = cs.smi_line()
    print(smi, flush=True)
    cuda_build.build(sorted(os.path.basename(p)[:-3] for p in
                            glob.glob(os.path.join(ROOT, "cppf_tpu_torch", "csrc", "*.cu"))))
    t0 = time.perf_counter()
    launches = cs.bench_cell_phase(smi)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s; launches {launches}", flush=True)


if __name__ == "__main__":
    main()
