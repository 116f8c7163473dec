"""Phase 20 of chip_smoke.py alone: build the kernels, then serve the repo's
orbax checkpoints on the card with no JAX: all 33 read by
``cppf_tpu_torch/train/orbax.py`` (its zstd decoder built with ``g++`` at
first use) and held to their ``_METADATA`` and the ``.npz`` assets, the
laptop frame posed by the NOCS driver from ``checkpoints/laptop_aux`` as it
is committed, and ``eval_checkpoints --name best_decode`` on a JAX train
state; prints the ``orbax`` JSON line and the card's ``nvidia-smi`` line.

Usage (needs one GPU): python3 scripts/orbax_smoke.py
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
        raise SystemExit("orbax_smoke: needs a GPU")
    smi = cs.smi_line()
    print(smi, flush=True)
    cuda_build.build(sorted(os.path.basename(p)[:-3] for p in
                            glob.glob(os.path.join(ROOT, "cppf_tpu_torch", "csrc", "*.cu"))))
    t0 = time.perf_counter()
    launches = cs.orbax_phase(smi)
    print(f"phase 20: {time.perf_counter() - t0:.1f} s; launches {launches}", flush=True)


if __name__ == "__main__":
    main()
