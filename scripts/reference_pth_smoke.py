"""Phase 19 of chip_smoke.py alone: build the kernels, then serve the
reference CPPF's ``.pth`` checkpoints on the card: bowl's and mug's weights
as the upstream pair ``{point,ppf}_encoder_epochbest.pth`` posed on the
committed views against the ``.npz``-served poses (to the bit), the
zero-shot CLI from ``bowl_reg``'s ``params_zs`` as a pair against the
``.npz``-served run, and a torchvision-keyed segmenter through
``fcn_resnet50_from_torch``, CPU against CUDA; prints the
``reference_pth`` JSON line and the card's ``nvidia-smi`` line.

Usage (needs one GPU): python3 scripts/reference_pth_smoke.py
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
        raise SystemExit("reference_pth_smoke: needs a GPU")
    smi = cs.smi_line()
    print(smi, flush=True)
    cuda_build.build(sorted(os.path.basename(p)[:-3] for p in
                            glob.glob(os.path.join(ROOT, "cppf_tpu_torch", "csrc", "*.cu"))))
    t0 = time.perf_counter()
    launches = cs.reference_pth_phase(smi)
    print(f"phase 19: {time.perf_counter() - t0:.1f} s; launches {launches}", flush=True)


if __name__ == "__main__":
    main()
