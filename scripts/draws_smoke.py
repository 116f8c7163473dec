"""Phase 23 of chip_smoke.py alone: build the JAX-key draws' kernel
(``cppf_tpu_torch/csrc/threefry_draws.cu``; its registers and spills
printed), hold it to the plain path, to the bit, on one pose's requests of
``bottle.frames`` and of ``table.scans``, and time the kernel and the plain
path in turns; prints the ``draws`` JSON line with the card's
``nvidia-smi`` line.

Usage (needs one GPU): python3 scripts/draws_smoke.py
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("draws_smoke: needs a GPU")
    smi = cs.smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    cs.draws_phase(smi)
    print(f"phase 23: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
