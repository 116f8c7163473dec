"""Phase 13 of chip_smoke.py alone: build the kernels, then the pair-sharded
pose of bowl and mug on their committed views over 4 gloo ranks of one
card, bowl over NCCL with one rank a card, the data-parallel train step on
2 gloo ranks, and both peak kernels on rank 0's shard; prints the kernels'
JSON line of the phase.

Usage (needs a GPU): python3 scripts/parallel_smoke.py
"""
import glob
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch

    import chip_smoke as cs
    from cppf_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        raise SystemExit("parallel_smoke: needs a GPU")
    smi = cs.smi_line()
    print(smi, flush=True)
    # built once here, before any rank starts, so that no two ranks build
    cuda_build.build(sorted(os.path.basename(p)[:-3] for p in
                            glob.glob(os.path.join(ROOT, "cppf_tpu_torch", "csrc", "*.cu"))))
    t0 = time.perf_counter()
    records, launches, per_rank = cs.parallel_phase(smi)
    print(f"phase 13: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": [
        dict(name=name, path="pair-sharded pose (phase 13)",
             launches=launches[name + "_pairs"],
             launches_per_rank={c: [r[name + "_pairs"] for r in ranks]
                                for c, ranks in per_rank.items()},
             **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")})
        for name, rec in records.items()]}))


if __name__ == "__main__":
    main()
