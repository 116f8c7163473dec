"""Zero-shot whole-frame heatmap timer (counterpart of
scripts/bench_zero_shot.py).

Times both routes of ``eval/zero_shot.zero_shot_heatmap`` on the committed
demo frame with the committed regression checkpoint, each call synchronised:

- ``sparse=True``: the pool-8 coarse grid, then exact 48³ windows around
  its candidates (``dense_hist_pairs`` on each);
- ``sparse=False``: the dense route, the whole frame's grid through the
  global ``dense_hist_pairs`` kernel, one launch a 2^20-pair chunk.

The JSON keys name the routes (``sparse_s``, ``dense_s``, their
``*_first_s``), where the JAX script's name the TPU's implementations
(``sparse_pallas``, ``xla_scatter``).  A route's time is the median of
``--repeat`` calls after the first; the first call is reported apart.
Each call is the whole stage 1-3 (prep, network, heatmap, its copy to the
host).

Usage:
    python -m cppf_tpu_torch.scripts.bench_zero_shot [--n_pairs 5000000] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from cppf_tpu_torch.config import REPO_ROOT
from cppf_tpu_torch.data.png import read_png
from cppf_tpu_torch.device import pin_float32, resolve_device
from cppf_tpu_torch.utils.prof import sync

DEMO_DEPTH = os.path.join(REPO_ROOT, "data", "demo", "0000_depth.png")
ROUTES = {"both": (True, False), "sparse": (True,), "dense": (False,)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default=os.path.join(REPO_ROOT, "checkpoints", "bowl_reg"))
    ap.add_argument("--depth", default=DEMO_DEPTH, help="uint16 millimetre depth PNG")
    ap.add_argument("--n_pairs", type=int, default=5_000_000)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--routes", default="both", choices=sorted(ROUTES),
                    help="which heatmap routes to time")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; never falls back to the CPU)")
    return ap


def main(argv=None):
    """Times the routes; prints the JSON line and returns its dict."""
    from cppf_tpu_torch.eval.zero_shot import CLI_NAMES, zero_shot_heatmap
    from cppf_tpu_torch.models.convert import load_encoders
    from cppf_tpu_torch.scripts.zero_shot_benchmark import load_zero_shot

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    pin_float32()
    depth = read_png(args.depth)
    cfg, params = load_zero_shot(args.ckpt, names=CLI_NAMES)
    encoders = load_encoders(params, 9, device)

    out = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "n_pairs": args.n_pairs}
    for sparse in ROUTES[args.routes]:
        ts = []
        for i in range(args.repeat + 1):
            sync(device)
            t0 = time.perf_counter()
            hm = zero_shot_heatmap(depth, encoders, cfg, n_pairs=args.n_pairs, sparse=sparse,
                                   seed=i, device=device)
            sync(device)
            ts.append(time.perf_counter() - t0)
        key = "sparse" if sparse else "dense"
        out[key + "_s"] = float(np.median(ts[1:])) if args.repeat else None
        out[key + "_first_s"] = ts[0]
        out["grid_dims"] = [int(x) for x in hm.dims]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
