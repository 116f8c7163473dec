"""The readings a cell's limits are set from (``limits/<workload>.json``):
the program's numbers on many seeds, and its control's.

    python3 -m portbench.calibrate --workload <name> --seeds <n>,<n>,... [--out FILE]

For each seed the cell's requests are made as a run makes them, every one
is served once through the timed path, and the run's sample of them is
judged by the reference the configuration names, as after a window; the
readings are the largest of each of the reference's numbers over the
sample.  The control is the reference itself put in the program's place at
the nearest precision below the configuration's: float32 products in TF32
(``allow_tf32``), its own poses judged by the reference in float32.  Beside
them, a witness of a sound program whose float32 sums run in another order:
the reference with its dense layers written ``x @ kernel + bias`` in place
of ``linear``, judged the same way; and how far each moves the translation
logits from the reference's own.  One line of JSON a seed, and a last
line with each number's lower reading (the program's largest over the
seeds), upper reading (the control's smallest) and the witness's largest.
Needs the card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from portbench import check
from portbench import run as R
from portbench.reference import model


def readings(judged):
    keys = sorted({k for j in judged for k in j})
    return {k: max(j[k] for j in judged if k in j) for k in keys}


def _matmul_dense(w, prefix, x):
    return x @ w[prefix + "/kernel"] + w[prefix + "/bias"]


@contextlib.contextmanager
def _variant(tf32: bool, reorder: bool):
    dense = model.dense
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    if reorder:
        model.dense = _matmul_dense
    try:
        yield
    finally:
        model.dense = dense
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def stand_in_numbers(ref, cfg, weights, items, tf32=False, reorder=False):
    """The numbers of the reference module ``ref`` for its own poses made in
    TF32 (``tf32``, the control) or with reordered dense layers
    (``reorder``, the witness), put in the program's place; and the largest
    gap of their translation logits (``prepare(...).preds``) to its own."""
    out, diff = [], 0.0
    B = cfg["tr_num_bins"]
    for crop, draws, _ in items:
        base = ref.prepare(cfg, weights, crop, draws)
        with _variant(tf32, reorder):
            q = ref.prepare(cfg, weights, crop, draws)
            est = ref.estimate(q, draws)
        diff = max(diff, float((q.preds[:, :2 * B] - base.preds[:, :2 * B]).abs().max()))
        del q
        out.append(ref.judge(base, draws, est))
    return out, diff


def control_numbers(ref, cfg, weights, items):
    return stand_in_numbers(ref, cfg, weights, items, tf32=True)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return R.EXIT_NO_CHIP
    device = torch.device("cuda")
    bench = R.load_benchmark(os.path.join(os.path.dirname(R.ROOT), "BENCHMARK.json"))
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    cfg = R.load_json("configs", cell["config"])
    mix = R.load_json("traffic", cell["traffic"])
    try:
        ref = R.load_reference(cfg)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return R.EXIT_CONFIG
    driver = R.load_module("drivers", mix["driver"])
    weights = model.load_weights(os.path.join(R.ROOT, cfg["weights"]), device)
    runner = None
    lows, ups, wits, lines = {}, {}, {}, []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = R.Ctx(cell, cfg, mix, seed, device, {})
        if runner is not None:
            ctx.make_runner = lambda build=None, r=runner: r
        served = driver.make(ctx)
        runner = served.runner
        for _ in range(mix["pool"]):
            served.step()
        items = served.judged(np.random.default_rng([seed, 3]))
        t1 = time.perf_counter()
        prog = readings(check.judge_items(ref, cfg, weights, items))
        t2 = time.perf_counter()
        ctrl, ctrl_diff = stand_in_numbers(ref, cfg, weights, items, tf32=True)
        ctrl = readings(ctrl)
        t3 = time.perf_counter()
        wit, wit_diff = stand_in_numbers(ref, cfg, weights, items, reorder=True)
        wit = readings(wit)
        line = {"workload": args.workload, "seed": seed, "judged_requests": len(items),
                "serve_s": t1 - t0, "judge_s": t2 - t1, "control_s": t3 - t2,
                "program": prog, "control": ctrl, "reordered": wit,
                "logit_gap": {"control": ctrl_diff, "reordered": wit_diff}}
        print(json.dumps(line), flush=True)
        lines.append(line)
        for k, v in prog.items():
            lows[k] = max(lows.get(k, 0.0), v)
        for k, v in ctrl.items():
            ups[k] = min(ups.get(k, float("inf")), v)
        for k, v in wit.items():
            wits[k] = max(wits.get(k, 0.0), v)
    summary = {"workload": args.workload, "seeds": len(lines), "lower": lows, "upper": ups,
               "reordered": wits}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
