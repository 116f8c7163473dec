"""Driver ``scans``: SUN RGB-D scans of one category through the program's
SUN RGB-D driver, ``eval/sunrgbd_inference.py``: its runner
(``load_runner``, the driver's defaults: the gravity prior, the scale
without the NOCS factor 2) and its loop over a scan's instances
(``pose_instances``).

Set-up makes a pool of scans, as many of each count of instances in
``instances_per_scan`` (the instances of the whole pool from ``gen.work``,
their diagonals in ``diagonal_m``, the tables of the scans, in place of the
checkpoint's training ``scale_range``), each scan with a key split from the
seed's.  The window cycles through the pool with one client in a closed
loop: a request is one ``pose_instances`` call, which splits a key off the
scan's for each instance in turn, makes its draws on the card from it
(``runner.draws``), poses it through ``CategoryRunner.estimate`` and copies
its scale, R and T to the host; the next request starts when it has
returned.  After the window a sample of the scans that were served, drawn
from the seed, with the scan of most points among them, goes to the
reference, which works each instance's draws out again from the same keys
(``draws.key_draws``).
"""
from __future__ import annotations

import os
import time

import numpy as np

from portbench import draws as D
from portbench import gen
from portbench.reference import threefry

CHECKPOINTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "checkpoints")


def build(category: str):
    """``build(device)`` of the category's runner through the SUN driver's
    own entry, at the driver's defaults."""
    def make(device):
        from cppf_tpu_torch.eval import sunrgbd_inference as S

        args = S.build_parser().parse_args(["--device", str(device),
                                            "--ckpt_path", CHECKPOINTS])
        return S.load_runner(category, args)
    return make


def pose_of(row) -> dict:
    """T, R, scale, up, right of a row [class_id, score, s(3), R(9), T(3)]."""
    row = np.asarray(row, np.float32)
    R = row[5:14].reshape(3, 3)
    return {"T": row[14:17].copy(), "R": R, "scale": row[2:5].copy(), "up": R[:, 1].copy(),
            "right": R[:, 0].copy()}


def instance_keys(scan_key, n: int):
    """[(preprocess key, pose key)] of a scan's ``n`` instances, in the SUN
    driver's order: a key split off the scan's for each, and that one split
    in two as ``CategoryRunner.draws`` splits it."""
    rng, out = scan_key, []
    for _ in range(n):
        rng, r_inst = threefry.split(rng)
        out.append(tuple(threefry.split(r_inst)))
    return out


class Served:
    def __init__(self, ctx):
        from cppf_tpu_torch.eval.sunrgbd_inference import TYPE2CLASS

        self.ctx = ctx
        cfg, mix = ctx.cfg, ctx.mix
        rng = np.random.default_rng([ctx.seed, 4])
        lo, hi = mix["instances_per_scan"]
        # every seed: the same instance counts a scan and the same instance
        # sizes, in an order of its own
        counts = rng.permutation(np.resize(np.arange(lo, hi + 1), mix["pool"]))
        crops = gen.make_crops(cfg["category"], mix, mix["diagonal_m"], int(counts.sum()), rng)
        ends = np.cumsum(counts)
        self.scans = [crops[e - c:e] for c, e in zip(counts, ends)]
        self.keys = threefry.split(threefry.key_of_seed(ctx.seed), mix["pool"])
        self.class_id = TYPE2CLASS[cfg["category"]]
        self.runner = ctx.make_runner(build(cfg["category"]))
        self.served = {}
        self.i = 0

    def _scan(self, s: int) -> np.ndarray:
        from cppf_tpu_torch.eval.sunrgbd_inference import pose_instances

        rows, _, _ = pose_instances(self.runner, list(enumerate(self.scans[s])), self.keys[s],
                                    self.class_id)
        return np.asarray(rows, np.float32)

    def warm(self):
        for s in range(min(self.ctx.mix["warm"], len(self.scans))):
            self._scan(s)

    def step(self):
        s = self.i % len(self.scans)
        self.i += 1
        t0 = time.perf_counter()
        rows = self._scan(s)
        dt = time.perf_counter() - t0
        self.served.setdefault(s, {})[rows.tobytes()] = rows
        return dt, len(self.scans[s])

    def free(self):
        self.runner = None

    def judged(self, rng: np.random.Generator):
        """[(crop, draws, [pose dicts])] of each instance of the sample."""
        keys = sorted(self.served)
        n = min(self.ctx.mix["judge"], len(keys))
        pick = set(rng.choice(keys, n, replace=False).tolist()) if n else set()
        if keys:
            pick.add(max(keys, key=lambda s: sum(len(c) for c in self.scans[s])))
        items = []
        for s in sorted(pick):
            crops = self.scans[s]
            for i, (pre, pose) in enumerate(instance_keys(self.keys[s], len(crops))):
                draws = D.key_draws(self.ctx.cfg, pre, pose, self.ctx.device)
                poses = [pose_of(rows[i]) for rows in self.served[s].values()]
                items.append((crops[i], draws, poses))
        return items


def make(ctx):
    return Served(ctx)
