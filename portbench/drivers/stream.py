"""Driver ``stream``: one crop a request through ``CategoryRunner.estimate``.

Set-up makes a pool of crops (``gen.py``) and each crop's draws on the
device (``draws.pool_draws``); the window cycles through the pool with one
client in a closed loop: a request is the call with the crop and its draws
and the copy of its pose to the host, and the next starts when that copy
has landed.  After the window a sample of the pool entries that were served,
drawn from the seed, with the largest crop served among them, is handed to
the reference with every distinct pose the program gave for it.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import draws as D
from portbench import gen

FIELDS = ("T", "R", "scale", "up", "right", "n_filtered", "grid_max")
SIZES = (3, 9, 3, 3, 3, 1, 1)


def to_pose_draws(d):
    from cppf_tpu_torch.pipeline.pose import AxisDraws, PoseDraws

    right = AxisDraws(d["right_sub"], d["right_gumbel"]) if "right_sub" in d else None
    return PoseDraws(d["pair_u"], d["tr_gumbel"], AxisDraws(d["up_sub"], d["up_gumbel"]),
                     d["fallback"], d["jitter"], right)


def unpack(row: np.ndarray) -> dict:
    out, at = {}, 0
    for name, n in zip(FIELDS, SIZES):
        out[name] = row[at:at + n].copy() if n > 1 else float(row[at])
        at += n
    return out


class Served:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, mix = ctx.cfg, ctx.mix
        rng = np.random.default_rng([ctx.seed, 1])
        self.crops = gen.make_crops(cfg["category"], mix, cfg["scale_range"], mix["pool"], rng)
        gen_t = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
        self.draws = D.pool_draws(cfg, mix["pool"], gen_t, ctx.device)
        self.pose_draws = [to_pose_draws(d) for d in self.draws]
        self.runner = ctx.make_runner()
        self.served = {}
        self.i = 0

    def _pose(self, k: int) -> np.ndarray:
        out, _ = self.runner.estimate(self.crops[k], draws=self.pose_draws[k])
        return torch.cat([getattr(out, f).reshape(-1).float() for f in FIELDS]).cpu().numpy()

    def warm(self):
        for k in range(min(self.ctx.mix["warm"], len(self.crops))):
            self._pose(k)

    def step(self):
        k = self.i % len(self.crops)
        self.i += 1
        t0 = time.perf_counter()
        row = self._pose(k)
        dt = time.perf_counter() - t0
        self.served.setdefault(k, {})[row.tobytes()] = row
        return dt, 1

    def free(self):
        self.runner = self.pose_draws = None

    def judged(self, rng: np.random.Generator):
        """[(crop, draws, [pose dicts])] of the sample."""
        keys = sorted(self.served)
        n = min(self.ctx.mix["judge"], len(keys))
        pick = set(rng.choice(keys, n, replace=False).tolist()) if n else set()
        if keys:
            pick.add(max(keys, key=lambda k: len(self.crops[k])))
        items = [(self.crops[k], self.draws[k], [unpack(r) for r in self.served[k].values()])
                 for k in sorted(pick)]
        self.draws = None
        return items


def make(ctx):
    return Served(ctx)
