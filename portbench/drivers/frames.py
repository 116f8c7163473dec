"""Driver ``frames``: frames of one category's crops through the NOCS
driver's ``infer_frame``, on the draws it derives from each frame's key.

Set-up makes a pool of frames, as many of each count of crops in
``crops_per_frame`` (the crops of the whole pool from ``gen.work``),
each frame with a key split from the seed's; the window cycles through the
pool with one client in a closed loop: a request is one ``infer_frame``
call (the driver chunks the crops, poses a chunk through
``estimate_batch`` and a lone crop through ``estimate``, each on
``runner.draws`` of its keys, and copies the poses to the host), and the
next starts when it has returned.  After the window a sample of the frames
that were served, drawn from the seed, with the frame of most points among
them, goes to the reference, which works each crop's draws out again from
the frame's key (``draws.frame_draws``).
"""
from __future__ import annotations

import time

import numpy as np

from portbench import draws as D
from portbench import gen
from portbench.reference import threefry


def pose_of(RT: np.ndarray, scale_unit: np.ndarray) -> dict:
    """T, R, scale, up, right of a driver row: RT = [R·|s| | T]."""
    norm = float(np.linalg.norm(RT[:3, 1]))
    R = RT[:3, :3] / norm
    return {"T": RT[:3, 3].copy(), "R": R, "scale": scale_unit * norm, "up": R[:, 1].copy(),
            "right": R[:, 0].copy()}


class Served:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, mix = ctx.cfg, ctx.mix
        rng = np.random.default_rng([ctx.seed, 2])
        lo, hi = mix["crops_per_frame"]
        # every seed: the same crop counts a frame and the same crop sizes,
        # in an order of its own
        counts = rng.permutation(np.resize(np.arange(lo, hi + 1), mix["pool"]))
        crops = gen.make_crops(cfg["category"], mix, cfg["scale_range"], int(counts.sum()), rng)
        ends = np.cumsum(counts)
        self.frames = [crops[e - c:e] for c, e in zip(counts, ends)]
        self.keys = threefry.split(threefry.key_of_seed(ctx.seed), mix["pool"])
        self.runner = ctx.make_runner()
        self.served = {}
        self.i = 0

    def _frame(self, f: int):
        from cppf_tpu_torch.eval.nocs_inference import infer_frame

        crops = self.frames[f]
        cat = self.ctx.cfg["category"]
        RTs, scales, _, _ = infer_frame({cat: list(enumerate(crops))}, len(crops),
                                        {cat: self.runner}, self.keys[f],
                                        max_batch=self.ctx.mix["max_batch"])
        return RTs, scales

    def warm(self):
        for f in range(min(self.ctx.mix["warm"], len(self.frames))):
            self._frame(f)

    def step(self):
        f = self.i % len(self.frames)
        self.i += 1
        t0 = time.perf_counter()
        RTs, scales = self._frame(f)
        dt = time.perf_counter() - t0
        row = np.concatenate([RTs.reshape(-1), scales.reshape(-1)]).astype(np.float32)
        self.served.setdefault(f, {})[row.tobytes()] = (RTs, scales)
        return dt, len(self.frames[f])

    def free(self):
        self.runner = None

    def judged(self, rng: np.random.Generator):
        keys = sorted(self.served)
        n = min(self.ctx.mix["judge"], len(keys))
        pick = set(rng.choice(keys, n, replace=False).tolist()) if n else set()
        if keys:
            pick.add(max(keys, key=lambda f: sum(len(c) for c in self.frames[f])))
        items = []
        for f in sorted(pick):
            crops = self.frames[f]
            draws = D.frame_draws(self.ctx.cfg, self.keys[f], len(crops),
                                  self.ctx.mix["max_batch"], self.ctx.device)
            for i, crop in enumerate(crops):
                poses = [pose_of(RTs[i], scales[i]) for RTs, scales in self.served[f].values()]
                items.append((crop, draws[i], poses))
        return items


def make(ctx):
    return Served(ctx)
