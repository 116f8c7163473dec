"""The device trace of a measured window: torch.profiler's CUDA activity
(kernels, copies and sets on the device, the CUDA runtime calls on the
host), reduced to what the per-layer metrics read.

- ``busy_s``: the length of the union of the device's operation intervals;
- ``kernels``: {kernel name: [launches, device seconds]} (copies and sets
  are device operations but not kernels);
- ``device_ops``: the ten operations that took most device time;
- ``idle_gaps``: the device's idle time summed by what the host was in at
  the gap (the CUDA runtime call that spans the gap's middle, else "host
  work between CUDA calls") and the kernel that ended it; the ten largest.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

HOST_WORK = "host work between CUDA calls"


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: Dict[str, List[float]] = field(default_factory=dict)
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def _times(e):
    """(start ns, duration ns) of a kineto event, whichever its API."""
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.duration_ns()
    return e.start_us() * 1000, e.duration_us() * 1000


def summarize(events, window_s: float, top: int = 10) -> TraceSummary:
    """Reduce kineto events (``prof.profiler.kineto_results.events()``)."""
    dev_start, dev_end, dev_name = [], [], []
    host_start, host_end, host_name = [], [], []
    for e in events:
        s, d = _times(e)
        if str(e.device_type()).endswith("CUDA"):
            dev_start.append(s)
            dev_end.append(s + d)
            dev_name.append(e.name())
        elif e.name().startswith(("cuda", "cu")):
            host_start.append(s)
            host_end.append(s + d)
            host_name.append(e.name())
    if not dev_start:
        return TraceSummary(window_s, 0.0)
    start = np.asarray(dev_start, np.int64)
    end = np.asarray(dev_end, np.int64)
    order = np.argsort(start, kind="stable")
    start, end = start[order], end[order]
    names = [dev_name[i] for i in order]
    reach = np.maximum.accumulate(end)
    gap = np.zeros(len(start), np.int64)
    gap[1:] = np.maximum(start[1:] - reach[:-1], 0)
    busy_s = float((reach[-1] - start[0] - gap.sum()) / 1e9)

    kernels: Dict[str, List[float]] = {}
    ops: Dict[str, float] = {}
    for n, s, t in zip(names, start, end):
        ops[n] = ops.get(n, 0.0) + (t - s) / 1e9
        if _is_kernel(n):
            k = kernels.setdefault(n, [0, 0.0])
            k[0] += 1
            k[1] += (t - s) / 1e9
    device_ops = sorted(([n[:120], v] for n, v in ops.items()), key=lambda x: -x[1])[:top]

    gaps: Dict[str, float] = {}
    at = np.nonzero(gap > 0)[0]
    mids = (reach[at - 1] + start[at]) // 2
    host = np.full(len(at), -1, np.int64)
    if host_start:
        hs = np.asarray(host_start, np.int64)
        he = np.asarray(host_end, np.int64)
        horder = np.argsort(hs, kind="stable")
        hs, he = hs[horder], he[horder]
        j = np.searchsorted(hs, mids, side="right") - 1
        inside = (j >= 0) & (he[np.maximum(j, 0)] >= mids)
        host = np.where(inside, horder[np.maximum(j, 0)], -1)
    for i, h in zip(at.tolist(), host.tolist()):
        key = f"{host_name[h] if h >= 0 else HOST_WORK}, then {names[i][:80]}"
        gaps[key] = gaps.get(key, 0.0) + gap[i] / 1e9
    idle = sorted(([k, v] for k, v in gaps.items()), key=lambda x: -x[1])[:top]
    return TraceSummary(window_s, busy_s, kernels, device_ops, idle)


class DeviceTrace:
    """``with DeviceTrace() as t:`` profiles the CUDA activity of the block;
    ``t.summary`` is its :class:`TraceSummary` afterwards."""

    def __init__(self):
        self.summary = None

    def __enter__(self):
        import time

        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time

        import torch

        torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(self._prof.profiler.kineto_results.events(), window_s)
        return False
