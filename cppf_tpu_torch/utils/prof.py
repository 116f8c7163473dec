"""Profiling helpers (counterpart of cppf_tpu/utils/prof.py): a
``torch.profiler`` trace written as a Chrome trace, and wall-clock timers
that wait for the card."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch


def sync(device=None) -> None:
    """Wait for the card (``device``'s, default every one) before a host
    clock is read; nothing to wait for on the CPU."""
    dev = None if device is None else torch.device(device)
    if (dev is None or dev.type == "cuda") and torch.cuda.is_available():
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and the
    card's where CUDA is available) and write its Chrome trace to
    ``<log_dir>/trace.json`` (open it in Perfetto or chrome://tracing).
    Yields the profiler; its ``key_averages()`` give the sums by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 1, **kwargs) -> float:
    """Steady-state seconds a call (host clock; waits for the card before
    and after the timed calls)."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    sync()
    return (time.perf_counter() - t0) / iters


def component_times(fns: Dict[str, Callable], iters: int = 5) -> Dict[str, float]:
    return {name: time_fn(fn, iters=iters) for name, fn in fns.items()}
