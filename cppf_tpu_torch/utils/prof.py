"""Profiling (counterpart of cppf_tpu/utils/prof.py): a ``torch.profiler``
trace written as a Chrome trace; spans at the layer boundaries of the pose
path, recorded while a torch profiler runs; and a count of the places where
the host waits for the card.

Spans.  ``with span("pose.center_vote", **{"pass": 1}):`` marks a stage.
While a torch profiler runs (``trace`` below, or any other ``torch.profiler``
profile; checked when the span is entered) the span records its name, its
attributes, its parent and the id of its root span (the request), its host
start and end on ``time.time_ns()`` (CLOCK_REALTIME, the clock the
profiler stamps its events with), the host syncs counted while it was open,
and on the card a CUDA event on the current stream at entry and at exit:
the stream runs in order, so the time between the two is the card's time
from the end of the work queued before the stage to the end of the stage's
own (its *device interval*, busy or waiting on the host).  It also opens
``torch.profiler.record_function(name)``, so a trace with CPU activity shows
each stage above the kernels it launched.  Without a profiler a span is one
shared object that records nothing.  :func:`spans` gives the finished spans
and :func:`clear_spans` drops them; they stay in memory.

Host syncs.  :func:`host_sync` is called where the host blocks on the card:
a CUDA tensor read on the host (``bool``, ``int``, ``.item()``, ``.cpu()``,
a boolean mask's indices) or a copy to the card from pageable host memory
(``torch.tensor(..., device=cuda)``, ``.to(cuda)`` of a host tensor), which
``copy_`` ends with a stream sync.  ``COUNTERS["host_syncs"]`` is the
running total; each open span records how much it rose while it was open.

Device counters.  ``device_count(name, t)`` adds ``t`` (a 0-d tensor on the
card, or a host number) to the running total ``name``, kept where ``t`` is,
while a torch profiler runs; it reads nothing on the host.
:func:`device_counters` reads the totals once, after the profiled work, and
:func:`clear_device_counters` drops them.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import List, Optional

import torch

COUNTERS = {"host_syncs": 0}


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
    ``<log_dir>/trace.json`` (open it in Perfetto or chrome://tracing): the
    spans of the block show as ranges of their names.  Yields the profiler;
    its ``key_averages()`` give the sums by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def host_sync(device=None, n: int = 1) -> None:
    """Count ``n`` places where the host waits for the card.  ``device`` is
    the card's side of the read or the copy: a CPU device counts nothing
    (the same code runs there without waiting); None counts."""
    if device is None or torch.device(device).type == "cuda":
        COUNTERS["host_syncs"] += n


class Span:
    """A finished (or open) recorded span; see the module docstring."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "start_ns", "end_ns", "host_syncs",
                 "_syncs0", "_range", "_events")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.end_ns = None
        self.host_syncs = 0
        self._events = None

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.id = next(_IDS)
        self.parent = parent.id if parent else None
        self.root = parent.root if parent else self.id
        self.start_ns = time.time_ns()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._events = (start, torch.cuda.Event(enable_timing=True))
        self._syncs0 = COUNTERS["host_syncs"]
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        self.host_syncs = COUNTERS["host_syncs"] - self._syncs0
        if self._events is not None:
            self._events[1].record()
        self._range.__exit__(*exc)
        self.end_ns = time.time_ns()
        _SPANS.append(self)
        return False

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def device_s(self) -> Optional[float]:
        """The device interval in seconds (waits for the exit event); None
        where the span recorded no CUDA events."""
        if self._events is None:
            return None
        start, end = self._events
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, root={self.root}, "
                f"host_syncs={self.host_syncs}, attrs={self.attrs})")


class _NoSpan:
    """What :func:`span` returns while no profiler runs: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_SPANS: List[Span] = []
_IDS = itertools.count(1)
_LOCAL = threading.local()


def _stack() -> List[Span]:
    stack = _LOCAL.__dict__.get("stack")
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def recording() -> bool:
    """Whether a torch profiler runs: spans and device counters record."""
    return torch.autograd._profiler_enabled()


def span(name: str, **attrs):
    """A span of the stage ``name`` (a context manager), recorded only while
    a torch profiler runs."""
    if not recording():
        return _NO_SPAN
    return Span(name, attrs)


_DEVICE_TOTALS: dict = {}


def device_count(name: str, t) -> None:
    """Add ``t`` (a 0-d tensor, or a number) to the device counter ``name``
    while a torch profiler runs: an add where ``t`` lives, no host read."""
    if recording():
        total = _DEVICE_TOTALS.get(name)
        _DEVICE_TOTALS[name] = t if total is None else total + t


def device_counters() -> dict:
    """{name: total} of the device counters, each read once on the host."""
    return {k: v.item() if torch.is_tensor(v) else v for k, v in _DEVICE_TOTALS.items()}


def clear_device_counters() -> None:
    _DEVICE_TOTALS.clear()


def annotate(**attrs) -> None:
    """Add attributes to the innermost open recorded span, if any: what a
    stage learns only as it runs (a refine loop's rounds)."""
    stack = _LOCAL.__dict__.get("stack")
    if stack:
        stack[-1].attrs.update(attrs)


def spans() -> List[Span]:
    """The finished spans, in the order they were opened."""
    return sorted(_SPANS, key=lambda s: s.id)


def clear_spans() -> None:
    _SPANS.clear()
