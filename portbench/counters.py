"""The program's device counters (``cppf_tpu_torch/utils/prof.py``
``device_count``) for the per-layer metrics that read them.  The program adds
to them only while a torch profiler runs, which in a run of the benchmark is
the traced window alone; a program without them gives none, and each metric
then reads nothing."""
from __future__ import annotations


def recorded() -> dict:
    """{name: total} of the program's device counters, or {} where it has
    none."""
    from cppf_tpu_torch.utils import prof

    read = getattr(prof, "device_counters", None)
    return read() if read is not None else {}


def center_pairs():
    """(pairs the center gate read, pairs it let vote), summed over every
    gated center pass of the window, or None where the program counted
    none."""
    c = recorded()
    gated = c.get("center_pairs_gated", 0)
    if gated <= 0:
        return None
    return float(gated), float(c.get("center_pairs_voting", 0))
