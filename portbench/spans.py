"""The program's spans (``cppf_tpu_torch/utils/prof.py``) for the per-layer
metrics that read them.  The program records a span only while a torch
profiler runs, which in a run of the benchmark is the traced window alone
(the warm-up runs before it); a program without the recorder gives none, and
each metric then reads nothing."""
from __future__ import annotations


def recorded() -> list:
    """The finished spans the program holds, or [] where it has no
    recorder."""
    from cppf_tpu_torch.utils import prof

    read = getattr(prof, "spans", None)
    return read() if read is not None else []


def device_ms_per_pose(rec, names):
    """The device intervals of the spans named in ``names`` summed, in ms,
    over the poses completed in the window; None where no such span has
    one."""
    if rec.poses == 0:
        return None
    found = [s.device_s for s in recorded() if s.name in names and s.device_s is not None]
    return 1e3 * sum(found) / rec.poses if found else None
