"""Launches of the center vote's peak kernels (the pairs front ends of
``bound_projections`` and ``refine_window``, counted by the program's
``ops/vote_hist.py::LAUNCHES``) per pose completed in the window: one bound
and one to ``peak_rounds`` refine launches a center pass."""

NAMES = ("bound_projections_pairs", "refine_window_pairs")


def read(rec):
    n = sum(rec.counters.get(k, 0) for k in NAMES)
    if n == 0 or rec.poses == 0:
        return None
    return n / rec.poses
