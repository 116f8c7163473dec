"""Kernel launches in the traced window (the profiler's kernel count) per
pose completed in it."""


def read(rec):
    t = rec.trace
    if t is None or not t.kernels or rec.poses == 0:
        return None
    return sum(count for count, _ in t.kernels.values()) / rec.poses
