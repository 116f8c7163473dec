"""Launches of the axis vote's sphere-count kernel (``csrc/sphere_count.cu``,
counted by the program's ``ops/vote_hist.py::LAUNCHES["sphere_count"]``)
per pose completed in the window: one an axis voted, so 1 a bottle pose and
2 a mug pose (up and right).  None where the program has no such counter
or never launched it (a program whose sphere count is plain PyTorch)."""


def read(rec):
    n = rec.counters.get("sphere_count", 0)
    if n == 0 or rec.poses == 0:
        return None
    return n / rec.poses
