"""Device milliseconds of the center vote's gate per pose completed in the
traced window: the device intervals of the ``pose.center_gate`` spans (the
coplanar test of every pair and the 5 % guard, ``center_vote_masks``; the
program opens the span only where a gate is on) summed."""
from portbench import spans as S

NAMES = ("pose.center_gate",)


def read(rec):
    return S.device_ms_per_pose(rec, NAMES)
