"""Device milliseconds of the back-votes and the axis votes per pose
completed in the traced window: the device intervals of the
``pose.backvote`` spans (after each center pass) and the ``pose.axis_vote``
spans (each axis's subsample, cone votes, sphere count and sign) summed.  A
span's device interval is the card's time between its two CUDA events: the
stage's work and any wait for the host inside it."""
from portbench import spans as S

NAMES = ("pose.backvote", "pose.axis_vote")


def read(rec):
    return S.device_ms_per_pose(rec, NAMES)
