"""Device milliseconds of the center vote per pose completed in the traced
window: the device intervals of the ``pose.center_vote`` spans, every pass
(``ppf_vote_peak``: the bound pass and its refine rounds), summed.  A span's
device interval is the card's time between its two CUDA events: the stage's
work and any wait for the host inside it."""
from portbench import spans as S

NAMES = ("pose.center_vote",)


def read(rec):
    return S.device_ms_per_pose(rec, NAMES)
