"""Device milliseconds of the network per pose completed in the traced
window: the device intervals of the ``pose.network`` spans
(``pair_predictions``: SPRIN, the pair sample and the PPF head) summed.  A
span's device interval is the card's time between its two CUDA events: the
stage's work and any wait for the host inside it."""
from portbench import spans as S

NAMES = ("pose.network",)


def read(rec):
    return S.device_ms_per_pose(rec, NAMES)
