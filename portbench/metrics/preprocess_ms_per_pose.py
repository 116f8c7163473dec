"""Device milliseconds of preprocessing per pose completed in the traced
window: the device intervals of the ``pose.preprocess`` spans
(``CategoryRunner.preprocess``: the pad, the upload of the crop, the voxel
downsample, KNN and the normals) summed.  A span's device interval is the
card's time between its two CUDA events: the stage's work and any wait for
the host inside it."""
from portbench import spans as S

NAMES = ("pose.preprocess",)


def read(rec):
    return S.device_ms_per_pose(rec, NAMES)
