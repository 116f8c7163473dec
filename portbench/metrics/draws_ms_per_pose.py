"""Device milliseconds of the JAX-key draws per pose completed in the traced
window: the device intervals of the ``draws`` spans
(``PoseDraws.from_jax_keys``, the NOCS driver's draws made on the card from
its keys) summed.  A span's device interval is the card's time between its
two CUDA events: the stage's work and any wait for the host inside it."""
from portbench import spans as S

NAMES = ("draws",)


def read(rec):
    return S.device_ms_per_pose(rec, NAMES)
