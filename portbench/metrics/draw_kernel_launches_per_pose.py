"""Launches of the JAX-key draws' kernel (``csrc/threefry_draws.cu``) per
pose completed in the traced window: the program's device counter
``draw_kernel_launches`` (``core/threefry.py``, one a launch, counted while
a profiler runs) over the poses, 1.0 where each pose's draws are one launch.
None where the program has no such counter or never launched the kernel (a
program whose draws are plain PyTorch)."""
from portbench import counters


def read(rec):
    n = counters.recorded().get("draw_kernel_launches", 0)
    if n <= 0 or rec.poses == 0:
        return None
    return n / rec.poses
