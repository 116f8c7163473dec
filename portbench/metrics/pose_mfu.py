"""The pose's share of the card's float32 peak, %: the encoders' operations
a pose (``counts.encoder_flops``, from the cell's shapes) times the poses
completed in the traced window, over the seconds in which the device ran
an operation there (``busy_s``, from the trace) times 67 TFLOP/s.  The
device's time is the whole pose's, every kernel of it, and is not slowed
by the profiler as the host's clock is; ``device_idle_share`` reads the
rest of the window."""
from portbench import counts


def read(rec):
    t = rec.trace
    if rec.poses == 0 or t is None or t.busy_s <= 0:
        return None
    return 100.0 * counts.encoder_flops(rec.cfg) * rec.poses / (t.busy_s * counts.FP32_FLOPS)
