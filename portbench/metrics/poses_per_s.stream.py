"""Poses completed on the host per second of the traced window, in the
cells whose end-to-end metric is ``pose_ms_p95`` (the stream cells): the
rate there, read beside the latency, since on a shared host it spreads too
widely from run to run to be held to a bound."""


def read(rec):
    if rec.poses == 0 or rec.window_s <= 0:
        return None
    return rec.poses / rec.window_s
