"""``launches_per_pose`` in the cells that ``pose_ms_p95`` judges (the stream cells):
the same reader, named apart because there it moves the latency and not
``poses_per_s``."""
from portbench.metrics.launches_per_pose import read  # noqa: F401
