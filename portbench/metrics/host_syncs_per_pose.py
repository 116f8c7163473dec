"""Host syncs (the program's ``prof.host_sync`` count: each place where the
host waits for the card, a read of a device value or a copy from pageable
host memory) per pose completed in the traced window: the syncs that the
root spans of the window (a ``pose`` in the stream cells, a ``frame`` of
the NOCS driver) recorded, over the poses."""
from portbench import spans as S


def read(rec):
    roots = [s for s in S.recorded() if s.parent is None]
    if not roots or rec.poses == 0:
        return None
    return sum(s.host_syncs for s in roots) / rec.poses
