"""The center vote's peak kernels against their roofline, %, counting the
pairs that really vote: as ``vote_kernels_roofline``, but each launch's
least time from the work of the pairs the center gate let vote.  A pair of
weight 0 costs ``bound_pairs_kernel`` and ``refine_pairs_kernel`` the load of
its first 16 bytes alone (``load_pair`` in ``csrc/vote_hist.cu``): no vote,
no cull.  So a launch's bytes are 16 a dead pair and 48 a live one, with the
frame and the output, and its operations those of ``counts.py`` at the live
pairs; the live pairs a pass are the program's device counter
``center_pairs_voting`` over the gated passes (``center_pairs_gated`` ÷
``n_pairs``).  None where the program counts no gated pass."""
from portbench import counters, counts

DEAD_PAIR_BYTES = 16
KERNELS = (("bound_pairs_kernel", counts.bound_pairs_work),
           ("refine_pairs_kernel", counts.refine_pairs_work))


def live_work(cfg: dict, work, live: float):
    """(bytes, operations) of one launch of ``work``'s kernel on a pass of
    ``cfg["n_pairs"]`` pairs of which ``live`` vote."""
    dead = cfg["n_pairs"] - live
    bytes_, ops = work({**cfg, "n_pairs": live})
    return bytes_ + DEAD_PAIR_BYTES * dead, ops


def read(rec):
    t, pairs = rec.trace, counters.center_pairs()
    if t is None or pairs is None:
        return None
    gated, voting = pairs
    live = voting / (gated / rec.cfg["n_pairs"])
    bound_s = device_s = 0.0
    for key, work in KERNELS:
        least, _ = counts.bound_seconds(*live_work(rec.cfg, work, live))
        for name, (launches, seconds) in t.kernels.items():
            if key in name:
                bound_s += launches * least
                device_s += seconds
    if device_s <= 0:
        return None
    return 100.0 * bound_s / device_s
