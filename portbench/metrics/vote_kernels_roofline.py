"""The center vote's peak kernels against their roofline, %: the sum of
their launches' least times (``counts.py``, from the cell's shapes) over
the sum of their device times in the trace."""
from portbench import counts

KERNELS = (("bound_pairs_kernel", counts.bound_pairs_work),
           ("refine_pairs_kernel", counts.refine_pairs_work))


def read(rec):
    t = rec.trace
    if t is None:
        return None
    bound_s = device_s = 0.0
    for key, work in KERNELS:
        least, _ = counts.bound_seconds(*work(rec.cfg))
        for name, (launches, seconds) in t.kernels.items():
            if key in name:
                bound_s += launches * least
                device_s += seconds
    if device_s <= 0:
        return None
    return 100.0 * bound_s / device_s
