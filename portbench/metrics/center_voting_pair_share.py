"""The share of the pairs the center gate reads that it lets vote, %: the
program's device counters ``center_pairs_voting`` over
``center_pairs_gated``, every gated center pass of the traced window.  A
change that reads lower votes with fewer pairs than the model's gate keeps."""
from portbench import counters


def read(rec):
    pairs = counters.center_pairs()
    if pairs is None:
        return None
    gated, voting = pairs
    return 100.0 * voting / gated
