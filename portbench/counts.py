"""Operations, bytes and peaks: functions of a cell's shapes only, so that
they count the same work whatever implements it.

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W: 67 TFLOP/s
in float32 outside the tensor cores (the program keeps TF32 off) and
3.35 TB/s of HBM.  A roofline bound is the larger of bytes over the
bandwidth and operations over the float32 rate; each input byte is counted
read once and each output byte written once.
"""
from __future__ import annotations

FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12

PAIR_PARAM_BYTES = 48   # a pair's vote parameters: 12 float32
FRAME_BYTES = 28        # the grid's frame: 7 float32
WINDOW = 16             # the refine window's edge, in voxels
# operations a vote: make it (3 axes of 2 products, 2 sums, the corner, the
# division and 2 compares), its 3 floors and 3 fractions, and splat it into
# the three projections (6 hats, 3 weighted, 12 products, 12 adds, less the
# hats' shared terms: 31, the kernels' own tally)
BOUND_OPS_PER_VOTE = 3 * 8 + 6 + 31
# the window kernel's cull of a pair against the window's box
CULL_OPS_PER_PAIR = 20


def dense_flops(m: int, k: int, n: int) -> int:
    """A product of [m, k] by [k, n]: 2·m·k·n."""
    return 2 * m * k * n


def encoder_flops(cfg: dict) -> int:
    """The SPRIN encoder over every padded point and the pair head over
    every pair: 2·m·n·k of each linear layer and of the SPRIN contraction
    (one layer; the kernel MLP runs on each point's ``knn`` neighbours)."""
    n, k, p = cfg["npoint_pad"], cfg["knn"], cfg["n_pairs"]
    d, rank, f = 2, cfg["rank"], cfg["feat_dim"]
    widths = [6, *cfg["spfcs"], rank]
    flops = sum(dense_flops(n * k, a, b) for a, b in zip(widths[:-1], widths[1:]))
    flops += 2 * n * k * rank * d                 # einsum nkr,nki->nri
    flops += dense_flops(n, rank * d, f)          # outnet
    flops += dense_flops(n, f, f // 4)            # global info
    h = cfg["ppffcs"]
    for a, b in zip(h[:-1], h[1:]):
        flops += dense_flops(p, a, b) + dense_flops(p, b, b)
        if a != b:
            flops += dense_flops(p, a, b)         # the residual's projection
    flops += dense_flops(p, h[-1], cfg["out_dim"])
    return flops


def pool_factor(g: int) -> int:
    p = 1
    while g > 64 * p:
        p *= 2
    return p


def bound_pairs_work(cfg: dict):
    """(bytes, operations) of one ``bound_pairs_kernel`` launch: every
    pair's parameters and the frame read, the three projections written,
    every pair's ``num_rots`` votes made and splatted (each counted live)."""
    g = cfg["vote_grid"]
    cols = -(-g // pool_factor(g))
    n_out = 2 * g * cols + g * cols
    votes = cfg["n_pairs"] * cfg["num_rots"]
    return (PAIR_PARAM_BYTES * cfg["n_pairs"] + FRAME_BYTES + 4 * n_out,
            BOUND_OPS_PER_VOTE * votes)


def refine_pairs_work(cfg: dict):
    """(bytes, operations) of one ``refine_pairs_kernel`` launch: every
    pair's parameters and the frame read, the window written, every pair
    culled against the window (the votes inside it depend on the data and
    are not counted)."""
    return (PAIR_PARAM_BYTES * cfg["n_pairs"] + FRAME_BYTES + 4 * WINDOW ** 3,
            CULL_OPS_PER_PAIR * cfg["n_pairs"])


def bound_seconds(bytes_: float, ops: float):
    """(the roofline's least time, "bytes" or "operations": which bounds it)."""
    t_bytes, t_ops = bytes_ / HBM_BYTES, ops / FP32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
