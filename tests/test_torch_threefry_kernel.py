"""The JAX-key draws' kernel (``cppf_tpu_torch/csrc/threefry_draws.cu``)
and its request table.

On the CPU: the table that ``core/threefry.py::draw_many`` hands the kernel
(offsets, kinds, uint32 key words, each kind's ``lo``/``hi`` in float32,
the bernoulli rows last), the kernel's arithmetic on that table in plain
numpy and torch against ``draw_many_plain`` to the bit, the constants of
the source, and the CPU route.  On the card (``cuda`` marker; skips
elsewhere): the kernel against ``draw_many_plain`` on the same CUDA device,
with ``torch.equal``, for every kind at ragged sizes, for the pose draws at
the benchmark configurations' full widths and for a trainer's batch, whose
requests fill more than one table; and one launch a pose.  No JAX here:
``python -m pytest --noconftest -m cuda tests/test_torch_threefry_kernel.py``
runs it on the card.
"""
import math
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from cppf_tpu_torch.core import threefry
from cppf_tpu_torch.pipeline.pose import PoseDraws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "cppf_tpu_torch", "csrc", "threefry_draws.cu")
TINY = np.float32(np.finfo(np.float32).tiny)
ABOVE_MINUS_ONE = np.nextafter(np.float32(-1.0), np.float32(0.0))
KINDS = ("uniform", "gumbel", "normal", "bernoulli")

torch.set_num_threads(1)


def _mixed_requests():
    keys = threefry.split(threefry.key(2**32 - 3), 7)
    return [("bernoulli", keys[0], (5, 1)), ("normal", keys[1], (3,)),
            ("gumbel", keys[2], (17, 36)), ("uniform", keys[3], (0, 2)),
            ("bernoulli", keys[4], (1000,)), ("uniform", keys[5], ()),
            ("normal", keys[6], (1023, 3))]


def test_table_packs_the_requests():
    reqs = _mixed_requests()
    t = threefry.draw_table(reqs)
    assert t.order == [1, 2, 3, 5, 6, 0, 4]  # the bernoulli rows last, each side in order
    assert t.n_float == 5
    sizes = [3, 17 * 36, 0, 1, 1023 * 3, 5, 1000]
    assert t.starts.dtype == np.int64 and t.starts.tolist() == [0, *np.cumsum(sizes).tolist()]
    assert t.keys.dtype == np.uint32 and t.keys.shape == (7, 2)
    assert t.keys.tolist() == [list(reqs[j][1]) for j in t.order]
    assert t.kinds.dtype == np.int32 and t.kinds.tolist() == [2, 1, 0, 0, 2, 0, 0]
    assert t.lo.dtype == t.hi.dtype == np.float32
    want = {"uniform": (0.0, 1.0), "bernoulli": (0.0, 1.0), "gumbel": (TINY, 1.0),
            "normal": (ABOVE_MINUS_ONE, 1.0)}
    for r, j in enumerate(t.order):
        lo, hi = want[reqs[j][0]]
        assert t.lo[r] == np.float32(lo) and t.hi[r] == np.float32(hi), reqs[j][0]
    assert t.lo.flags.c_contiguous and t.hi.flags.c_contiguous


def test_table_takes_keys_of_32_bits():
    t = threefry.draw_table([("uniform", (0xFFFFFFFF, 0x80000000), (2,))])
    assert t.keys.tolist() == [[0xFFFFFFFF, 0x80000000]]
    with pytest.raises(OverflowError):
        threefry.draw_table([("uniform", (1 << 32, 0), (2,))])
    with pytest.raises(ValueError, match="unknown draw kind"):
        threefry.draw_table([("poisson", (0, 1), (2,))])


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _kernel_bits(k0, k1, c0, c1):
    """threefry_draws.cu's ``threefry_bits``, its unrolled key schedule
    written out the same way, in numpy uint32 (wrapping) arithmetic."""
    k2 = k0 ^ k1 ^ np.uint32(0x1BD11BDA)
    ks = (k0, k1, k2)
    x0, x1 = c0 + k0, c1 + k1
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    for g, (a, b) in enumerate(((1, 2), (2, 0), (0, 1), (1, 2), (2, 0))):
        for rot in rotations[g % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, rot) ^ x0
        x0 = x0 + ks[a]
        x1 = x1 + ks[b] + np.uint32(g + 1)
    return x0 ^ x1


def _kernel_on_table(t):
    """What the kernel writes for table ``t``, element for element: each
    element's row by the last start at or below it, its counter, the hash,
    the uniform on the row's [lo, hi), the row's kind."""
    total = int(t.starts[-1])
    i = np.arange(total, dtype=np.int64)
    r = np.searchsorted(t.starts[:-1], i, side="right") - 1
    c = (i - t.starts[r]).astype(np.uint64)
    bits = _kernel_bits(t.keys[r, 0], t.keys[r, 1], (c >> np.uint64(32)).astype(np.uint32),
                        (c & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    f = torch.from_numpy(((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)) - 1.0
    lo, hi = torch.from_numpy(t.lo[r]), torch.from_numpy(t.hi[r])
    u = torch.maximum(lo, f * (hi - lo) + lo)
    kind = torch.from_numpy(t.kinds[r])
    gumbel = -torch.log(-torch.log(u))
    normal = torch.tensor(math.sqrt(2), dtype=torch.float32) * threefry.erfinv(u)
    return torch.where(kind == 1, gumbel, torch.where(kind == 2, normal, u))


@pytest.mark.parametrize("which", ["mixed", "one of each kind"])
def test_kernel_arithmetic_on_the_table_equals_the_plain_draws(which):
    reqs = (_mixed_requests() if which == "mixed" else
            [(kind, threefry.key(40 + n), (2000, 3)) for n, kind in enumerate(KINDS)])
    t = threefry.draw_table(reqs)
    out = _kernel_on_table(t)
    want = threefry.draw_many_plain(reqs, "cpu")
    for r, j in enumerate(t.order):
        got = out[int(t.starts[r]):int(t.starts[r + 1])].view(reqs[j][2])
        if reqs[j][0] == "bernoulli":
            got = got < 0.5
        assert got.dtype == want[j].dtype and torch.equal(got, want[j]), reqs[j][0]


def test_kernel_source_constants():
    """The source's table size is ``MAX_REQUESTS``, and its float literals
    are the plain version's erfinv coefficients (less-than-5 branch, then
    the other) and √2, each rounded to float32 as torch rounds them."""
    with open(SOURCE) as f:
        src = f.read()
    assert int(re.search(r"kMaxRequests = (\d+);", src).group(1)) == threefry.MAX_REQUESTS
    literals = [float(v) for v in re.findall(r"static_cast<float>\(([-+0-9.e]+)\)", src)]
    assert literals == [*threefry._ERFINV_LT5, *threefry._ERFINV_GE5, math.sqrt(2)]


def test_cpu_tensors_take_the_plain_route():
    reqs = _mixed_requests()
    before = dict(threefry.LAUNCHES)
    got = threefry.draw_many(reqs, "cpu")
    want = threefry.draw_many_plain(reqs, "cpu")
    assert threefry.LAUNCHES == before
    for (kind, _, shape), g, w in zip(reqs, got, want):
        assert g.shape == tuple(shape) and torch.equal(g, w), kind


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launches(fn):
    before = threefry.LAUNCHES["draws"]
    out = fn()
    torch.cuda.synchronize()
    return out, threefry.LAUNCHES["draws"] - before


def _equal(got, want, what):
    assert len(got) == len(want)
    for n, (g, w) in enumerate(zip(got, want)):
        assert g.device == w.device and g.dtype == w.dtype and g.shape == w.shape, (what, n)
        assert torch.equal(g, w), (f"{what}, draw {n}: {int((g != w).sum())} of {w.numel()} "
                                   f"elements differ")


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1, 3, 1023, 100_003])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_equals_plain(cuda, kind, size):
    reqs = [(kind, threefry.key(size), (size,))]
    got, n = _launches(lambda: threefry.draw_many(reqs, cuda))
    assert n == 1
    _equal(got, threefry.draw_many_plain(reqs, cuda), f"{kind} x {size}")


@pytest.mark.cuda
def test_kernel_equals_plain_on_mixed_requests(cuda):
    reqs = _mixed_requests()
    got, n = _launches(lambda: threefry.draw_many(reqs, cuda))
    assert n == 1
    _equal(got, threefry.draw_many_plain(reqs, cuda), "mixed")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bottle", "mug", "table"])
def test_pose_draws_at_full_width(cuda, name, monkeypatch):
    """``PoseDraws.from_jax_keys`` at the benchmark configuration's widths,
    with the pair key and the preprocess key: one launch, every draw the
    plain version's."""
    pcfg, n_raw = chip_smoke.draw_pose_config(name)
    pre_key, pose_key = threefry.split(threefry.key(3_000_000_017 & 0xFFFFFFFF))
    got, n = _launches(lambda: PoseDraws.from_jax_keys(pcfg, pre_key, pose_key, cuda, n_raw))
    assert n == 1
    elements = (3 + 2 * pcfg.n_pairs * pcfg.tr_num_bins + 2 * pcfg.n_pairs + 3 * n_raw
                + (1 + pcfg.regress_right) * pcfg.rot_subsample * (1 + pcfg.rot_num_bins))
    assert elements == {"bottle": 13_400_003, "mug": 7_370_003, "table": 13_770_003}[name]
    monkeypatch.setattr(threefry, "draw_many", threefry.draw_many_plain)
    want = PoseDraws.from_jax_keys(pcfg, pre_key, pose_key, cuda, n_raw)
    flat = lambda d: [d.pair_u, d.tr_gumbel, *d.up, d.fallback_normal, d.jitter,
                      *(d.right or ())]
    _equal(flat(got), flat(want), name)


@pytest.mark.cuda
def test_trainer_batch_fills_two_tables(cuda, monkeypatch):
    """The trainer's ``BatchDraws.from_jax_key`` at full width, batch 32:
    96 requests, one launch a ``MAX_REQUESTS`` of them, the bernoulli signs
    among them."""
    from cppf_tpu_torch.config import load_config
    from cppf_tpu_torch.train.loop import BatchDraws

    cfg = load_config("bottle")
    key = threefry.fold_in(threefry.key(7), 3)
    got, n = _launches(lambda: BatchDraws.from_jax_key(key, 32, cfg, cuda))
    assert n == math.ceil(96 / threefry.MAX_REQUESTS) == 2
    monkeypatch.setattr(threefry, "draw_many", threefry.draw_many_plain)
    _equal(list(got), list(BatchDraws.from_jax_key(key, 32, cfg, cuda)), "trainer batch")
