"""The random draws a pose consumes, made by the benchmark.

For the stream cells the benchmark makes every request's draws itself, on
the device, from the seed, in a few large calls (:func:`pool_draws`); the
program and the reference are handed the same tensors.  For the frames
cell the program derives its draws from the frame's key, and the reference
works them out again from the same key (:func:`frame_draws`, on
``reference/threefry.py``), in the driver's key schedule: a category's
crops in chunks of ``max_batch`` (a chunk of two or more takes the next key
split from the frame's, and ``2·B_pad`` keys split from that: row i
preprocesses on key i and poses on key ``B_pad + i``), a crop alone takes
three keys (its own, and one the laptop's plane would use) and splits its
own into a preprocess key and a pose key.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference import threefry

Draws = Dict[str, torch.Tensor]
TINY = torch.finfo(torch.float32).tiny


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(torch.clamp(u, min=TINY)))


def pool_draws(cfg: dict, count: int, generator: torch.Generator, device) -> List[Draws]:
    """``count`` requests' draws from ``generator``: pair uniforms [P, 2],
    translation Gumbel noise [2, P, B], each axis's subsample uniforms [S]
    and angle-bin Gumbel noise [S, R], the fallback normal [3] and the
    preprocess jitter [npoint_max, 3], standard normal."""
    P, S, B, R = cfg["n_pairs"], cfg["rot_subsample"], cfg["tr_num_bins"], cfg["rot_num_bins"]
    axes = ("up", "right") if cfg["regress_right"] else ("up",)

    def rand(*shape):
        return torch.rand((count, *shape), generator=generator, device=device)

    def randn(*shape):
        return torch.randn((count, *shape), generator=generator, device=device)

    big = {"pair_u": rand(P, 2), "tr_gumbel": _gumbel(rand(2, P, B)), "fallback": randn(3),
           "jitter": randn(cfg["npoint_max"], 3)}
    for a in axes:
        big[a + "_sub"] = rand(S)
        big[a + "_gumbel"] = _gumbel(rand(S, R))
    return [{k: v[i] for k, v in big.items()} for i in range(count)]


def pose_keys(frame_key, n_crops: int, max_batch: int):
    """[(preprocess key, pose key)] of a frame's ``n_crops`` crops of one
    category, in the driver's order."""
    rng, out = frame_key, []
    if n_crops > 1:
        for k in range(0, n_crops, max_batch):
            n = min(max_batch, n_crops - k)
            rng, r_chunk = threefry.split(rng)
            pad = 1 << (n - 1).bit_length()
            keys = threefry.split(r_chunk, 2 * pad)
            out += [(keys[i], keys[pad + i]) for i in range(n)]
        return out
    rng, r_inst, _ = threefry.split(rng, 3)
    return [tuple(threefry.split(r_inst))]


def key_draws(cfg: dict, pre_key, pose_key, device) -> Draws:
    """The draws of one crop from its preprocess and pose keys."""
    P, S, B, R = cfg["n_pairs"], cfg["rot_subsample"], cfg["tr_num_bins"], cfg["rot_num_bins"]
    rng_pairs, rng_vote = threefry.split(pose_key)
    rng_tr, rng_up, rng_right, rng_fallback = threefry.split(rng_vote, 4)
    tr0, tr1 = threefry.split(rng_tr)
    d = {"pair_u": threefry.uniform(rng_pairs, (P, 2), device),
         "tr_gumbel": torch.stack([threefry.gumbel(tr0, (P, B), device),
                                   threefry.gumbel(tr1, (P, B), device)]),
         "fallback": threefry.normal(rng_fallback, (3,), device),
         "jitter": threefry.normal(pre_key, (cfg["npoint_max"], 3), device)}
    for name, k in (("up", rng_up), ("right", rng_right)):
        if name == "right" and not cfg["regress_right"]:
            continue
        rng_bin, rng_sub = threefry.split(k)
        d[name + "_sub"] = threefry.uniform(rng_sub, (S,), device)
        d[name + "_gumbel"] = threefry.gumbel(rng_bin, (S, R), device)
    return d


def frame_draws(cfg: dict, frame_key, n_crops: int, max_batch: int, device) -> List[Draws]:
    return [key_draws(cfg, pre, pose, device)
            for pre, pose in pose_keys(frame_key, n_crops, max_batch)]
