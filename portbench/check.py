"""The comparison that decides ``correct``.

The reference the configuration names (``reference/<name>.py``, by
default ``pose``, loaded by ``run.load_reference``) judges every distinct
pose the program gave for each sampled request (:func:`judge_items`); a
cell's limits file (``limits/<workload>.json``) names its compared
numbers, each the largest over the sample of the largest of its parts
(``of``), with a limit and the readings it was set from.  A run is correct when every
number is within its limit, every request attempted was answered and at
least one was judged.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List


def judge_items(ref, cfg: dict, weights, items) -> List[Dict[str, float]]:
    """The numbers of the reference module ``ref`` for each pose of
    ``items`` [(crop, draws, [pose dicts])]."""
    out = []
    for crop, draws, poses in items:
        p = ref.prepare(cfg, weights, crop, draws)
        out += [ref.judge(p, draws, pose) for pose in poses]
    return out


def load_limits(root: str, workload: str) -> dict:
    with open(os.path.join(root, "limits", f"{workload}.json")) as f:
        return json.load(f)["numbers"]


def numbers(limits: dict, judged: List[Dict[str, float]]) -> Dict[str, float]:
    """Each compared number: the largest of its parts over ``judged``."""
    return {name: max((j[k] for j in judged for k in spec["of"] if k in j), default=0.0)
            for name, spec in limits.items()}


def verdict(limits: dict, nums: Dict[str, float], attempted: int, failed: int,
            n_judged: int) -> bool:
    return (failed == 0 and attempted > 0 and n_judged > 0
            and all(nums[k] <= spec["limit"] for k, spec in limits.items()))


def lines(limits: dict, nums: Dict[str, float]) -> Dict[str, list]:
    """{name: [number, limit]} for the result line and the last lines of
    standard error."""
    return {k: [nums[k], spec["limit"]] for k, spec in limits.items()}
