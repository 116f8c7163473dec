"""Multi-category training sweep (counterpart of cppf_tpu/train/multirun.py).

In place of the reference's Hydra multirun (``python train.py -m
category=bowl,mug,...``: independent processes, reference README.md:102):
train several categories one after another in this process, or with
``parallel=true`` as one ``python -m cppf_tpu_torch.train.loop`` process
each, all started together.  Every other ``key=value`` goes to each run
as it is, ``device=`` and ``epoch_len=`` included; each runs on ``cuda``
unless ``device=cpu``.

Usage:
    python -m cppf_tpu_torch.train.multirun categories=bowl,mug,can [max_epoch=...]
        [parallel=true] [out_root=checkpoints_torch] [device=cpu]

``out_root`` defaults to the repo's ``checkpoints_torch/`` (gitignored), a
run writing ``<out_root>/<category>``.
"""
from __future__ import annotations

import logging
import os
import subprocess
import sys

from cppf_tpu_torch.config import REPO_ROOT, load_config, parse_cli_overrides

log = logging.getLogger("cppf_tpu_torch.multirun")

NOCS_DEFAULT = ["bottle", "bowl", "camera", "can", "laptop", "mug"]


def main(argv=None):
    """Returns the processes' combined exit code with ``parallel=true``,
    else each category's ``train`` result by category."""
    logging.basicConfig(level=logging.INFO, force=True)
    argv = argv if argv is not None else sys.argv[1:]
    overrides = parse_cli_overrides([a for a in argv if "=" in a])
    cats = overrides.pop("categories", None)
    if isinstance(cats, str):
        cats = cats.split(",")
    cats = cats or NOCS_DEFAULT
    out_root = overrides.pop("out_root", os.path.join(REPO_ROOT, "checkpoints_torch"))
    run_parallel = bool(overrides.pop("parallel", False))

    if run_parallel:
        procs = []
        for cat in cats:
            cmd = [sys.executable, "-m", "cppf_tpu_torch.train.loop", f"category={cat}",
                   f"out_dir={os.path.join(out_root, cat)}"]
            cmd += [f"{k}={v}" for k, v in overrides.items()]
            log.info("spawn: %s", " ".join(cmd))
            procs.append(subprocess.Popen(cmd))
        rc = 0
        for p in procs:
            rc |= p.wait()
        return rc

    from cppf_tpu_torch.train.loop import train

    device = overrides.pop("device", None)
    epoch_len = overrides.pop("epoch_len", None)
    out = {}
    for cat in cats:
        cfg = load_config(cat, dict(overrides))
        log.info("=== training %s ===", cat)
        out[cat] = train(cfg, out_dir=os.path.join(out_root, cat), epoch_len=epoch_len,
                         device=device)
    return out


if __name__ == "__main__":
    rc = main()
    sys.exit(rc if isinstance(rc, int) else 0)
