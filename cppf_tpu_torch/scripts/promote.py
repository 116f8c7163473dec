"""Promote an experiment checkpoint to the production directory
(counterpart of scripts/promote.py), in the port's checkpoint layout.

A training run of the port (``train/loop.py``) writes ``params_best.npz``
(the weights the runner serves), ``config.yaml``, ``metrics.jsonl``,
``decode_metrics.jsonl`` and its train states ``<name>.pt`` (``best``,
``best_decode``, ``last``, ``epoch<n>``); a run of the JAX package writes
orbax directories ``<name>/`` instead (the repo's ``checkpoints/<cat>_r5*``).
The runner serves ``<ckpt_root>/<category>/params_best`` (the orbax
directory ``params_best/``, else ``params_best.npz``) with that
directory's ``config.yaml`` (``eval/nocs_inference.py``), so the promoted
state, whichever won its head-to-head eval, is installed under the name
``params_best``: an orbax state is read through the runner's loader
(``train/checkpoints.load_params``, so that a state that does not read is
refused) and its directory copied as ``params_best/``, as the JAX script
copies it; an ``.npz`` state is copied as ``params_best.npz``; a ``.pt``
train state's encoders are written as one.  The form not installed is
removed from the production directory, so that the runner cannot serve a
stale one (the previous state lives in git).  The config snapshot and the
metrics files are copied beside it.  The experiment directory is never
modified.

Usage:
    python -m cppf_tpu_torch.scripts.promote bathtub checkpoints_torch/bathtub \\
        [--name best_decode] [--ckpt_root checkpoints]
"""
from __future__ import annotations

import argparse
import os
import shutil

AUX_FILES = ("config.yaml", "metrics.jsonl", "decode_metrics.jsonl")


def promote(category: str, exp_dir: str, name: str, ckpt_root: str) -> str:
    """Installs the orbax directory ``<exp_dir>/<name>/`` as
    ``<ckpt_root>/<category>/params_best/``, else ``<exp_dir>/<name>.npz``
    (or the encoders of ``<exp_dir>/<name>.pt``) as
    ``<ckpt_root>/<category>/params_best.npz``, with the experiment's
    config and metrics; returns the installed path.  Raises
    ``FileNotFoundError`` when the state is missing, ``ValueError`` when an
    orbax state does not read."""
    orbax, npz, pt = (os.path.join(exp_dir, f"{name}{ext}") for ext in ("", ".npz", ".pt"))
    if not (os.path.isdir(orbax) or os.path.exists(npz) or os.path.exists(pt)):
        raise FileNotFoundError(f"promote: none of {orbax}/, {npz} or {pt} exists")
    prod = os.path.join(ckpt_root, category)
    os.makedirs(prod, exist_ok=True)
    orbax_dst, dst = os.path.join(prod, "params_best"), os.path.join(prod, "params_best.npz")
    if os.path.isdir(orbax):
        from cppf_tpu_torch.train.checkpoints import load_params

        load_params(exp_dir, name)
        if os.path.isdir(orbax_dst):
            shutil.rmtree(orbax_dst)
        shutil.copytree(orbax, orbax_dst)
        if os.path.exists(dst):
            os.remove(dst)
        dst = orbax_dst
    elif os.path.exists(npz):
        shutil.copy2(npz, dst)
    else:
        import torch

        from cppf_tpu_torch.config import load_config
        from cppf_tpu_torch.models.convert import make_encoders, save_npz_params

        snap = os.path.join(exp_dir, "config.yaml")
        cfg = load_config(category, snapshot=snap if os.path.exists(snap) else None)
        point, ppf = make_encoders(cfg.out_dim)
        saved = torch.load(pt, map_location="cpu", weights_only=True)
        point.load_state_dict(saved["point"], strict=True)
        ppf.load_state_dict(saved["ppf"], strict=True)
        save_npz_params(dst, point, ppf)
    if dst != orbax_dst and os.path.isdir(orbax_dst):
        shutil.rmtree(orbax_dst)
    for aux in AUX_FILES:
        src = os.path.join(exp_dir, aux)
        if os.path.exists(src):
            shutil.copy2(src, os.path.join(prod, aux))
    return dst


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("category")
    ap.add_argument("exp_dir")
    ap.add_argument("--name", default="best_decode",
                    help="which saved state to promote (best_decode | params_best | ...)")
    ap.add_argument("--ckpt_root", default="checkpoints")
    a = ap.parse_args(argv)
    try:
        dst = promote(a.category, a.exp_dir, a.name, a.ckpt_root)
    except (FileNotFoundError, ValueError) as e:
        raise SystemExit(str(e))
    print(f"promoted {a.name} of {a.exp_dir} -> {dst} (+ config/metrics)")
    print("now: update checkpoints/MANIFEST.md and commit both together")
    return dst


if __name__ == "__main__":
    main()
