"""Export a stored JAX run of the synthetic quality gauges for the PyTorch
port's card check (``chip_smoke.py`` phase 18 (b)).

Runs the JAX package's gauge scripts here on the CPU at small settings and
writes what they produced into ``cppf_tpu_torch/assets/gauge_runs.npz``:

- NOCS (``scripts/synthetic_benchmark.py``): ``bowl,mug,can``, 2 frames of
  2 instances each and 1 clutter object, ``--seed 0``, the driver on the
  repo's checkpoints at full width.  Keys ``nocs_frames`` (the written
  frame indices), per frame ``nocs_RTs_<f>``, ``nocs_scales_<f>`` (the
  driver's ``pred_RTs``, ``pred_scales``) and ``nocs_class_ids_<f>``, and
  the eval's ``nocs_iou_aps`` [7, 101], ``nocs_pose_aps`` [7, 3, 3].
- SUN RGB-D (``scripts/sunrgbd_synthetic_benchmark.py``): ``table``, 2
  scans of 2 instances, ``--seed 0``, the 30° up prior.  Keys
  ``sun_scans``, per scan ``sun_rows_<scan>`` [k, 17] (the driver's rows:
  class, score, extents, R, T), ``sun_iou_aps``, ``sun_pose_aps``
  [2, 12, 6].
- zero-shot (``scripts/zero_shot_benchmark.py``): ``bowl``, 2 frames of 2
  instances, 1 000 000 pairs, ``--seed 0``, ``checkpoints/bowl_reg``'s
  ``params_zs``.  Keys ``zs_frames``, per frame ``zs_RTs_<f>``,
  ``zs_scales_<f>``, ``zs_scores_<f>`` (the detections as the eval pkls
  hold them), ``zs_iou_aps``, ``zs_pose_aps``.

``settings`` holds the arguments as JSON, which the card check passes to
the port's scripts.

Usage (needs JAX and cv2; ~5 min on the CPU):
    JAX_PLATFORMS=cpu python scripts/export_torch_gauge_assets.py
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import pickle
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
OUT = os.path.join(ROOT, "cppf_tpu_torch", "assets", "gauge_runs.npz")
SETTINGS = {
    "nocs": {"category": "bowl,mug,can", "n_frames": 2, "instances": 2, "clutter": 1,
             "seed": 0},
    "sun": {"category": "table", "n_scans": 2, "instances": 2, "seed": 0,
            "up_prior_deg": 30.0},
    "zs": {"category": "bowl", "n_frames": 2, "instances": 2, "clutter": 0,
           "n_pairs": 1_000_000, "seed": 0},
}


def _pkls(pred_dir: str) -> dict:
    """{frame index: result pkl} of a NOCS-format prediction directory."""
    out = {}
    for name in sorted(os.listdir(pred_dir)):
        if name.startswith("results_") and name.endswith(".pkl"):
            with open(os.path.join(pred_dir, name), "rb") as f:
                out[int(name[-8:-4])] = pickle.load(f)
    return out


def nocs_run(tmp: str) -> dict:
    from cppf_tpu.eval import nocs_eval, nocs_inference
    from synthetic_benchmark import make_frames

    s = SETTINGS["nocs"]
    seg_dir, nocs_dir = make_frames(tmp, s["category"], s["n_frames"], s["seed"],
                                    instances=s["instances"], clutter=s["clutter"])
    pred_dir = os.path.join(tmp, "pred")
    nocs_inference.main(["--seg_dir", seg_dir, "--nocs_dir", nocs_dir, "--out_dir", pred_dir,
                         "--ckpt_path", os.path.join(ROOT, "checkpoints"),
                         "--seed", str(s["seed"])])
    with contextlib.redirect_stdout(io.StringIO()):
        iou_aps, pose_aps = nocs_eval.main(["--pred_dir", pred_dir, "--subsample", "1"])[:2]
    out = {"nocs_iou_aps": iou_aps, "nocs_pose_aps": pose_aps}
    pkls = _pkls(pred_dir)
    out["nocs_frames"] = np.asarray(sorted(pkls), np.int32)
    for f, r in pkls.items():
        out[f"nocs_RTs_{f}"] = r["pred_RTs"]
        out[f"nocs_scales_{f}"] = r["pred_scales"]
        out[f"nocs_class_ids_{f}"] = r["pred_class_ids"]
    return out


def sun_run(tmp: str) -> dict:
    from cppf_tpu.data.sunrgbd_synth import make_scans
    from cppf_tpu.eval import sunrgbd_eval, sunrgbd_inference
    from cppf_tpu.eval.sunrgbd_inference import TYPE2CLASS

    s = SETTINGS["sun"]
    sun_dir, extra_dir = os.path.join(tmp, "OFFICIAL_SUNRGBD"), os.path.join(tmp, "extra")
    pred_dir = os.path.join(tmp, "pred")
    names = make_scans(sun_dir, extra_dir, s["category"], TYPE2CLASS[s["category"]],
                       s["n_scans"], instances=s["instances"], seed=s["seed"])
    sunrgbd_inference.main(["--sunrgbd_dir", sun_dir, "--sunrgbd_extra_dir", extra_dir,
                            "--out_dir", pred_dir,
                            "--ckpt_path", os.path.join(ROOT, "checkpoints"),
                            "--categories", s["category"], "--seed", str(s["seed"]),
                            "--up_prior_deg", str(s["up_prior_deg"])])
    with contextlib.redirect_stdout(io.StringIO()):
        aps = sunrgbd_eval.main(["--pred_dir", pred_dir, "--sunrgbd_dir", sun_dir,
                                 "--sunrgbd_extra_dir", extra_dir,
                                 "--categories", s["category"]])[s["category"]]
    with open(os.path.join(pred_dir, f"results_{s['category']}.pkl"), "rb") as f:
        rows = pickle.load(f)
    out = {"sun_iou_aps": aps[0], "sun_pose_aps": aps[1],
           "sun_scans": np.asarray([int(n) for n in names], np.int32)}
    for name in names:
        out[f"sun_rows_{name}"] = np.asarray(rows.get(name, []), np.float64).reshape(-1, 17)
    return out


def zero_shot_run(tmp: str) -> dict:
    from cppf_tpu.eval import nocs_eval
    from zero_shot_benchmark import main as zs_main

    s = SETTINGS["zs"]
    zs_main(["--ckpt", os.path.join(ROOT, "checkpoints", "bowl_reg"),
             "--category", s["category"], "--n_frames", str(s["n_frames"]),
             "--instances", str(s["instances"]), "--clutter", str(s["clutter"]),
             "--n_pairs", str(s["n_pairs"]), "--out_dir", tmp, "--seed", str(s["seed"])])
    pred_dir = os.path.join(tmp, "pred_zs")
    with contextlib.redirect_stdout(io.StringIO()):
        iou_aps, pose_aps = nocs_eval.main(["--pred_dir", pred_dir, "--subsample", "1"])[:2]
    out = {"zs_iou_aps": iou_aps, "zs_pose_aps": pose_aps}
    pkls = _pkls(pred_dir)
    out["zs_frames"] = np.asarray(sorted(pkls), np.int32)
    for f, r in pkls.items():
        out[f"zs_RTs_{f}"] = r["pred_RTs"]
        out[f"zs_scales_{f}"] = r["pred_scales"]
        out[f"zs_scores_{f}"] = r["pred_scores"]
    return out


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = {"settings": np.array(json.dumps(SETTINGS))}
    for run in (nocs_run, sun_run, zero_shot_run):
        with tempfile.TemporaryDirectory() as tmp:
            part = run(tmp)
        out.update(part)
        print(f"{run.__name__}: {sorted(part)}", flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes", flush=True)


if __name__ == "__main__":
    main()
