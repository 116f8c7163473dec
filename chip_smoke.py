"""Smoke run of the PyTorch port (cppf_tpu_torch) on one NVIDIA GPU.

Drives the port's two paths and holds every CUDA kernel of them against its
plain PyTorch version: the main path, ``CategoryRunner("bowl").estimate``
(single-instance 9D pose at bowl's full width: 4096 points, knn 60,
100 000 pairs, 72 rotations = 7.2 M center votes, 64³ grid) on the
committed rendered views, then ``CategoryRunner(cat).estimate`` of every
other category at its own full width and grid, and the zero-shot path,
``zero_shot_detect`` (the whole demo frame at the width of
``checkpoints/bowl_reg``: res 4 mm, knn 60, 5 M pairs, 72 rotations,
adaptive voting, a 320×218×164 heatmap).
Phases:

1. card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: every ``cppf_tpu_torch/csrc/*.cu``, one ``nvcc`` each, together;
   prints each kernel's registers and spills (``-Xptxas -v``) and fails on
   a spill;
3. kernels: both front ends of ``bound_projections`` and ``refine_window``
   (votes: the flat vote vectors; pairs: the pair parameters, the votes made
   in the kernel) against the plain version on the same CUDA inputs from
   the main path (bowl: 100 000 pairs, V = 7.2 M, 64³; and the same pairs on
   bottle's pooled 120³ grid), and once each with nearest splat and with
   adaptive rotations; fails beyond 1e-3 of the maximum, and against the
   plain version summed in float64 beyond ``EXACT_RTOL`` (the window) or
   outside [-``BOUND_UNDER_RTOL``, ``BOUND_OVER_RTOL``] (the bound pass,
   whose taps round up) of the maximum, but for the pairs front end under
   adaptive rotations, whose votes may differ from PyTorch's at a step.
   Times by CUDA events in
   turns (median of 25; calls under a millisecond 8 at a time behind a
   spinning kernel, so that the host's launch time stays out), the bytes
   and operations bound of each front end with both terms, the shared
   atomics a second, and one ``index_add_`` call as the library yardstick;
   then, timed the same way, at the other categories' shapes on their own
   pairs (``KERNEL_SHAPES``: can 56³, camera 72³, bathtub 88³ and
   bookshelf's pooled 152³ at 3 cm, mug 56³ with the point weights of its
   second center pass, table 128³ with its coplanar pair mask);
4. main path: the center-vote stage alone must allocate less than one
   [P, R] vote vector; then the 4 views on the card, launch counts (reset
   just before), errors against ground truth and against the stored JAX
   estimates, warm ms per pose and the peak device memory of one; fails
   unless the pairs front ends launched once and at most twice a pose and
   the votes front ends never, if the median T error exceeds 2 cm or the
   median up error 15°;
5. CPU against CUDA: one view with identical draws through the plain
   versions and through the kernels; fails unless the peak voxel and the up
   direction are the same;
6. both front ends of ``dense_hist`` (votes: the flat vote vectors; pairs,
   which the zero-shot path takes: the pair parameters, the votes made in
   the kernel) against the plain version on the demo frame's own CUDA
   inputs at the path's shapes: the first 2^20 pairs on the unpooled
   whole-frame grid and on the pool-8 coarse grid of the sparse route, one
   48³ window, and every pair of the frame; with adaptive rotations as the
   path votes (the pairs front end held to float64 sums within 1e-3 of the
   maximum, the votes front end within ``EXACT_RTOL``), and but for the
   whole frame once more without them (both within ``EXACT_RTOL``); times
   as in phase 3, with both bounds and the pooled taps a second;
7. the zero-shot path on the demo frame (launch counts reset just before):
   fails unless ``dense_hist_pairs`` launched and ``dense_hist`` did not,
   there are exactly 2 detections, each within 4 cm of the two real bowls,
   with bowl-sized scales, and within 1 cm and 5° of the stored JAX
   detection; warm seconds a frame by stage (median of 3) and the peak
   device memory; the heatmap stage alone must allocate less than one
   [2^20, 72] vote vector; the ``sparse=True`` route at its defaults (its
   proposals and detections are printed beside the dense route's) and
   without its pair budget, where every voxel it writes must equal the
   dense grid's to 1e-3 of the maximum; and a reduced run (200 000 pairs) on
   the CPU and on the card, which must give the same detections to 1 mm.

8. every other category on its 4 committed views at full width, replaying
   each stored JAX run's draws, against the stored JAX estimates;
9. CPU against CUDA on one view of each at 20 000 pairs;
10. the NOCS REAL275 driver, ``nocs_inference.main`` at full width with
   ``--seed 0`` on the committed frame (``assets/nocs_frame``: 7 instances
   of 4 categories, a batched chunk of 3 padded to 4, one of 2, two
   singletons; launch counts reset just before): fails unless every
   instance is posed (not the identity, det(R) > 0, unit scales), its T
   within 1 cm of the stored JAX driver's and its up within 5° (up to sign
   for bowl, bottle, can; one flip is printed and allowed), the pairs front
   ends of both peak kernels launched once (mug twice) a center pass and
   the votes front ends and ``dense_hist`` never, the draws' kernel once a
   pose, and ``nocs_eval.main`` on the stored JAX pkl equals the stored JAX eval to 1e-12; then the warm
   frame loop (median of 3), ms per instance of each chunk, the frame's
   peak device memory, and both peak kernels held and timed on the frame's
   first instance;
11. the SUN RGB-D driver, ``sunrgbd_inference.main`` at full width with
   ``--seed 0`` and the 30° up prior on the committed scans
   (``assets/sun_scans``: 7 scans, 14 posed instances of the six weighted
   SUN categories, one scan holding two categories and a segment under the
   200-point floor; launch counts reset just before): fails unless every
   instance of the stored JAX run is posed, in its order, with its up axis
   inside the prior, its T within 1 cm of JAX's, its scales within 1e-3
   and its up within 5° (one flip is printed and allowed), the pairs front
   ends launched once (windows at most twice) a center pass and the votes
   front ends and ``dense_hist`` never, the draws' kernel once a pose, and
   ``sunrgbd_eval.main`` on the stored JAX pkls equals the stored JAX eval to 1e-12; then the warm loop
   (s/scan, median of 3), ms an instance by category, the draws of one
   instance, the loop's peak device memory, and both peak kernels held and
   timed on the first instance's grid.
12. supervised training of bowl at the full width of its checkpoint's
   training config (batch 2, 4096 points, knn 60, 200 000 pairs a sample,
   Adam 1e-3 with weight decay 1e-4; rendered primitives): one epoch of 20
   steps from the flax-style init through ``train/loop.py::train`` with a
   decode validation of its 6 held-out poses at 100 000 pairs (launch
   counts reset just before: the pairs front ends of both peak kernels
   once, and at most twice, a pose, nothing else of ``vote_hist.cu``);
   ``CategoryRunner`` serves the run's ``params_best.npz`` on a committed
   view equal to the trained modules' estimate; warm ms a step split into
   host render, draws, batch prep and the step (CUDA events), samples a
   second, the peak memory, the launches and idle share of a step; 10 steps
   on one batch must lower its loss; one step on the CPU against the card
   (loss 1e-5 relative, gradients 1e-3 of each tensor's maximum,
   parameters 1e-6); the decode validation of the committed bowl params
   on the card equal to the CPU's, up under 15°; both peak kernels held and
   timed at a decode-val pose's shapes.
13. the pair-sharded pose and the data-parallel step (``parallel/``),
   the kernels built before any rank starts: bowl and mug at full width on
   their 4 committed views, each on its stored JAX run's draws, over 4
   gloo ranks sharing the card (``parallel/launch.py::run_ranks``: spawned
   processes, a file store); fails unless every rank returns the same pose
   bit for bit, T is the one-rank pose's (or a maximum of its dense grid
   within 1e-3, one center pass only), up and right equal it to 1e-6,
   scale to rtol 1e-5, the back-vote survivors are equal, the medians of T
   and up against the stored JAX estimates stay under 2 cm and 15°, and
   each rank launched the pairs front ends of both peak kernels on its own
   pairs once and 1-2 times a center pass (mug: two passes) and nothing
   else of ``vote_hist.cu``; which collectives gloo takes on CUDA tensors;
   then bowl's first view over NCCL with one rank a card (world size
   ``device_count()``), the same checks; then one ``data_parallel_train_step``
   on 2 gloo ranks at bowl's training width against one rank's
   ``train_step`` on the whole batch (loss 1e-5 relative, gradients 1e-4
   of each maximum, weights 1e-6, every rank's weights equal); warm
   ms/pose and ms a step against one rank's, the bytes a pose's and a
   step's collectives move; both peak kernels held and timed on rank 0's
   shard (25 000 of bowl's 100 000 pairs).  One-card gloo times say nothing
   of NCCL across cards.

14. the laptop segmenter (``models/segmenter.py``, ``train/laptop_aux.py``)
   and the NOCS driver's laptop override, on the committed laptop frame
   (``assets/nocs_laptop_frame``: a mug, a laptop, a bowl, and the JAX
   driver's full-width run with its laptop path): (a) the segmenter trained
   from the flax-style init at the JAX trainer's width (batch 16, 224²,
   Adam 1e-3) on the synthetic stream for about 45 s (``train``), its
   losses finite and falling, ms a step split into host render and device
   step, the peak memory; 10 steps on one batch must lower its loss; one
   step on the CPU against the card at batch 2 in float64 (loss 1e-5,
   gradients 1e-3 of each tensor's maximum, weights 1e-6; the float32
   numbers printed beside); (b) the trained weights served by
   ``SegmenterRunner`` on the frame's crop, CPU against CUDA (logits 1e-4
   of the maximum, labels equal on 99.9 % of the pixels), ms a forward;
   (c) from JAX's stored labels on the card: ``laptop_crop`` equal to the
   stored crop (1e-6), ``laptop_up_from_labels`` to JAX's ``laptop_up``
   (1e-5 rad), the second pose to JAX's (T the same voxel, up 0.1°); (d)
   ``nocs_inference.main`` with the trained segmenter in
   ``<tmp>/checkpoints/laptop_aux`` on the card (launch counts reset just
   before: the pairs front ends of both peak kernels once, and at most
   twice, a center pass, the laptop's two poses two passes) and on the
   CPU: every T within 1 cm and up within 5° of the CPU's; the laptop's T
   and up against GT, the warm frame loop with the override and without
   it, and both peak kernels held and timed on the laptop instance.
15. the zero-shot model (``eval/contrast_val.py``, the trainer's
   regression head, ``eval/zero_shot.py::main``) at the width of
   ``checkpoints/bowl_reg``: (a) the committed ``params_zs`` scored on the
   proposal-contrast val scene as the trainer scores it (500 000 pairs, 36
   rotations, threshold 10, seed 0; launch counts reset just before:
   ``dense_hist_pairs`` once, nothing else): the scene's depth equal to
   JAX's stored run (``assets/contrast_val_bowl.npz``) to the bit, hits and
   false positives equal, the mean contrast within ``VAL_CONTRAST_RTOL``,
   the peak voxel near each GT center the same; ms a validation by stage;
   ``dense_hist``'s pairs front end held and timed on the scene's own
   pairs as in phase 6; (b) the same scene at 150 000 pairs on the CPU and
   on the card: hits and false equal, contrast within
   ``VAL_CONTRAST_RTOL``; (c) ``train/loop.py::train`` from the committed
   ``params_zs`` with a validation after each of 3 epochs of 2 steps (launch
   counts reset just before: ``dense_hist_pairs`` once a validation,
   nothing else): finite losses, 3 lines of ``zs_metrics.jsonl``, a
   ``params_zs.npz`` that reloads into encoders scoring the logged best;
   ms a regression train step; (d) the CLI in this process at 5 M pairs on
   the demo PNGs, first on ``checkpoints/bowl_reg`` (its orbax ``params_zs``):
   exactly 2 detections, within 4 cm of the bowls and within 1 cm and 5° of
   the stored JAX detection, ``dense_hist_pairs`` once a 2^20-pair chunk;
   then on (c)'s run; each PNG reads back, equals the colour frame outside
   the drawn box pixels, is red on them, and is drawn within 2 px of every
   projected corner; s a CLI run.
16. the pose flags that no category config turns on (``FLAG_CELLS``):
   (a) each alone on view 0 at its category's full width
   (``coplanar_halfspace``, ``pair_balance``, ``pair_sep_power`` and the
   grid center mode under the gate on sofa, 3 cm, 136³; ``sharp_axis_votes``
   and ``aux_align_weight`` on mug; ``subvoxel_refine`` and the grid center
   mode on bowl) and (b) two sets on all 4 views (sofa: gate, separation,
   balance, sub-voxel; mug: sharp, aligned, sub-voxel), each view on its
   stored JAX run's draws against JAX's estimate with the same flags
   (``assets/flag_views.npz``): T the same voxel, else both a maximum of
   the port's gated grid within 1e-3; a sub-voxel T within
   ``SUBVOXEL_T_TOL`` voxels of JAX's, with no such fallback, and off its voxel
   centre wherever JAX's is (one of JAX's at least); on the same back-vote
   survivor count as JAX's, up and right within ``AXIS_TOL_DEG`` of
   JAX's, else a parted axis only as a near tie (``AXIS_TIE_FRAC``),
   printed with its angle and the port's sphere counts at both winners;
   per category, the median T, up and right errors against GT held to
   phase 8's rule (twice JAX's + 5 voxels, JAX's + 15°); launch counts reset
   before each pose: a gated center pass launches the votes front ends of
   ``bound_projections`` once and of ``refine_window`` 1 to ``peak_rounds``
   times, a grid pass ``dense_hist_pairs`` once (``dense_hist`` under the
   gate), an ungated hier pass the pairs front ends, nothing else; the
   votes front ends of all three kernels held against their plain versions
   and float64 sums on sofa's gated votes with phase 3's limits and timed
   beside their bounds and ``index_add_``; CPU against CUDA on identical
   draws at 20 000 pairs for every cell (T, up, right to 1e-6, sub-voxel
   T 1e-5); both sets over 4 gloo ranks of the card, equal to the one-rank
   poses (T, up, right to 1e-6, survivors equal), every rank's launches
   held to the same rule.
17. the entry points (``cppf_tpu_torch/entry.py``): ``entry()`` on the
   card (finite; the pairs front ends of both peak kernels, 1 and 1-2
   launches; warm ms); ``dryrun_multichip(4)`` over 4 gloo ranks of the
   card (a (2, 2) mesh), its step against one rank's step on the whole
   batch (loss 1e-5 relative, gradients 1e-4 of each maximum, weights
   1e-6); the pair-sharded step at phase 12's bowl training width on a
   (2, 2) mesh (a sample a data rank, its 200 000 pairs over two pair
   ranks) against one rank, the same limits, ms a step beside one rank's.

18. the quality gauges (``cppf_tpu_torch/scripts/``, the demo): (a)
   ``eval_checkpoints`` at 4 poses, seed 0, for all 12 categories: its
   views the committed views and its keys JAX's, each pose printed beside
   JAX's stored estimate (the laptop's override pose beside
   ``jax_ov_*``), the medians held to phase 8's rule, the peak kernels'
   launches by their rule; bowl's view 0 under ``--set center_mode=grid``
   (``dense_hist_pairs``) and sofa's under ``--set coplanar_halfspace=true``
   (the votes front ends), each held by phase 16's rule to JAX's estimate
   of that view and key under that flag (``assets/flag_views.npz``); (b)
   the synthetic NOCS (bowl, mug, can, clutter), SUN RGB-D (table) and
   zero-shot (bowls, 1 M pairs) runs against the stored JAX run
   (``assets/gauge_runs.npz``): every instance's T within 1 cm and up
   within 5° of JAX's, or one parted pose a run whose up axis is a near tie
   (``AXIS_TIE_FRAC`` on its own sphere counts; a zero-shot T never parts),
   the zero-shot detections counted as JAX's, the AP tables printed beside
   JAX's; (c)
   the gauges at their defaults (NOCS bowl 20 frames, SUN table 10 scans,
   zero-shot 8 frames at 2 M pairs), ``bench_zero_shot`` on the demo frame
   at 5 M pairs (both routes) and the demo in both modes, each with its
   launches held, and one ``{"gauges": ...}`` line with the ``nvidia-smi``
   line; ``dense_hist`` held and timed on a synthetic zero-shot frame's
   first pair chunk, both peak kernels on bowl's first view.
19. the reference CPPF's ``.pth`` checkpoints: bowl's and mug's served
   weights written as the upstream pair ``{point,ppf}_encoder_epochbest.pth``
   with their ``config.yaml`` in a temporary ``--ckpt_path``; the 4
   committed views of each posed on JAX's draws through
   ``CategoryRunner(cat, ckpt_path=...)``, T, up, right, scale and the
   survivor count equal to the bit to the poses of the committed ``.npz``,
   the peak kernels' launches by their rule; the zero-shot CLI at full
   width from a directory holding ``bowl_reg``'s ``params_zs`` as the
   upstream pair: the 2 detections of the ``.npz``-served run, to the bit,
   ``dense_hist_pairs`` launched once a chunk; a torchvision-keyed
   segmenter state dict (seeded weights and running statistics) through
   ``fcn_resnet50_from_torch`` and ``SegmenterRunner`` (the ``track_stats``
   path), CPU against CUDA logits with phase 14's limits; one
   ``{"reference_pth": ...}`` line (ms to load a pair and an ``.npz``, ms a
   pose from each) with the ``nvidia-smi`` line.
20. the repo's orbax checkpoints, read on the card's host by
   ``train/orbax.py`` (OCDBT, zarr v2, ``csrc/zstd_decode.cpp`` built with
   ``g++``; no JAX, orbax or tensorstore): (a) all 33 read, each three
   times (ms cold and warm), their leaves held to their ``_METADATA``
   (paths, shapes), the 12 categories' ``params_best`` and ``bowl_reg``'s
   ``params_zs`` equal to their ``.npz`` assets to the bit, the decoder's
   MB/s on ``laptop_aux``'s chunks; (b) the laptop frame with
   ``checkpoints/laptop_aux`` linked unchanged: ms from reading the
   segmenter to the laptop's first pose, its labels JAX's stored ones on
   ≥ 99.9 % of 224², ``laptop_up`` within ``LAPTOP_UP_TOL_RAD`` of JAX's,
   the after-override pose as phase 14 (c) holds it, then
   ``nocs_inference.main`` twice (s a run; the first run's launches by
   phase 14's rule), every instance within phase 10's limits of the stored
   JAX driver; (c) ``eval_checkpoints --name best_decode`` on
   ``bathtub_r5`` linked as ``bathtub``, view 0: the JAX train state's
   params served, the pose equal to the bit to the production
   ``params_best``'s (the same weights); one ``{"orbax": ...}`` line with
   the ``nvidia-smi`` line.
21. ``bench.py``'s main cell (``cppf_tpu_torch/scripts/bench_cell.py``:
   bottle, 8000 surface points, 3171 kept of ``npoint_pad`` 4096,
   100 000 pairs, 120³, ``checkpoints/bottle/params_best``) at full width
   on the card,
   against JAX's stored estimates (``assets/bench_cell.npz``): the 4 keys
   ``PRNGKey(10..13)`` with nearest splat and with trilinear splat, and the
   first B = 4 batch dispatch with nearest splat; each pose's T JAX's
   voxel (1e-5 m) or a tie (the port's voxel and JAX's maxima of equal
   value of their grids), up within 1° of JAX's up to sign or a near tie
   (phase 16's ``AXIS_TIE_FRAC``), scale within 1e-4 relative; the pairs
   front ends of the peak kernels launched once and 1-2 times a center
   pass with either splat, nothing else of ``vote_hist.cu``; CPU against
   CUDA on one pose of each splat at ``PHASE9_PAIRS``, as phase 9; prints
   the ties and near ties, one ``{"bench_cell": ...}`` line and the
   ``nvidia-smi`` line.
22. the axis vote's sphere count (``csrc/sphere_count.cu``, no TPU
   kernel's counterpart) on the calls of bottle's and mug's view 0 at full
   width (10 000 pairs, 72 rotations, 480 directions; bottle's up, mug's
   up and right), captured from ``pipeline/pose.py``: the kernel launched
   once an axis and its counts the plain version's to the bit on the same
   CUDA tensors; then the kernel alone, the whole CUDA route (the pairs'
   vectors and the kernel) and the plain version timed in turns as in
   phase 3, with the bound; one ``{"sphere_count": ...}`` line.
23. the JAX-key draws' kernel (``csrc/threefry_draws.cu``, no TPU kernel's
   counterpart) on the requests of one pose of ``bottle.frames`` and of
   ``table.scans`` (``portbench/configs/``: 13.40 M and 13.77 M elements,
   the pair key and the preprocess key): one launch a
   ``PoseDraws.from_jax_keys``, every draw ``draw_many_plain``'s on the
   card to the bit; then the kernel and the plain CUDA path timed in turns
   as in phase 3, with the bound (bytes and operations), and the host's
   time of a whole ``from_jax_keys`` call, and the kernel's registers,
   shared memory and spills; one ``{"draws": ...}`` line.

``--profile`` adds the warm time of each stage of one pose, and a
torch.profiler table of the kernels of one pose, of one zero-shot frame,
of one NOCS frame, of one pass of the SUN driver's loop and of one training
loop step
(``scripts/pose_stages.py`` runs the pose half for several checkouts in
turns).  Prints the categories JSON line of phase 8, the kernels JSON
line, the ``nvidia-smi`` line, and last the result line.
Usage: python3 chip_smoke.py [--profile]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM data-sheet peaks
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
KERNEL_RTOL = 1e-3
# Of the largest cell, against the plain version summed in float64.  The
# window kernels round a tap to the nearest fixed-point unit; the bound
# kernels round every tap up, so that a cell of n taps lies above the exact
# sum by up to n units, and below it by the float rounding of the blocks'
# flush at most.
EXACT_RTOL = 1e-5
BOUND_OVER_RTOL = 1e-4
BOUND_UNDER_RTOL = 1e-6
TIMING_REPS = 25
SPIN_CYCLES = 8_000_000  # ~5 ms of device time at 1.7 GHz, to let the host run ahead
TPU_KERNELS = {
    "bound_projections": "cppf_tpu/ops/pallas/vote_hist.py:126",
    "refine_window": "cppf_tpu/ops/pallas/vote_hist.py:200",
    "dense_hist": "cppf_tpu/ops/pallas/vote_hist.py:310",
}
# the two real bowls of data/demo/0000_depth.png (tests/test_demo_frame.py:26-29)
BOWL_CENTERS = np.array([[0.0799, -0.1865, 1.2541], [0.1599, -0.0345, 1.1941]])
ZS_PAIRS = 5_000_000
REDUCED_PAIRS = 200_000


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def _event_ms(fn, calls: int) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def cuda_ms_turns(fns, small=None):
    """Median device time of one call of each of ``fns``, by CUDA events,
    after a warm-up, the functions timed in turns (a, b, a, b, ...) so that
    clocks and neighbours treat them alike.  A call that takes under a
    millisecond (or each whose ``small`` is true, where the host needs
    longer to launch its many kernels than the card to run them) is sampled
    8 at a time, queued behind a spinning kernel: the host, which needs
    longer to launch such a kernel than the card needs to run it, is then
    ahead of the card, and the events see device time alone."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    if small is None:
        small = [_event_ms(fn, 1) < 1.0 for fn in fns]
    times = [[] for _ in fns]
    for _ in range(TIMING_REPS):
        for fn, batched, ts in zip(fns, small, times):
            if batched:
                torch.cuda._sleep(SPIN_CYCLES)
            ts.append(_event_ms(fn, 8 if batched else 1))
    return [statistics.median(ts) for ts in times]


def cuda_ms(fn) -> float:
    return cuda_ms_turns([fn])[0]


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main_path_inputs(runner, pc_raw, grid_shape, adaptive=False, second_pass=False, rows=None,
                     halfspace=False):
    """What ppf_vote_peak is given for one view, on the card: its arguments
    (``peak_args``), the pair-parameter block and grid frame that the pairs
    front ends read, the flat vote vectors that the votes front ends read
    (made from the same block by the plain votes_from_pair_params), and the
    origin of the first refine window.  The pair mask is the category's
    center mask (``filter_coplanar``'s, else every pair); with
    ``second_pass`` the point weights are those of ``asym_center_refine``'s
    second center pass, 0.05 + 0.95 · the radial asymmetry about the first
    pass's center and up axis.  ``rows`` (a slice) keeps those pairs only:
    one rank's shard of the pair-sharded pose.  With ``halfspace`` the votes
    are those of a ``coplanar_halfspace`` center pass: the gate (returned
    under "halfspace") drops the coplanar pairs' votes in front of their
    surface, as the votes front ends receive them."""
    from cppf_tpu_torch.core.targets import radial_asymmetry_about
    from cppf_tpu_torch.ops.vote_hist import vote_frame
    from cppf_tpu_torch.ops.voting import (backvote, pair_vote_params, ppf_vote_peak,
                                           votes_from_pair_params)
    from cppf_tpu_torch.pipeline.pose import (PoseDraws, _vote_axis, coplanar_center_mask,
                                              decode_translation, grid_frame, halfspace_gate,
                                              pair_predictions)
    from cppf_tpu_torch.pipeline.preprocess import preprocess_cloud

    pcfg, cfg, dev = runner.pcfg, runner.cfg, runner.device
    draws = PoseDraws.sample(pcfg, torch.Generator(device=dev).manual_seed(1), dev,
                             n_raw=cfg.npoint_max)
    pad = np.zeros((cfg.npoint_max, 3), np.float32)
    pad[: len(pc_raw)] = pc_raw[: cfg.npoint_max]
    with torch.no_grad():
        pre = preprocess_cloud(torch.from_numpy(pad).to(dev), min(len(pc_raw), cfg.npoint_max),
                               cfg.res, npoint_pad=cfg.npoint_pad, knn=cfg.knn,
                               noise=draws.jitter)
        idxs, preds = pair_predictions(runner.point_encoder, runner.ppf_encoder, pre.pc,
                                       pre.normals, pre.n_valid, pcfg, draws.pair_u,
                                       pre.nbr_idx)
        preds_tr = decode_translation(preds, draws.tr_gumbel, pcfg)
        corner, dims = grid_frame(pre.pc, pre.valid_mask, pcfg)
        probs = torch.ones(pre.pc.shape[0], device=dev)
        # the gate takes precedence over the coplanar filter, as in the pose
        mask = (coplanar_center_mask(pre.pc, pre.normals, idxs)
                if pcfg.filter_coplanar and not halfspace
                else torch.ones(idxs.shape[0], dtype=torch.bool, device=dev))
        if second_pass:
            peak, _ = ppf_vote_peak(pre.pc, preds_tr, probs, idxs, corner, pcfg.res, dims,
                                    grid_shape, n_rots=pcfg.num_rots, pair_mask=mask,
                                    max_rounds=pcfg.peak_rounds)
            T = corner + peak.float() * pcfg.res
            alive = backvote(pre.pc, preds_tr, idxs, corner, pcfg.res, dims, T, 3.0 * pcfg.res,
                             n_rots=pcfg.num_rots)[1]
            B, R = pcfg.tr_num_bins, pcfg.rot_num_bins
            up = _vote_axis(pre.pc, pre.normals, idxs, alive, preds[:, 2 * B: 2 * B + R],
                            preds[:, -5], runner.sphere, pcfg, draws.up)
            probs = 0.05 + 0.95 * radial_asymmetry_about(pre.pc, T, up, pre.n_valid)
        if rows is not None:
            idxs, preds_tr, mask = idxs[rows], preds_tr[rows], mask[rows]
        hs = halfspace_gate(pre.pc, pre.normals, idxs, pcfg) if halfspace else None
        params = pair_vote_params(pre.pc, preds_tr, probs, idxs, pcfg.res, pcfg.num_rots,
                                  adaptive, mask)
        f, r, w = votes_from_pair_params(params, corner, pcfg.res, dims.float(), grid_shape,
                                         pcfg.num_rots, halfspace=hs)
        peak_args = (pre.pc, preds_tr, probs, idxs, corner, pcfg.res, dims, grid_shape)
        peak, _ = ppf_vote_peak(*peak_args, n_rots=pcfg.num_rots, adaptive=adaptive,
                                pair_mask=mask, max_rounds=1, halfspace=hs)
    return dict(peak_args=peak_args, params=params, n_rots=pcfg.num_rots, halfspace=hs,
                frame=vote_frame(corner, pcfg.res, dims.float()), grid_shape=grid_shape,
                votes=[a.reshape(-1).contiguous() for a in (*f, *r, w)],
                o=(peak // 16 * 16).to(torch.int32))


def _bound_taps(votes, gx, gy, by_n, bz_n, pfy, pfz):
    """Flat ids and values of every trilinear term of bound_projections,
    for the one-call index_add_ yardstick."""
    fx, fy, fz, rx, ry, rz, w = votes
    hx = [(fx.long(), (1 - rx) * w), (fx.long() + 1, rx * w)]
    hy = [(fy.long(), 1 - ry), (fy.long() + 1, ry)]
    hz = [(fz.long(), 1 - rz), (fz.long() + 1, rz)]
    n_xy, n_xz = gx * by_n, gx * bz_n
    ids, vals = [], []
    for ix, vx in hx:
        for iy, vy in hy:
            ids.append(ix * by_n + iy // pfy), vals.append(vx * vy)
        for iz, vz in hz:
            ids.append(n_xy + ix * bz_n + iz // pfz), vals.append(vx * vz)
    for iy, vy in hy:
        for iz, vz in hz:
            ids.append(n_xy + n_xz + iy * bz_n + iz // pfz), vals.append(vy * w * vz)
    return torch.cat(ids), torch.cat(vals)


def _refine_taps(votes, o, w8):
    """Flat ids and values of the 8 corners of every vote; corners outside
    the window go to one spare slot at index w8³."""
    fx, fy, fz, rx, ry, rz, w = votes
    o = o.long()
    ids, vals = [], []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                lx, ly, lz = fx - o[0] + dx, fy - o[1] + dy, fz - o[2] + dz
                ok = ((lx >= 0) & (lx < w8) & (ly >= 0) & (ly < w8) & (lz >= 0) & (lz < w8))
                ids.append(torch.where(ok, (lx * w8 + ly) * w8 + lz, w8 ** 3).long())
                vals.append(((rx if dx else 1 - rx) * w) * ((ry if dy else 1 - ry)
                                                            * (rz if dz else 1 - rz)))
    return torch.cat(ids), torch.cat(vals)


def _max_err(got, expect, name, rtol=KERNEL_RTOL):
    got = torch.cat([g.reshape(-1) for g in got])
    expect = torch.cat([e.reshape(-1) for e in expect])
    err = (got - expect).abs().max().item()
    scale = expect.abs().max().item()
    check(scale > 0, f"{name}: plain version is all zero")
    check(err <= rtol * scale, f"{name}: kernel differs from plain by {err} "
          f"(> {rtol} of {scale})")
    return err, err / scale


def _exact_err(got, exact, name, under, over):
    """(lowest, highest) of kernel minus float64 sum over the cells, as
    shares of the largest cell; fails outside [-under, over]."""
    got = torch.cat([g.reshape(-1) for g in got])
    exact = torch.cat([e.reshape(-1) for e in exact])
    scale = exact.max().item()
    lo = (got - exact).min().item() / scale
    hi = (got - exact).max().item() / scale
    check(-under <= lo and hi <= over, f"{name}: kernel minus float64 sums spans [{lo}, {hi}] "
          f"of the maximum, outside [-{under}, {over}]")
    return lo, hi


def _pairs_work(params, n_rots, live_votes):
    """Bytes and operations the pairs front ends need on these inputs: the
    first 16 bytes of every pair and the other 32 of each that votes; per
    vote made (rotation i < m of a voting pair) one axis of 8 operations (2
    products, 2 sums, the corner, the division, 2 compares), and for a live
    vote the other two axes and 3 floors and 3 fractions (the angles come
    from a table)."""
    m = params[:, 1].view(torch.int32)
    voting = (params[:, 0] != 0) & (m > 0)
    made = torch.clamp(m, max=n_rots)[voting].sum().item()
    bytes_ = 16 * params.shape[0] + 32 * int(voting.sum()) + 4 * 7
    ops = 8 * made + (16 + 6) * live_votes
    return bytes_, ops, voting


def _set_bound(rec, prefix, bytes_, ops):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    rec[prefix + "bound_ms"] = max(t_bytes, t_ops)
    rec[prefix + "bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    rec[prefix + "bound_terms"] = f"bytes {t_bytes:.5f} ms, operations {t_ops:.5f} ms"


def kernel_phase(inp, label, splat="trilinear", timed=True, adaptive=False, pairs=True):
    """Hold both front ends of both peak kernels against the plain version
    on one view's inputs and, when ``timed``, time them in turns; returns
    their records for the kernels line: the unprefixed keys are the pairs
    front end's, which the main path launches, the ``votes_`` ones the votes
    front end's.  Without ``pairs`` (the votes of a gated center pass, which
    the pairs front ends cannot make) the votes front end alone."""
    from cppf_tpu_torch.ops import vote_hist as vh
    from cppf_tpu_torch.ops.voting import _poolf

    votes, o, params, frame = inp["votes"], inp["o"], inp["params"], inp["frame"]
    fx, fy, fz, rx, ry, rz, w = votes
    votes64 = [fx, fy, fz, rx.double(), ry.double(), rz.double(), w.double()]
    V = w.shape[0]
    grid = inp["grid_shape"][0]
    pf = _poolf(grid)
    bn = -(-grid // pf)
    kw = dict(gx=grid, gy=grid, by_n=bn, bz_n=bn, pfy=pf, pfz=pf, splat=splat)
    pkw = dict(n_rots=inp["n_rots"], grid_shape=inp["grid_shape"])
    w8 = 16
    records = {}

    def both(name, plain_fn, votes_fn, pairs_fn, under, over):
        """Each front end against the plain version, and against the plain
        version summed in float64 within [-under, over] of the maximum (the
        pairs front end under adaptive rotations is not held to that: a vote
        of its own making may fall on the other side of a step than
        PyTorch's)."""
        expect, exact = plain_fn(votes), [t.float() for t in plain_fn(votes64)]
        rec = {}
        fronts = [("", pairs_fn, not adaptive)] if pairs else []
        for prefix, fn, tight in fronts + [("votes_", votes_fn, True)]:
            end = "votes front end" if prefix else "pairs front end"
            got = fn()
            err, rel = _max_err(got, expect, f"{name} {label}, {end}")
            lo, hi = _exact_err(got, exact, f"{name} {label}, {end}",
                                *((under, over) if tight else (KERNEL_RTOL, KERNEL_RTOL)))
            rec.update({prefix + "max_abs_err": err, prefix + "rel_err": rel})
            print(f"kernel {name} [{label}, {splat}], {end}: max abs err {err:.3e} (rel "
                  f"{rel:.3e}); kernel minus float64 sums in [{lo:.3e}, {hi:.3e}] of the "
                  f"maximum", flush=True)
        return rec

    def bound_plain(v):
        return vh.bound_projections_plain(*v, **kw)

    def bound_votes():
        return vh.bound_projections(*votes, **kw)

    def bound_pairs():
        return vh.bound_projections_pairs(params, frame, **pkw, by_n=bn, bz_n=bn, pfy=pf, pfz=pf,
                                          splat=splat)

    def refine_plain(v):
        return [vh.refine_window_plain(o, *v, w8=w8, splat=splat)]

    def refine_votes():
        return [vh.refine_window(o, *votes, w8=w8, splat=splat)]

    def refine_pairs():
        return [vh.refine_window_pairs(o, params, frame, **pkw, w8=w8, splat=splat)]

    def from_pairs(plain_fn):
        """The pairs front end's plain version: the votes, then their sums."""
        return lambda: plain_fn(vh._plain_votes(params, frame, inp["grid_shape"], inp["n_rots"]))

    records["bound_projections"] = both("bound_projections", bound_plain, bound_votes,
                                        bound_pairs, BOUND_UNDER_RTOL, BOUND_OVER_RTOL)
    records["refine_window"] = both("refine_window", refine_plain, refine_votes, refine_pairs,
                                    EXACT_RTOL, EXACT_RTOL)
    del votes64
    if not timed:
        return records

    live = int((w != 0).sum())
    n_out = 3 * grid * bn
    if pairs:
        pair_bytes, pair_ops, voting = _pairs_work(params, inp["n_rots"], live)
    rec = records["bound_projections"]
    ids, vals = _bound_taps(votes, grid, grid, bn, bn, pf, pf)
    out = torch.zeros(n_out, device=w.device)
    ms = cuda_ms_turns([bound_votes] + ([bound_pairs] if pairs else []))
    rec.update(votes_ms=ms[0], votes_plain_ms=cuda_ms(lambda: bound_plain(votes)),
               library_ms=cuda_ms(lambda: out.index_add_(0, ids, vals)), atomics=12 * live)
    del ids, vals
    # votes: w of every vote, the rest of the live ones; 6 hats, 3 weighted,
    # 12 products, 12 adds a live vote
    _set_bound(rec, "votes_", 4 * V + 6 * 4 * live + 4 * n_out, 31 * live)
    if pairs:
        rec.update(ms=ms[1], plain_ms=cuda_ms(from_pairs(bound_plain)))
        _set_bound(rec, "", pair_bytes + 4 * n_out, pair_ops + 31 * live)

    rec = records["refine_window"]
    ids, vals = _refine_taps(votes, o, w8)
    out = torch.zeros(w8 ** 3 + 1, device=w.device)
    lx = fx - o[0]
    near = (lx >= -1) & (lx < w8) & (w != 0)
    inside = near & (fy - o[1] >= -1) & (fy - o[1] < w8) & (fz - o[2] >= -1) & (fz - o[2] < w8)
    n_near, n_in = int(near.sum()), int(inside.sum())
    ms = cuda_ms_turns([refine_votes] + ([refine_pairs] if pairs else []))
    rec.update(votes_ms=ms[0], votes_plain_ms=cuda_ms(lambda: refine_plain(votes)),
               library_ms=cuda_ms(lambda: out.index_add_(0, ids, vals)),
               atomics=int((ids != w8 ** 3).sum()))
    del ids, vals
    # votes: fx of every vote, w/fy/fz of those in the window's x range, the
    # fractions of those that reach the window; 8 corners of 3 products and
    # an add for each of those.  pairs: 20 operations of the cull a voting
    # pair, one axis (8) a vote of a kept pair, the rest as the bound pass
    _set_bound(rec, "votes_", 4 * V + 3 * 4 * n_near + 3 * 4 * n_in + 4 * w8 ** 3, 8 * 4 * n_in)
    if pairs:
        kept = vh.window_cull_plain(params, frame, o, w8) & voting
        m_kept = torch.clamp(params[:, 1].view(torch.int32), max=inp["n_rots"])[kept].sum().item()
        rec.update(ms=ms[1], plain_ms=cuda_ms(from_pairs(refine_plain)),
                   culled_share=1 - int(kept.sum()) / max(int(voting.sum()), 1))
        _set_bound(rec, "", pair_bytes + 4 * w8 ** 3,
                   20 * int(voting.sum()) + 8 * m_kept + (16 + 6 + 32) * n_in)
    for name, rec in records.items():
        if not pairs:
            print(f"kernel {name} [{label}, V={V}, live={live}]: votes front end "
                  f"{rec['votes_ms']:.4f} ms (bound {rec['votes_bound_ms']:.5f} ms by "
                  f"{rec['votes_bound_by']}: {rec['votes_bound_terms']}; plain "
                  f"{rec['votes_plain_ms']:.4f} ms), index_add_ of the taps "
                  f"{rec['library_ms']:.4f} ms", flush=True)
            continue
        print(f"kernel {name} [{label}, V={V}, live={live}]: pairs front end {rec['ms']:.4f} ms "
              f"(bound {rec['bound_ms']:.5f} ms by {rec['bound_by']}: {rec['bound_terms']}; "
              f"plain, votes made first, {rec['plain_ms']:.4f} ms), votes front end "
              f"{rec['votes_ms']:.4f} ms (bound {rec['votes_bound_ms']:.4f} ms by "
              f"{rec['votes_bound_by']}: {rec['votes_bound_terms']}; plain "
              f"{rec['votes_plain_ms']:.4f} ms), index_add_ of the taps "
              f"{rec['library_ms']:.4f} ms; {rec['atomics']} shared atomics = "
              f"{rec['atomics'] / rec['ms'] * 1e3:.3e}/s (pairs), "
              f"{rec['atomics'] / rec['votes_ms'] * 1e3:.3e}/s (votes)"
              + (f"; window cull drops {rec['culled_share']:.3f} of the voting pairs"
                 if "culled_share" in rec else ""), flush=True)
    return records


def errors(out, z, i):
    T, R = z[f"T_{i}"], z[f"R_{i}"]
    t_err = float(np.linalg.norm(out.T.cpu().numpy() - T))
    up = out.up.cpu().numpy()
    up_err = float(np.degrees(np.arccos(np.clip(up @ R[:, 1], -1, 1))))
    bound = z[f"bound_{i}"]
    s_err = float(abs(np.linalg.norm(out.scale.cpu().numpy()) - np.linalg.norm(bound))
                  / np.linalg.norm(bound))
    t_jax = float(np.linalg.norm(out.T.cpu().numpy() - z[f"jax_T_{i}"]))
    up_jax = float(np.degrees(np.arccos(np.clip(up @ z[f"jax_up_{i}"], -1, 1))))
    return t_err, up_err, s_err, t_jax, up_jax


def _angle(a, b, fold=False):
    c = float(np.dot(a, b))
    return float(np.degrees(np.arccos(np.clip(abs(c) if fold else c, -1, 1))))


def category_errors(T, up, right, scale, z, i, cfg):
    """(T, up, right, scale) errors of one pose against view ``i``'s GT,
    scored as scripts/eval_checkpoints.py:112-140 scores them: the right
    axis against +x (+z under ``z_right``), sign folded for ``right_sym``;
    right is None where the category does not regress it."""
    R, bound = z[f"R_{i}"], z[f"bound_{i}"]
    t_err = float(np.linalg.norm(T - z[f"T_{i}"]))
    r_err = None
    if cfg.regress_right:
        r_err = _angle(right, R[:, 2] if cfg.z_right else R[:, 0], cfg.right_sym)
    s_err = float(abs(np.linalg.norm(scale) - np.linalg.norm(bound)) / np.linalg.norm(bound))
    return t_err, _angle(up, R[:, 1]), r_err, s_err


def _median(xs):
    xs = [x for x in xs if x is not None]
    return float(np.median(xs)) if xs else float("nan")


# the categories of phase 8, each at its own grid, and phase 3's kernel shapes
# on their pairs: (category, label, second center pass)
OTHER_CATEGORIES = ("bottle", "can", "camera", "mug", "laptop", "sofa", "chair", "bed",
                    "bathtub", "bookshelf", "table")
KERNEL_SHAPES = (("can", "can 56^3", False), ("camera", "camera 72^3", False),
                 ("bathtub", "bathtub 88^3, 3 cm", False),
                 ("bookshelf", "bookshelf 152^3, pool 4, 3 cm", False),
                 ("mug", "mug 56^3, second center pass", True),
                 ("table", "table 128^3, coplanar mask", False))
PHASE9_PAIRS = 20_000


def category_phase(runners):
    """Phase 8: every other category on its 4 committed views at full width
    (laptop with its plane override), launch counts reset just before and
    read just after; fails past the error limits or if a votes front end
    launched.  Returns {category: summary}."""
    from cppf_tpu_torch.models.convert import ASSETS
    from cppf_tpu_torch.ops import vote_hist as vh
    from cppf_tpu_torch.ops.voting import _poolf
    from cppf_tpu_torch.pipeline.pose import PoseDraws

    summary = {}
    for cat, runner in runners.items():
        pcfg, cfg = runner.pcfg, runner.cfg
        g = cfg.resolved_grid_edge()
        check(pcfg.n_pairs == 100000 and pcfg.num_rots == 72 and pcfg.knn == 60
              and pcfg.grid_shape == (g, g, g), f"{cat}: not full width: {pcfg}")
        z = np.load(os.path.join(ASSETS, f"{cat}_views.npz"))
        n_views = int(z["n_views"])
        ov = cat == "laptop"
        jax = "jax_ov_" if ov else "jax_"

        def run(i, draws=None):
            return runner.estimate(z[f"pc_{i}"], draws=draws,
                                   laptop_up=z[f"laptop_up_{i}"] if ov else None)[0]

        # the JAX run's own draws, remade from its key: the port then meets
        # the same sign coin flips as JAX on near-symmetric views
        draws = [PoseDraws.from_jax_key(pcfg, z[f"jax_key_{i}"], runner.device, cfg.npoint_max)
                 for i in range(n_views)]
        torch.cuda.synchronize()
        vh.reset_launches()
        outs = [run(i, d) for i, d in enumerate(draws)]
        torch.cuda.synchronize()
        launches = dict(vh.LAUNCHES)
        passes = 2 if pcfg.asym_center_refine else 1
        print(f"{cat}: launches over {n_views} poses: {launches}", flush=True)
        check(launches["bound_projections_pairs"] == passes * n_views,
              f"{cat}: bound_projections_pairs launched {launches['bound_projections_pairs']} "
              f"times over {n_views} poses, not {passes} a pose")
        check(passes * n_views <= launches["refine_window_pairs"] <= 2 * passes * n_views,
              f"{cat}: refine_window_pairs launched {launches['refine_window_pairs']} times")
        check(launches["bound_projections"] == 0 and launches["refine_window"] == 0,
              f"{cat}: the path built vote vectors for the votes front ends")
        errs, jerrs, vs_jax = [], [], []
        for i, out in enumerate(outs):
            T, up, right = (getattr(out, k).cpu().numpy() for k in ("T", "up", "right"))
            e = category_errors(T, up, right, out.scale.cpu().numpy(), z, i, cfg)
            jr = z[f"{jax}right_{i}"] if cfg.regress_right else None
            je = category_errors(z[f"{jax}T_{i}"], z[f"{jax}up_{i}"], jr, z[f"{jax}scale_{i}"],
                                 z, i, cfg)
            d = (float(np.linalg.norm(T - z[f"{jax}T_{i}"])), _angle(up, z[f"{jax}up_{i}"]),
                 None if jr is None else _angle(right, jr))
            errs.append(e), jerrs.append(je), vs_jax.append(d)
            print(f"  {cat} view {i}: T {e[0] * 1e3:.2f} mm, up {e[1]:.2f} deg, right "
                  f"{e[2] if e[2] is None else round(e[2], 2)} deg, scale {e[3] * 100:.2f} %; "
                  f"JAX CPU: T {je[0] * 1e3:.2f} mm, up {je[1]:.2f} deg; port minus JAX: "
                  f"T {d[0] * 1e3:.3f} mm, up {d[1]:.3f} deg, right "
                  f"{d[2] if d[2] is None else round(d[2], 3)} deg; survivors "
                  f"{int(out.n_filtered)}", flush=True)
        del draws  # ~27-52 MB a view, not to be counted in a pose's peak memory
        med = [_median([e[k] for e in errs]) for k in range(4)]
        jmed = [_median([e[k] for e in jerrs]) for k in range(4)]
        times = []
        for _ in range(3):
            for i in range(n_views):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(i)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.reset_peak_memory_stats()
        run(0)
        torch.cuda.synchronize()
        rec = dict(grid=g, pool=_poolf(g), res=cfg.res, launches=launches,
                   T_mm=med[0] * 1e3, up_deg=med[1], right_deg=med[2], scale_pct=med[3] * 100,
                   jax_T_mm=jmed[0] * 1e3, jax_up_deg=jmed[1], jax_right_deg=jmed[2],
                   jax_scale_pct=jmed[3] * 100,
                   vs_jax_T_mm=_median([d[0] for d in vs_jax]) * 1e3,
                   vs_jax_up_deg=_median([d[1] for d in vs_jax]),
                   vs_jax_right_deg=_median([d[2] for d in vs_jax]),
                   ms=statistics.median(times), ms_min=min(times),
                   peak_mib=torch.cuda.max_memory_allocated() / 2**20)
        summary[cat] = rec
        print(f"{cat} ({g}^3, pool {rec['pool']}, res {cfg.res}"
              f"{', plane override' if ov else ''}): "
              f"median T {rec['T_mm']:.2f} mm, up {rec['up_deg']:.2f} deg, right "
              f"{rec['right_deg']:.2f} deg, scale {rec['scale_pct']:.2f} % (JAX CPU on the same "
              f"views: {rec['jax_T_mm']:.2f} mm, {rec['jax_up_deg']:.2f}, "
              f"{rec['jax_right_deg']:.2f} deg, {rec['jax_scale_pct']:.2f} %); warm "
              f"{rec['ms']:.2f} ms/pose (median of {len(times)}, min {rec['ms_min']:.2f}); peak "
              f"device memory {rec['peak_mib']:.1f} MiB", flush=True)
        check(med[0] <= 2 * jmed[0] + 5 * cfg.res,
              f"{cat}: median T error {med[0] * 1e3:.1f} mm > twice JAX's {jmed[0] * 1e3:.1f} mm "
              f"+ 5 voxels")
        check(med[1] <= jmed[1] + 15.0,
              f"{cat}: median up error {med[1]:.1f} deg > JAX's {jmed[1]:.1f} + 15 deg")
        if cfg.regress_right:
            check(med[2] <= jmed[2] + 15.0,
                  f"{cat}: median right error {med[2]:.1f} deg > JAX's {jmed[2]:.1f} + 15 deg")
    return summary


def cpu_cuda_phase(runners):
    """Phase 9: one view of each category at PHASE9_PAIRS pairs on the CPU
    (plain versions) and on the card (kernels), identical draws; fails
    unless the center, up and right agree to 1e-6."""
    import dataclasses

    from cppf_tpu_torch.eval.nocs_inference import CategoryRunner
    from cppf_tpu_torch.models.convert import ASSETS
    from cppf_tpu_torch.pipeline.pose import PoseDraws

    for cat, runner in runners.items():
        z = np.load(os.path.join(ASSETS, f"{cat}_views.npz"))
        lup = z["laptop_up_1"] if cat == "laptop" else None
        cpu = CategoryRunner(cat, device="cpu")
        pcfg = dataclasses.replace(runner.pcfg, n_pairs=PHASE9_PAIRS)
        gpu_pcfg, cpu.pcfg, runner.pcfg = runner.pcfg, pcfg, pcfg
        try:
            draws = PoseDraws.sample(pcfg, torch.Generator().manual_seed(9), "cpu",
                                     n_raw=runner.cfg.npoint_max)
            t0 = time.perf_counter()
            out_cpu = cpu.estimate(z["pc_1"], draws=draws, laptop_up=lup)[0]
            t_cpu = time.perf_counter() - t0
            out_gpu = runner.estimate(z["pc_1"], draws=draws.to("cuda"), laptop_up=lup)[0]
        finally:
            runner.pcfg = gpu_pcfg
        d = {k: float((getattr(out_cpu, k) - getattr(out_gpu, k).cpu()).abs().max())
             for k in ("T", "up", "right")}
        print(f"cpu vs cuda, {cat}, {PHASE9_PAIRS} pairs, identical draws: |dT| {d['T']:.2e}, "
              f"|d up| {d['up']:.2e}, |d right| {d['right']:.2e}, survivors "
              f"{int(out_cpu.n_filtered)} vs {int(out_gpu.n_filtered)} (cpu {t_cpu:.1f} s)",
              flush=True)
        check(max(d.values()) < 1e-6, f"{cat}: CPU and CUDA poses differ: {d}")


def stage_times(runner, pc_raw, reps: int = 5):
    """Each stage of warm poses as the program's spans (``utils/prof.py``)
    record it under a profiler: its host self time (its span less its
    children's) and its device interval (the card's time between the span's
    CUDA events), medians of ``reps`` poses, nothing synchronised between
    stages."""
    from torch.profiler import ProfilerActivity, profile

    from cppf_tpu_torch.utils import prof

    runner.estimate(pc_raw)
    torch.cuda.synchronize()
    rows = {}
    for _ in range(reps):
        prof.clear_spans()
        with profile(activities=[ProfilerActivity.CUDA]):
            runner.estimate(pc_raw)
            torch.cuda.synchronize()
        spans = prof.spans()
        prof.clear_spans()
        child_s = {}
        for sp in spans:
            if sp.parent is not None:
                child_s[sp.parent] = child_s.get(sp.parent, 0.0) + sp.host_s
        seen = {}
        for sp in spans:
            label = " ".join([sp.name] + [f"{k}={v}" for k, v in sorted(sp.attrs.items())
                                          if k in ("pass", "axis")])
            seen[label] = seen.get(label, 0) + 1
            label += f" #{seen[label]}" if seen[label] > 1 else ""
            rows.setdefault(label, []).append((sp.host_s - child_s.get(sp.id, 0.0), sp.device_s,
                                               sp.host_syncs))
    for label, vals in rows.items():
        host, dev, syncs = (statistics.median(v) for v in zip(*vals))
        print(f"  stage {label}: host self {host * 1e3:.3f} ms, device {dev * 1e3:.3f} ms, "
              f"{syncs:g} host syncs", flush=True)


def device_profile(fn, what, top=15):
    """One call of ``fn`` under torch.profiler: its wall time (host clock,
    synchronised), the device's busy time by kernel and its idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the program's spans are ranges on the card too (user annotations):
    # kernels only
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and not e.is_user_annotation]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"profile: {what}: wall {wall_ms:.2f} ms under the profiler, device busy "
          f"{busy_ms:.2f} ms over {launches} kernel launches (idle share "
          f"{1 - busy_ms / wall_ms:.3f})", flush=True)
    for e in kernels[:top]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  {e.count:5d}x  {e.key[:100]}")
    return wall_ms, busy_ms, launches


def profile_pose(runner, pc_raw):
    """Device time by kernel over one warm pose, and the device's idle share."""
    runner.estimate(pc_raw)
    device_profile(lambda: runner.estimate(pc_raw), "one warm pose")


def _timer(device, times):
    """``timed(name, fn)``: runs ``fn``, its seconds (synchronised on the
    card) into ``times[name]``."""
    def timed(name, fn):
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if device != "cpu":
            torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out
    return timed


def heatmap_stages(encoders, cfg, depth, intrinsics, n_pairs, device, num_rots, timed):
    """Stages 1-3 of ``zero_shot_heatmap`` one by one, each through
    ``timed``.  Returns (HeatmapState, the network cloud's point count)."""
    from cppf_tpu_torch.eval import zero_shot as zs

    rng = np.random.default_rng(0)

    def prep():
        clouds = zs.frame_clouds(depth, intrinsics, cfg.res, cfg.knn, rng, device)
        pc, nrm = clouds.high_pc[clouds.lo_idx], clouds.high_normal[clouds.lo_idx]
        return clouds, pc, nrm, zs.sample_pairs(pc, nrm, n_pairs, rng)

    with torch.no_grad():
        clouds, pc, nrm, pairs = timed("prep (cloud, voxels, KNN, normals, pairs)", prep)
        preds = timed("network (SPRIN + PPF head)",
                      lambda: zs.frame_predictions(*encoders, clouds, pairs))
        grid, corner, dims = timed("heatmap (ppf_vote_dense)", lambda: zs.frame_heatmap(
            pc, preds[:, :2].contiguous(), pairs, cfg.res, num_rots))
    return zs.HeatmapState(pc, nrm, pairs, preds, grid, corner, dims), clouds.high_pc.shape[0]


def zero_shot_stages(encoders, cfg, z, n_pairs, device, prop_thresh=50.0, contrib_thresh=12):
    """The zero-shot path stage by stage on the demo frame, each stage
    synchronised.  Returns (HeatmapState, detections, {stage: seconds},
    the network cloud's point count)."""
    from cppf_tpu_torch.eval import zero_shot as zs

    times = {}
    timed = _timer(device, times)
    hm, n_high = heatmap_stages(encoders, cfg, z["depth"], z["intrinsics"], n_pairs, device, 72,
                                timed)
    with torch.no_grad():
        dets = timed("detect (proposals, re-rank, back-vote, axes)",
                     lambda: zs.detect_from_heatmap(hm, cfg, prop_thresh=prop_thresh,
                                                    contrib_thresh=contrib_thresh,
                                                    plane_u=z["plane_u"]))
    return hm, dets, times, n_high


def _dense_taps(votes, c, pool):
    """Flat pooled ids and values of the 8 trilinear taps of every live vote,
    for the one-call index_add_ yardstick."""
    live = votes[6] != 0
    fx, fy, fz, rx, ry, rz, w = (t[live] for t in votes)
    ids, vals = [], []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ids.append((((fx.long() + dx) // pool[0] * c[1] + (fy.long() + dy) // pool[1])
                            * c[2] + (fz.long() + dz) // pool[2]))
                vals.append(((rx if dx else 1 - rx) * w) * (ry if dy else 1 - ry)
                            * (rz if dz else 1 - rz))
    return torch.cat(ids), torch.cat(vals)


DENSE_CHUNK = 1 << 20  # pairs a plain-version call: the zero-shot path's own chunk


def _dense_plain(params, frame, grid_shape, kw, dtype=torch.float32, votes=None, n_rots=72):
    """dense_hist's plain version on the votes of ``params`` (or on
    ``votes``, ``n_rots`` a pair), made and summed one pair chunk at a time,
    in ``dtype``."""
    from cppf_tpu_torch.ops import vote_hist as vh

    n_pairs = params.shape[0] if votes is None else votes[0].shape[0] // n_rots
    out = torch.zeros((kw["cx"], kw["cy"], kw["cz"]), dtype=dtype,
                      device=(params if votes is None else votes[0]).device)
    for s in range(0, n_pairs, DENSE_CHUNK):
        if votes is None:
            v = vh._plain_votes(params[s:s + DENSE_CHUNK], frame, grid_shape, n_rots)
        else:
            v = [t[s * n_rots:(s + DENSE_CHUNK) * n_rots] for t in votes]
        vh.dense_hist_plain(*v[:3], *(t.to(dtype) for t in v[3:]), **kw, out=out)
    return out


def dense_record(params, frame, grid_shape, pool, label, adaptive=True, timed=True, n_rots=72,
                 votes=None):
    """Both front ends of dense_hist against the plain version on the votes
    of ``params`` in one grid: the pairs front end (one launch over every
    pair) and the votes front end (one launch over their flat votes), each
    against the float32 plain version within 1e-3 of the maximum and against
    the plain version summed in float64 within ``EXACT_RTOL`` (the pairs
    front end under adaptive rotations: 1e-3).  When ``timed``, times both in
    turns beside the plain version and one index_add_ of the live taps, with
    both bounds.  Returns the record for the kernels line: unprefixed keys
    for the pairs front end, which the zero-shot path launches, ``votes_``
    keys for the votes front end.  Given ``votes`` and no ``params`` (the
    votes of a gated center pass), the votes front end alone."""
    from cppf_tpu_torch.ops import vote_hist as vh

    c = [-(-g // p) for g, p in zip(grid_shape, pool)]
    kw = dict(cx=c[0], cy=c[1], cz=c[2], px=pool[0], py=pool[1], pz=pool[2])
    pkw = dict(n_rots=n_rots, grid_shape=grid_shape, **kw)
    pairs = params is not None
    if pairs:
        votes = [torch.cat(t) for t in zip(*(
            [a.contiguous() for a in vh._plain_votes(params[s:s + DENSE_CHUNK], frame,
                                                     grid_shape, n_rots)]
            for s in range(0, params.shape[0], DENSE_CHUNK)))]
    expect = _dense_plain(params, frame, grid_shape, kw, votes=votes, n_rots=n_rots)
    exact = _dense_plain(params, frame, grid_shape, kw, torch.float64, votes=votes,
                         n_rots=n_rots).float()
    rec = {}
    fronts = ([("", lambda: vh.dense_hist_pairs(params, frame, **pkw), not adaptive)]
              if pairs else [])
    for prefix, fn, tight in fronts + [("votes_", lambda: vh.dense_hist(*votes, **kw), True)]:
        end = "votes front end" if prefix else "pairs front end"
        got = fn()
        err, rel = _max_err([got], [expect], f"dense_hist {label}, {end}")
        rtol = EXACT_RTOL if tight else KERNEL_RTOL
        lo, hi = _exact_err([got], [exact], f"dense_hist {label}, {end}", rtol, rtol)
        rec.update({prefix + "max_abs_err": err, prefix + "rel_err": rel})
        print(f"kernel dense_hist [{label}, grid {tuple(c)}, pool {pool}], {end}: max abs err "
              f"{err:.3e} (rel {rel:.3e}); kernel minus float64 sums in [{lo:.3e}, {hi:.3e}] of "
              f"the maximum", flush=True)
        del got
    del expect, exact
    if not timed:
        return rec
    w = votes[6]
    V = w.shape[0]
    live = w != 0
    n_live = int(live.sum())
    # distinct pooled taps of each live vote: the atomics of the votes front end
    n_ax = [1 + ((f[live].long() + 1) // p != f[live].long() // p).long()
            for f, p in zip(votes[:3], pool)]
    taps = n_ax[0] * n_ax[1] * n_ax[2]
    atomics = int(taps.sum())
    splat_ops = int((3 + n_ax[0] + n_ax[0] * n_ax[1] + 2 * taps).sum())
    del n_ax, taps
    cells = c[0] * c[1] * c[2]
    buf = torch.zeros(tuple(c), device=w.device)
    ms = cuda_ms_turns([lambda: vh.dense_hist(*votes, **kw, out=buf)]
                       + ([lambda: vh.dense_hist_pairs(params, frame, **pkw, out=buf)]
                          if pairs else []))
    rec.update(votes_ms=ms[0], atomics=atomics, live=n_live, V=V,
               votes_plain_ms=cuda_ms(lambda: _dense_plain(params, frame, grid_shape, kw,
                                                            votes=votes, n_rots=n_rots)))
    ids, vals = _dense_taps(votes, c, pool)
    del votes
    flat = torch.zeros(cells, device=w.device)
    rec["library_ms"] = cuda_ms(lambda: flat.index_add_(0, ids, vals))
    del ids, vals
    _set_bound(rec, "votes_", 4 * V + 6 * 4 * n_live + 4 * cells, splat_ops)
    if not pairs:
        print(f"kernel dense_hist [{label}, grid {tuple(c)}, pool {pool}, V={V}, "
              f"live={n_live}]: votes front end {ms[0]:.4f} ms (bound "
              f"{rec['votes_bound_ms']:.5f} ms by {rec['votes_bound_by']}: "
              f"{rec['votes_bound_terms']}; plain {rec['votes_plain_ms']:.4f} ms), index_add_ of "
              f"the live taps {rec['library_ms']:.4f} ms", flush=True)
        return rec
    rec.update(ms=ms[1], plain_ms=cuda_ms(lambda: _dense_plain(params, frame, grid_shape, kw,
                                                                n_rots=n_rots)))
    pair_bytes, pair_ops, _ = _pairs_work(params, n_rots, n_live)
    _set_bound(rec, "", pair_bytes + 4 * cells, pair_ops + splat_ops)
    votes_ms, ms = ms
    print(f"kernel dense_hist [{label}, grid {tuple(c)}, pool {pool}, {params.shape[0]} pairs, "
          f"V={V}, live={n_live}]: pairs front end {ms:.4f} ms (bound {rec['bound_ms']:.5f} ms by "
          f"{rec['bound_by']}: {rec['bound_terms']}; plain, votes made first, "
          f"{rec['plain_ms']:.4f} ms), votes front end {votes_ms:.4f} ms (bound "
          f"{rec['votes_bound_ms']:.5f} ms by {rec['votes_bound_by']}: "
          f"{rec['votes_bound_terms']}; plain {rec['votes_plain_ms']:.4f} ms), index_add_ of the "
          f"live taps {rec['library_ms']:.4f} ms; {atomics} pooled taps = "
          f"{atomics / ms * 1e3:.3e}/s (pairs), {atomics / votes_ms * 1e3:.3e}/s (votes)",
          flush=True)
    return rec


def dense_shapes(hm, res):
    """The zero-shot path's dense_hist inputs on the demo frame: (label, pair
    parameters as a function of ``adaptive``, frame, fine grid, pool) for the
    first 2^20 pairs on the unpooled whole-frame grid and on the sparse
    route's pool-8 coarse grid, one 48³ window of the sparse route, and every
    pair of the frame."""
    from cppf_tpu_torch.eval import zero_shot as zs
    from cppf_tpu_torch.ops import vote_hist as vh
    from cppf_tpu_torch.ops.voting import pair_vote_params

    dev = hm.pc.device
    n = hm.pc.shape[0]
    preds_tr = hm.preds[:, :2].contiguous()
    dims = hm.dims

    def params(idxs, comp=1.0):
        def make(adaptive):
            return pair_vote_params(hm.pc, preds_tr[idxs], torch.full((n,), comp, device=dev),
                                    hm.point_idxs[idxs], res, 72, adaptive,
                                    torch.ones(hm.point_idxs[idxs].shape[0], dtype=torch.bool,
                                               device=dev))
        return make

    def frame(corner, gdims):
        return vh.vote_frame(torch.as_tensor(corner, device=dev), res,
                             torch.as_tensor(gdims, device=dev).float())

    sel = slice(0, DENSE_CHUNK)
    gshape = tuple(int(np.ceil(d / 8) * 8) for d in dims)
    gshape_c = tuple(int(np.ceil(d / 64) * 64) for d in dims)
    f_frame = frame(hm.corner, dims)
    shapes = [("frame chunk, unpooled", params(sel), f_frame, gshape, (1, 1, 1)),
              ("frame chunk, pool-8 coarse grid", params(sel), f_frame, gshape_c, (8, 8, 8))]
    coarse = vh.dense_hist_pairs(shapes[1][1](True), f_frame, n_rots=72, grid_shape=gshape_c,
                                 cx=gshape_c[0] // 8, cy=gshape_c[1] // 8, cz=gshape_c[2] // 8,
                                 px=8, py=8, pz=8)
    cell = np.array(np.unravel_index(int(torch.argmax(coarse)), coarse.shape))
    wo = zs._window_origin(cell, dims, 48, 8)
    keep, comp = zs._window_pairs(wo, zs._pair_circles(hm.pc, preds_tr, hm.point_idxs, res, 48),
                                  hm.corner, res, 48, 1 << 17)
    shapes.append((f"48^3 window at {tuple(int(x) for x in wo)}",
                   params(keep, comp), frame((hm.corner + wo * res).astype(np.float32),
                                             np.minimum(dims - wo, 48)), (48, 48, 48), (1, 1, 1)))
    shapes.append(("whole frame, unpooled", params(slice(None)), f_frame, gshape, (1, 1, 1)))
    return shapes


def dense_phase(hm, res):
    """Phase 6: both front ends of dense_hist at the zero-shot path's shapes
    (timed, adaptive rotations as the path votes), and the first three again
    without adaptive rotations (held to float64 within ``EXACT_RTOL``)."""
    records = {}
    for label, params, frame, grid_shape, pool in dense_shapes(hm, res):
        records[label] = dense_record(params(True), frame, grid_shape, pool, label)
        if not label.startswith("whole"):
            dense_record(params(False), frame, grid_shape, pool, label + ", not adaptive",
                         adaptive=False, timed=False)
    return records


def _match(dets, centers):
    """Each of ``centers`` with its nearest detection: (distance, detection)."""
    out = []
    for c in centers:
        d = [float(np.linalg.norm(x.T - c)) for x in dets]
        out.append((min(d), dets[int(np.argmin(d))]))
    return out


def profile_frame(encoders, cfg, z, device):
    """Device time by kernel over one warm zero-shot frame, and the device's
    idle share."""
    device_profile(lambda: zero_shot_stages(encoders, cfg, z, ZS_PAIRS, device),
                   "zero-shot frame", top=12)


def zero_shot_phase(z, device, profile=False):
    """Phase 7: the zero-shot path at full width on the demo frame."""
    from cppf_tpu_torch.config import load_config
    from cppf_tpu_torch.eval import zero_shot as zs
    from cppf_tpu_torch.models.convert import ASSETS, load_encoders, load_npz_params
    from cppf_tpu_torch.ops import vote_hist as vh

    cfg = load_config("bowl", snapshot=os.path.join(ROOT, "checkpoints", "bowl_reg",
                                                    "config.yaml"))
    cfg.cls_bins = False
    check(cfg.res == 0.004 and cfg.knn == 60, f"not bowl_reg's width: {cfg}")
    params = load_npz_params(os.path.join(ASSETS, "bowl_reg_params_zs.npz"))
    encoders = load_encoders(params, 9, device)
    # warm-up, and the votes of phase 6
    hm, _, _, n_high = zero_shot_stages(encoders, cfg, z, ZS_PAIRS, device)
    print(f"zero-shot frame: network cloud {n_high} points, voting cloud {hm.pc.shape[0]} "
          f"points, {hm.point_idxs.shape[0]} "
          f"pairs after the degenerate filter (JAX CPU: {int(z['jax_n_pairs'])}), heatmap "
          f"{tuple(int(d) for d in hm.dims)}", flush=True)
    records = dense_phase(hm, cfg.res)
    del hm

    # ---- 7. the zero-shot path --------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    vh.reset_launches()
    dets = zs.zero_shot_detect(z["depth"], encoders, cfg, intrinsics=z["intrinsics"],
                               n_pairs=ZS_PAIRS, device=device, plane_u=z["plane_u"])
    torch.cuda.synchronize()
    launches = dict(vh.LAUNCHES)
    print(f"zero-shot path launches over 1 frame: {launches}", flush=True)
    check(launches["dense_hist_pairs"] > 0, "dense_hist_pairs never launched on the zero-shot path")
    check(launches["dense_hist"] == 0, "the zero-shot path built vote vectors for dense_hist")
    for d in dets:
        print(f"detection: T {np.round(d.T, 4)}, scale {np.round(d.scale, 4)}, "
              f"up {np.round(d.R[:, 1], 4)}, score {d.score:.1f}, mask {int(d.mask.sum())} points",
              flush=True)
    check(len(dets) == 2, f"{len(dets)} detections, not the 2 demo bowls")
    for dist, d in _match(dets, BOWL_CENTERS):
        check(dist < 0.04, f"a detection is {dist * 1e3:.1f} mm from its bowl (>= 40 mm)")
        check(0.10 < d.scale[0] < 0.22 and 0.10 < d.scale[2] < 0.22 and 0.02 < d.scale[1] < 0.09,
              f"scale {d.scale} is not a bowl's")
    for T, R in zip(z["jax_T"], z["jax_R"]):
        dist, d = _match(dets, [T])[0]
        up = float(np.degrees(np.arccos(np.clip(d.R[:, 1] @ R[:, 1], -1, 1))))
        print(f"against the JAX CPU detection at {np.round(T, 4)}: T {dist * 1e3:.3f} mm, "
              f"up {up:.3f} deg", flush=True)
        check(dist < 0.01 and up < 5.0, "a detection is > 1 cm or > 5 deg from JAX's")

    stage_runs = []
    for _ in range(3):
        hm, _, times, _ = zero_shot_stages(encoders, cfg, z, ZS_PAIRS, device)
        stage_runs.append(times)
    totals = [sum(t.values()) for t in stage_runs]
    print(f"zero-shot path: warm {statistics.median(totals):.4f} s/frame (median of 3, "
          f"{', '.join(f'{t:.4f}' for t in totals)}), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for name in stage_runs[0]:
        print(f"  stage {name}: {statistics.median(t[name] for t in stage_runs):.4f} s",
              flush=True)
    # the heatmap stage alone must allocate less than one [2^20, 72] vote vector
    preds_tr = hm.preds[:, :2].contiguous()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zs.frame_heatmap(hm.pc, preds_tr, hm.point_idxs, cfg.res, 72)
    torch.cuda.synchronize()
    heat_bytes = torch.cuda.max_memory_allocated() - base
    vector_bytes = 4 * DENSE_CHUNK * 72
    print(f"heatmap stage: peak device memory {heat_bytes / 2**20:.2f} MiB above its inputs (one "
          f"[2^20, 72] float32 vote vector is {vector_bytes / 2**20:.2f} MiB)", flush=True)
    check(heat_bytes < vector_bytes, "the heatmap stage made a [P, R] vote vector")
    if profile:
        profile_frame(encoders, cfg, z, device)

    # the sparse route (coarse pool-8 pass, then 48³ windows): once at its
    # defaults, whose candidate cap and pair budget make it approximate on
    # this frame (reported, not held to the dense route), and once with no
    # pair budget, where every voxel it writes must equal the dense grid's
    t0 = time.perf_counter()
    grid_s, corner, dims = zs.frame_heatmap(hm.pc, hm.preds[:, :2].contiguous(), hm.point_idxs,
                                            cfg.res, 72, sparse=True)
    torch.cuda.synchronize()
    t_sparse = time.perf_counter() - t0
    p_dense = zs.extract_proposals_host(hm.grid, corner, cfg.res)
    p_sparse = zs.extract_proposals_host(grid_s, corner, cfg.res)
    d_sparse = zs.detect_from_heatmap(hm._replace(grid=grid_s), cfg, plane_u=z["plane_u"])
    print(f"sparse route at its defaults: heatmap {t_sparse:.4f} s, {len(p_sparse)} proposals "
          f"against the dense route's {len(p_dense)}, {len(d_sparse)} detections at "
          f"{[np.round(d.T, 4).tolist() for d in d_sparse]}", flush=True)
    exact = zs._sparse_frame_grid(hm.pc, hm.preds[:, :2].contiguous(), hm.point_idxs, corner,
                                  dims, cfg.res, 72, pair_budget=1 << 62)
    written = exact != 0
    err = float(np.abs(exact - hm.grid)[written].max())
    print(f"sparse route without a pair budget: {int(written.sum())} voxels written, max abs "
          f"difference from the dense grid {err:.3e} (max {hm.grid.max():.3f})", flush=True)
    check(written.sum() > 0 and err <= KERNEL_RTOL * hm.grid.max(),
          "the sparse route's exact windows differ from the dense grid")
    del hm, grid_s, exact

    # CPU (plain versions) against CUDA (kernels) at 200 000 pairs; the
    # vote thresholds scale with the pairs (proposal contrast 50 and
    # membership count 12 at 5 M pairs become 2 and 0)
    ratio = REDUCED_PAIRS / ZS_PAIRS
    thresh = dict(prop_thresh=50.0 * ratio, contrib_thresh=int(12 * ratio))
    cpu_enc = load_encoders(params, 9, "cpu")
    _, d_cpu, t_cpu, _ = zero_shot_stages(cpu_enc, cfg, z, REDUCED_PAIRS, "cpu", **thresh)
    _, d_gpu, _, _ = zero_shot_stages(encoders, cfg, z, REDUCED_PAIRS, device, **thresh)
    dT = [float(np.linalg.norm(a.T - b.T)) for a, b in zip(d_cpu, d_gpu)]
    print(f"cpu vs cuda at {REDUCED_PAIRS} pairs: {len(d_cpu)} vs {len(d_gpu)} detections, "
          f"|dT| {dT} m (cpu run {sum(t_cpu.values()):.1f} s)", flush=True)
    check(len(d_cpu) == len(d_gpu) > 0, "CPU and CUDA detection counts differ")
    check(max(dT) < 1e-3, "CPU and CUDA detections are more than 1 mm apart")
    return records, launches


# the up-symmetric NOCS classes of the eval (eval/nocs_eval.py::load_results);
# their up axis is compared with JAX's up to sign
UP_SYMMETRIC = ("bowl", "bottle", "can")
NOCS_T_TOL = 0.01
NOCS_UP_TOL_DEG = 5.0


def unpack_nocs_frame(tmp, frame="nocs_frame", laptop_aux=None):
    """A committed frame (``assets/<frame>``) as the driver reads it:
    ``tmp/nocs/real/...``, ``tmp/seg/results_*.pkl``, and a checkpoint tree
    ``tmp/checkpoints`` of links to the repo's ``checkpoints/<cat>`` for the
    frame's categories, and ``laptop_aux`` linked to the directory
    ``laptop_aux`` when one is given.  Returns (seg_dir, nocs_dir,
    ckpt_path, the record, the stored JAX run)."""
    import gzip
    import pickle
    import shutil

    from cppf_tpu_torch.eval.nocs_inference import SYNSET_NAMES
    from cppf_tpu_torch.models.convert import ASSETS

    src = os.path.join(ASSETS, frame)
    shutil.copytree(os.path.join(src, "real"), os.path.join(tmp, "nocs", "real"))
    with gzip.open(os.path.join(src, "results_real_scene1_0000.pkl.gz"), "rb") as f:
        record = pickle.load(f)
    os.makedirs(os.path.join(tmp, "seg"))
    with open(os.path.join(tmp, "seg", "results_real_scene1_0000.pkl"), "wb") as f:
        pickle.dump(record, f)
    ckpt = os.path.join(tmp, "checkpoints")
    os.makedirs(ckpt)
    for cat in sorted({SYNSET_NAMES[c] for c in record["pred_class_ids"]}):
        os.symlink(os.path.join(ROOT, "checkpoints", cat), os.path.join(ckpt, cat))
    if laptop_aux is not None:
        os.symlink(os.path.abspath(laptop_aux), os.path.join(ckpt, "laptop_aux"))
    return (os.path.join(tmp, "seg"), os.path.join(tmp, "nocs"), ckpt, record,
            dict(np.load(os.path.join(src, "jax_driver.npz"))))


SUN_SCANS = ("sun_scans", "scans.npz")


def sun_scans_to_arrays(scans) -> dict:
    """A SUN scan set (a list of dicts: ``pc`` [N, 3] float32 as dumped,
    ``rot`` [3, 3], ``bbox`` [n, 8], ``segments`` [n] index arrays,
    ``Rtilt`` [3, 3]) as flat arrays for one ``.npz``."""
    out = {"n_scans": np.int32(len(scans))}
    for i, s in enumerate(scans):
        out.update({f"scan{i}_pc": s["pc"], f"scan{i}_rot": s["rot"], f"scan{i}_bbox": s["bbox"],
                    f"scan{i}_Rtilt": s["Rtilt"],
                    f"scan{i}_seg": np.concatenate(s["segments"]).astype(np.int32),
                    f"scan{i}_seg_len": np.array([len(g) for g in s["segments"]], np.int32)})
    return out


def sun_scans_from_arrays(z) -> list:
    scans = []
    for i in range(int(z["n_scans"])):
        cut = np.cumsum(z[f"scan{i}_seg_len"])[:-1]
        scans.append(dict(pc=z[f"scan{i}_pc"], rot=z[f"scan{i}_rot"], bbox=z[f"scan{i}_bbox"],
                          Rtilt=z[f"scan{i}_Rtilt"],
                          segments=[g.astype(np.int64) for g in np.split(z[f"scan{i}_seg"], cut)]))
    return scans


def write_sun_layout(scans, root):
    """The on-disk layout that both packages' SUN drivers read, scan ``n``
    being ``scans[n - 1]``: ``root/sunrgbd/SUNRGBDtoolbox/Metadata/
    SUNRGBDMeta.mat`` (each scan's ``Rtilt``), ``root/extra/
    sunrgbd_pc_bbox_votes_50k_v1_val/<n>_{pc.npz,rot.npy,bbox.npy,
    segments.pkl}`` and ``root/extra/scan_names_list/<class>_val.txt``,
    the scans that hold a box of the class.  Returns (sunrgbd_dir,
    extra_dir)."""
    import pickle

    import scipy.io as sio

    from cppf_tpu_torch.eval.sunrgbd_inference import META_PATH, SCAN_DIR, SPLIT

    sun_dir, extra_dir = os.path.join(root, "sunrgbd"), os.path.join(root, "extra")
    scan_dir, names_dir = os.path.join(extra_dir, SCAN_DIR), os.path.join(extra_dir,
                                                                          "scan_names_list")
    for d in (os.path.dirname(os.path.join(sun_dir, META_PATH)), scan_dir, names_dir):
        os.makedirs(d, exist_ok=True)
    meta = np.zeros((1, len(scans)), dtype=[("Rtilt", "O")])
    names = {}
    for i, s in enumerate(scans):
        meta[0, i]["Rtilt"] = s["Rtilt"]
        base = os.path.join(scan_dir, str(i + 1))
        np.savez(base + "_pc.npz", pc=s["pc"])
        np.save(base + "_rot.npy", s["rot"])
        np.save(base + "_bbox.npy", s["bbox"])
        with open(base + "_segments.pkl", "wb") as f:
            pickle.dump(list(s["segments"]), f)
        for c in sorted({int(b[7]) for b in s["bbox"]}):
            names.setdefault(c, []).append(str(i + 1))
    sio.savemat(os.path.join(sun_dir, META_PATH), {"SUNRGBDMeta": meta})
    for c, ns in names.items():
        with open(os.path.join(names_dir, f"{c}_{SPLIT}.txt"), "w") as f:
            f.write("\n".join(ns) + "\n")
    return sun_dir, extra_dir


def unpack_sun_scans(tmp):
    """The committed SUN scan set (assets/sun_scans) as the drivers read it
    (:func:`write_sun_layout` under ``tmp``), and a checkpoint tree
    ``tmp/checkpoints`` of links to the repo's ``checkpoints/<cat>`` for the
    categories with weights, as its JAX run had.  Returns (sunrgbd_dir,
    extra_dir, ckpt_path, the scans, the stored JAX run)."""
    from cppf_tpu_torch.eval.sunrgbd_inference import TYPE2CLASS
    from cppf_tpu_torch.models.convert import ASSETS

    src = os.path.join(ASSETS, SUN_SCANS[0])
    with np.load(os.path.join(src, SUN_SCANS[1])) as z:
        scans = sun_scans_from_arrays(z)
    sun_dir, extra_dir = write_sun_layout(scans, tmp)
    ckpt = os.path.join(tmp, "checkpoints")
    os.makedirs(ckpt)
    for cat in TYPE2CLASS:
        if os.path.isdir(os.path.join(ROOT, "checkpoints", cat)):
            os.symlink(os.path.join(ROOT, "checkpoints", cat), os.path.join(ckpt, cat))
    return (sun_dir, extra_dir, ckpt, scans,
            dict(np.load(os.path.join(src, "jax_driver.npz"))))


def nocs_driver_phase(tmp, profile=False):
    """Phase 10: ``nocs_inference.main`` at full width with ``--seed 0`` on
    the committed frame (launch counts reset just before and read just
    after), its poses against the stored JAX driver's, ``nocs_eval.main``
    on the stored JAX pkl against the stored JAX eval, the frame loop timed
    warm, and both peak kernels held against their plain versions and timed
    on the frame's first instance.  Returns (kernel records, launches)."""
    import contextlib
    import io
    import pickle

    from cppf_tpu_torch.core import threefry
    from cppf_tpu_torch.data.png import read_png
    from cppf_tpu_torch.eval import nocs_eval, nocs_inference as ni
    from cppf_tpu_torch.ops import vote_hist as vh

    seg_dir, nocs_dir, ckpt, record, jax_run = unpack_nocs_frame(tmp)
    names = [ni.SYNSET_NAMES[c] for c in record["pred_class_ids"]]
    n = len(names)
    out_dir = os.path.join(tmp, "pred")
    argv = ["--seg_dir", seg_dir, "--nocs_dir", nocs_dir, "--out_dir", out_dir,
            "--ckpt_path", ckpt, "--seed", "0"]
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    vh.reset_launches()
    threefry.LAUNCHES["draws"] = 0
    frames = ni.main(argv)
    torch.cuda.synchronize()
    launches = dict(vh.LAUNCHES, draws=threefry.LAUNCHES["draws"], poses=n)
    cold_s = time.perf_counter() - t0
    print(f"nocs driver: {n} instances ({', '.join(names)}), chunks "
          f"{[(c.category, c.instances, c.batched) for c in frames[0]]}; launches {launches}; "
          f"first run of main {cold_s:.2f} s (runners, weights and first calls included)",
          flush=True)
    args = ni.build_parser().parse_args(argv)
    runners = ni.load_runners(args)
    passes = sum(2 if runners[c].pcfg.asym_center_refine else 1 for c in names)
    check(launches["bound_projections_pairs"] == passes,
          f"nocs driver: bound_projections_pairs launched {launches['bound_projections_pairs']} "
          f"times, not once a center pass ({passes})")
    check(passes <= launches["refine_window_pairs"] <= 2 * passes,
          f"nocs driver: refine_window_pairs launched {launches['refine_window_pairs']} times "
          f"for {passes} center passes")
    check(all(launches[k] == 0 for k in ("bound_projections", "refine_window", "dense_hist",
                                         "dense_hist_pairs")),
          "nocs driver: a votes front end or dense_hist launched")
    check(launches["draws"] == n,
          f"nocs driver: threefry_draws launched {launches['draws']} times, not once a pose ({n})")

    with open(ni.result_path(out_dir, record), "rb") as f:
        res = pickle.load(f)
    RTs, scales = res["pred_RTs"], res["pred_scales"]
    R = RTs[:, :3, :3] / np.cbrt(np.linalg.det(RTs[:, :3, :3]))[:, None, None]
    flips = []
    for i, cat in enumerate(names):
        check(not np.allclose(RTs[i], np.eye(4)), f"nocs driver: instance {i} was not posed")
        check(np.linalg.det(RTs[i][:3, :3]) > 0, f"nocs driver: instance {i} has det(R) <= 0")
        check(abs(np.linalg.norm(scales[i]) - 1) <= 1e-5,
              f"nocs driver: instance {i} |pred_scales| = {np.linalg.norm(scales[i])}")
        dT = float(np.linalg.norm(RTs[i][:3, 3] - jax_run["T"][i]))
        d_up = _angle(R[i][:, 1], jax_run["up"][i], fold=cat in UP_SYMMETRIC)
        d_right = _angle(R[i][:, 0], jax_run["right"][i])
        print(f"  instance {i} ({cat}): port minus JAX T {dT * 1e3:.3f} mm, up {d_up:.3f} deg, "
              f"right {d_right:.3f} deg", flush=True)
        check(dT <= NOCS_T_TOL, f"nocs driver: instance {i} T {dT * 1e3:.2f} mm from JAX's")
        if d_up > NOCS_UP_TOL_DEG:
            flips.append(i)
            print(f"  instance {i} ({cat}): up {d_up:.2f} deg from JAX's (a near-tie flip?)",
                  flush=True)
    check(len(flips) <= 1, f"nocs driver: up axes of instances {flips} differ from JAX's by "
          f"more than {NOCS_UP_TOL_DEG} deg")

    # the port's eval on the stored JAX pkl equals the stored JAX eval
    jax_dir = os.path.join(tmp, "jax_pred")
    os.makedirs(jax_dir)
    with open(ni.result_path(jax_dir, record), "wb") as f:
        pickle.dump(dict(record, pred_RTs=jax_run["pred_RTs"],
                         pred_scales=jax_run["pred_scales"]), f)
    with contextlib.redirect_stdout(io.StringIO()):  # its per-class tables
        got = nocs_eval.main(["--pred_dir", jax_dir, "--subsample", "1"])
    for name, g in zip(("iou_aps", "pose_aps", "pose_pred_matches", "pose_gt_matches"), got):
        want = jax_run[name]
        same = (np.array_equal(g, want) if g.dtype.kind == "i" else
                bool(np.allclose(g, want, rtol=0, atol=1e-12, equal_nan=True)))
        check(same and g.shape == want.shape, f"nocs eval on the JAX pkl: {name} differs")
    print("nocs eval on the stored JAX pkl: iou_aps, pose_aps and the matches equal the stored "
          "JAX eval (1e-12)", flush=True)
    with contextlib.redirect_stdout(io.StringIO()):
        iou_aps, pose_aps = nocs_eval.main(["--pred_dir", out_dir, "--subsample", "1"])[:2]
    print(f"nocs eval on the port's pkl: mean 3D IoU AP at 0.25 {iou_aps[-1, 25]:.4f}, at 0.5 "
          f"{iou_aps[-1, 50]:.4f}; mean pose AP at 10 deg 10 cm {pose_aps[-1, 1, 1]:.4f} (JAX's "
          f"pkl: {jax_run['iou_aps'][-1, 25]:.4f}, {jax_run['iou_aps'][-1, 50]:.4f}, "
          f"{jax_run['pose_aps'][-1, 1, 1]:.4f})", flush=True)

    # the frame loop of main, warm: PNG, crops, poses, their copy to the host
    depth_path = os.path.join(nocs_dir, record["image_path"][5:] + "_depth.png")
    seconds, chunk_ms = [], []
    for rep in range(4):
        torch.cuda.synchronize()
        if rep == 3:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        groups = ni.frame_crops(read_png(depth_path), record, runners)
        _, _, _, chunks = ni.infer_frame(groups, n, runners, threefry.key(0))
        torch.cuda.synchronize()
        if rep < 3:
            seconds.append(time.perf_counter() - t0)
            chunk_ms.append([c.seconds * 1e3 / c.instances for c in chunks])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    per_chunk = [statistics.median(ms) for ms in zip(*chunk_ms)]
    print(f"nocs driver: warm {statistics.median(seconds):.3f} s/frame (median of 3: "
          f"{', '.join(f'{x:.3f}' for x in seconds)}); ms per instance by chunk (median of 3): "
          + "; ".join(f"{c.category} x{c.instances}{' batched' if c.batched else ''} {ms:.1f}"
                      for c, ms in zip(chunks, per_chunk))
          + f"; peak device memory of a frame {peak_gib:.3f} GiB | {smi_line()}", flush=True)

    # the draws alone: what remaking JAX's random numbers costs an instance
    i0, pc0 = next(iter(groups.values()))[0]
    runner = runners[names[i0]]
    draw_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.draws(threefry.key(0))
        torch.cuda.synchronize()
        draw_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"nocs driver: the JAX-key draws of one {names[i0]} instance "
          f"{statistics.median(draw_ms):.2f} ms (median of 3)", flush=True)
    if profile:
        device_profile(lambda: ni.infer_frame(ni.frame_crops(read_png(depth_path), record,
                                                             runners),
                                              n, runners, threefry.key(0)),
                       "one warm nocs frame")

    # both peak kernels on the frame's first instance, against the plain version
    records = kernel_phase(main_path_inputs(runner, pc0, runner.pcfg.grid_shape),
                           f"nocs frame instance {i0} ({names[i0]})")
    return records, launches


SUN_T_TOL = 0.01
SUN_UP_TOL_DEG = 5.0
SUN_SCALE_RTOL = 1e-3
SUN_UP_PRIOR_DEG = 30.0


def _jax_sun_pkls(jax_run, extra_dir, out_dir):
    """The stored JAX driver's result pkls, rebuilt as it wrote them: a row
    [class_id, 1.0, then float32 scalars] for each posed instance, a list
    (maybe empty) for each scan of the class.  Returns the categories."""
    import pickle

    from cppf_tpu_torch.eval.sunrgbd_inference import TYPE2CLASS, scan_names

    os.makedirs(out_dir)
    cats = [c for c, cid in TYPE2CLASS.items() if np.any(jax_run["class_id"] == cid)]
    for cat in cats:
        cid = TYPE2CLASS[cat]
        poses = {name: [] for name in scan_names(extra_dir, cid)}
        for row, c, scan in zip(jax_run["rows"], jax_run["class_id"], jax_run["scan"]):
            if c == cid:
                poses[str(scan)].append([cid, 1.0, *row[2:].astype(np.float32)])
        with open(os.path.join(out_dir, f"results_{cat}.pkl"), "wb") as f:
            pickle.dump(poses, f)
    return cats


def sun_driver_phase(tmp, profile=False):
    """Phase 11: ``sunrgbd_inference.main`` at full width with ``--seed 0``
    and the 30° up prior on the committed scan set (launch counts reset
    just before and read just after), its poses against the stored JAX
    driver's, ``sunrgbd_eval.main`` on the stored JAX pkls against the
    stored JAX eval, the driver's loop timed warm, and both peak kernels
    held against their plain versions and timed on the first instance.
    Returns (kernel records, launches)."""
    import contextlib
    import io
    import pickle

    from cppf_tpu_torch.core import threefry
    from cppf_tpu_torch.eval import sunrgbd_eval, sunrgbd_inference as si
    from cppf_tpu_torch.ops import vote_hist as vh

    sun_dir, extra_dir, ckpt, scans, jax_run = unpack_sun_scans(tmp)
    out_dir = os.path.join(tmp, "pred")
    argv = ["--sunrgbd_dir", sun_dir, "--sunrgbd_extra_dir", extra_dir, "--out_dir", out_dir,
            "--ckpt_path", ckpt, "--seed", "0", "--up_prior_deg", str(SUN_UP_PRIOR_DEG)]
    check(float(jax_run["up_prior_deg"]) == SUN_UP_PRIOR_DEG and int(jax_run["seed"]) == 0,
          "sun driver: the stored JAX run is not at --seed 0 and a 30 deg prior")
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    vh.reset_launches()
    threefry.LAUNCHES["draws"] = 0
    posed = si.main(argv)
    torch.cuda.synchronize()
    launches = dict(vh.LAUNCHES, draws=threefry.LAUNCHES["draws"], poses=len(posed))
    cold_s = time.perf_counter() - t0
    cats = list(dict.fromkeys(p.category for p in posed))
    print(f"sun driver: {len(scans)} scans, {len(posed)} instances ({', '.join(cats)}); "
          f"launches {launches}; first run of main {cold_s:.2f} s (runners, weights and first "
          f"calls included)", flush=True)
    args = si.build_parser().parse_args(argv)
    runners = {cat: si.load_runner(cat, args) for cat in cats}
    passes = sum(2 if runners[p.category].pcfg.asym_center_refine else 1 for p in posed)
    check(launches["bound_projections_pairs"] == passes,
          f"sun driver: bound_projections_pairs launched {launches['bound_projections_pairs']} "
          f"times, not once a center pass ({passes})")
    check(passes <= launches["refine_window_pairs"] <= 2 * passes,
          f"sun driver: refine_window_pairs launched {launches['refine_window_pairs']} times "
          f"for {passes} center passes")
    check(all(launches[k] == 0 for k in ("bound_projections", "refine_window", "dense_hist",
                                         "dense_hist_pairs")),
          "sun driver: a votes front end or dense_hist launched")
    check(launches["draws"] == len(posed),
          f"sun driver: threefry_draws launched {launches['draws']} times, not once a pose "
          f"({len(posed)})")

    # every instance against the stored JAX run, in the drivers' order
    where = [(si.TYPE2CLASS[p.category], int(p.scan), p.index) for p in posed]
    check(where == list(zip(jax_run["class_id"].tolist(), jax_run["scan"].tolist(),
                            jax_run["index"].tolist())),
          "sun driver: not the stored JAX run's instances")
    rows = []
    for cat in cats:
        with open(os.path.join(out_dir, f"results_{cat}.pkl"), "rb") as f:
            rows += [r for scan_rows in pickle.load(f).values() for r in scan_rows]
    rows = np.asarray(rows, np.float64)
    flips = []
    for k, (p, row) in enumerate(zip(posed, rows)):
        R, T, scale = row[5:14].reshape(3, 3), row[14:17], row[2:5]
        cfg = runners[p.category].cfg
        check(np.all(np.isfinite(row)) and np.linalg.det(R) > 0,
              f"sun driver: instance {k} is not a pose")
        check(abs(R[1, 1]) >= np.cos(np.radians(SUN_UP_PRIOR_DEG)) - 1e-6,
              f"sun driver: instance {k}'s up lies outside the prior")
        dT = float(np.linalg.norm(T - jax_run["T"][k]))
        d_up = _angle(R[:, 1], jax_run["up"][k], fold=cfg.up_sym)
        d_right = _angle(R[:, 2] if cfg.z_right else R[:, 0], jax_run["right"][k])
        d_scale = float(np.max(np.abs(scale / jax_run["scale"][k] - 1)))
        print(f"  instance {k} ({p.category}, scan {p.scan}, box {p.index}, {p.points} points): "
              f"port minus JAX T {dT * 1e3:.3f} mm, up {d_up:.3f} deg, right {d_right:.3f} deg, "
              f"scale {d_scale:.2e}", flush=True)
        check(dT <= SUN_T_TOL, f"sun driver: instance {k} T {dT * 1e3:.2f} mm from JAX's")
        check(d_scale <= SUN_SCALE_RTOL, f"sun driver: instance {k} scales {d_scale:.2e} off")
        if d_up > SUN_UP_TOL_DEG:
            flips.append(k)
            print(f"  instance {k} ({p.category}): up {d_up:.2f} deg from JAX's (a near-tie "
                  f"flip?)", flush=True)
    check(len(flips) <= 1, f"sun driver: up axes of instances {flips} differ from JAX's by "
          f"more than {SUN_UP_TOL_DEG} deg")

    # the port's eval on the stored JAX pkls equals the stored JAX eval
    jax_dir = os.path.join(tmp, "jax_pred")
    eval_cats = _jax_sun_pkls(jax_run, extra_dir, jax_dir)
    check(eval_cats == cats, f"sun driver: categories {cats}, the JAX run's {eval_cats}")
    eval_argv = ["--sunrgbd_dir", sun_dir, "--sunrgbd_extra_dir", extra_dir, "--categories",
                 *cats]
    with contextlib.redirect_stdout(io.StringIO()):  # its per-class tables
        got = sunrgbd_eval.main(["--pred_dir", jax_dir, *eval_argv])
    for cat in cats:
        for name, g in zip(("iou_aps", "pose_aps", "pose_pred_matches", "pose_gt_matches"),
                           got[cat]):
            want = jax_run[f"{cat}_{name}"]
            same = (np.array_equal(g, want) if g.dtype.kind == "i" else
                    bool(np.allclose(g, want, rtol=0, atol=1e-12, equal_nan=True)))
            check(same and g.shape == want.shape, f"sun eval on the JAX pkls: {cat} {name} "
                  "differs")
    print("sun eval on the stored JAX pkls: iou_aps, pose_aps and the matches of every "
          "category equal the stored JAX eval (1e-12)", flush=True)
    with contextlib.redirect_stdout(io.StringIO()):
        own = sunrgbd_eval.main(["--pred_dir", out_dir, *eval_argv])
    print("sun eval on the port's pkls, 3D IoU AP at 0.25 / pose AP at 10 deg 10 cm (JAX's "
          "pkls): " + "; ".join(
              f"{cat} {own[cat][0][-1, 25]:.4f} / {own[cat][1][-1, 1, 1]:.4f} "
              f"({got[cat][0][-1, 25]:.4f} / {got[cat][1][-1, 1, 1]:.4f})" for cat in cats),
          flush=True)

    # the driver's loop, warm: scans read, instances cut, posed, rows to the host
    def scan_loop():
        rng, timing = threefry.key(0), []
        for cat in cats:
            cid = si.TYPE2CLASS[cat]
            for name in si.scan_names(extra_dir, cid):
                bboxes, segments, points3d = si.read_scan(extra_dir, name)
                items = si.scan_instances(points3d, bboxes, segments, cid)
                _, rng, t = si.pose_instances(runners[cat], items, rng, cid)
                timing += [(cat, s) for *_, s in t]
        return timing

    per_scan, inst_ms = [], []
    for rep in range(4):
        torch.cuda.synchronize()
        if rep == 3:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        timing = scan_loop()
        torch.cuda.synchronize()
        if rep < 3:
            per_scan.append((time.perf_counter() - t0) / len(scans))
            inst_ms.append(timing)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    by_cat = {cat: statistics.median(s * 1e3 for rep in inst_ms for c, s in rep if c == cat)
              for cat in cats}
    print(f"sun driver: warm {statistics.median(per_scan):.3f} s/scan (the loop over every "
          f"category's scans over {len(scans)} scans, median of 3: "
          f"{', '.join(f'{x:.3f}' for x in per_scan)}); ms an instance by category (median of "
          f"3 passes): " + "; ".join(f"{c} {ms:.1f}" for c, ms in by_cat.items())
          + f"; peak device memory of the loop {peak_gib:.3f} GiB | {smi_line()}", flush=True)

    # the draws alone: what remaking JAX's random numbers costs an instance
    first = posed[0]
    runner = runners[first.category]
    draw_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.draws(threefry.key(0))
        torch.cuda.synchronize()
        draw_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"sun driver: the JAX-key draws of one {first.category} instance "
          f"{statistics.median(draw_ms):.2f} ms (median of 3)", flush=True)
    if profile:
        device_profile(scan_loop, "one warm pass of the sun driver's loop")

    # both peak kernels on the first instance, against the plain version
    bboxes, segments, points3d = si.read_scan(extra_dir, first.scan)
    pc0 = dict(si.scan_instances(points3d, bboxes, segments, si.TYPE2CLASS[first.category]))
    g = runner.pcfg.grid_shape[0]
    records = kernel_phase(main_path_inputs(runner, pc0[first.index], runner.pcfg.grid_shape),
                           f"sun scan {first.scan} box {first.index} ({first.category} {g}^3)")
    return records, launches


# the full width of bowl's shipped checkpoint's training config
TRAIN_STEPS = 20       # one epoch of phase 12 (40 rendered samples, batch 2)
FIXED_BATCH_STEPS = 10


def _train_config():
    """Bowl at the width of ``checkpoints/bowl/config.yaml`` (its training
    snapshot), with a decode validation after every epoch."""
    from cppf_tpu_torch.config import load_config

    cfg = load_config("bowl", snapshot=os.path.join(ROOT, "checkpoints", "bowl", "config.yaml"))
    cfg.decode_val_every = 1
    cfg.max_epoch = 1
    check((cfg.batch_size, cfg.npoint_pad, cfg.npoint_max, cfg.knn, cfg.train_pairs,
           cfg.out_dim, cfg.infer_pairs, cfg.decode_val_poses, cfg.opt.lr,
           cfg.opt.weight_decay) == (2, 4096, 10000, 60, 200000, 141, 100000, 6, 1e-3, 1e-4),
          f"phase 12 not at full width: {cfg}")
    return cfg


def _finite_comps(comps, what):
    vals = {k: float(v) for k, v in comps.items()}
    check(all(np.isfinite(v) for v in vals.values()), f"{what}: a loss is not finite: {vals}")
    return vals


def train_step_times(cfg, state, ds, reps: int = 5):
    """Warm times of the parts of the trainer's own step
    (``train/loop.py::loop_step``), one step after another: the host render
    of a batch's samples (host clock), the JAX-key draws and the batch prep
    on the device (synchronised at their ends) and the step (forward,
    backward, Adam; CUDA events and host clock).  Medians over ``reps``
    after a warm-up step; and the peak device memory of a step."""
    from cppf_tpu_torch.core import threefry
    from cppf_tpu_torch.train import loop, step

    statics = step.TrainStatics.from_config(cfg)
    rng = threefry.key(12345)
    parts = {k: [] for k in ("render", "draws", "prep", "step", "step_device")}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    peak, base = 0, 0
    times = {}

    def mark(part):
        nonlocal base
        if part == "step":
            ev[1].record()
        torch.cuda.synchronize()
        times[part] = time.perf_counter()
        if part == "prep":
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ev[0].record()

    for r in range(reps + 1):
        times["start"] = time.perf_counter()
        rng, _, batch = loop.loop_step(cfg, ds, rng, state, statics, "cuda", mark=mark)
        if r == 0:
            continue
        peak = max(peak, torch.cuda.max_memory_allocated() - base)
        for prev, part in (("start", "render"), ("render", "draws"), ("draws", "prep"),
                           ("prep", "step")):
            parts[part].append((times[part] - times[prev]) * 1e3)
        parts["step_device"].append(ev[0].elapsed_time(ev[1]))
    med = {k: statistics.median(v) for k, v in parts.items()}
    return med, peak, batch, statics


def training_phase(smi, profile=False):
    """Phase 12: supervised training of bowl at full width on the card.
    Returns (kernel records, launches) of its decode validation."""
    import tempfile

    from cppf_tpu_torch.core import threefry
    from cppf_tpu_torch.data.shapenet import ShapeNetRenderDataset
    from cppf_tpu_torch.eval.nocs_inference import CategoryRunner, _pad_cloud
    from cppf_tpu_torch.models.convert import ASSETS, load_npz_params
    from cppf_tpu_torch.ops import vote_hist as vh
    from cppf_tpu_torch.pipeline.pose import PoseDraws, estimate_pose
    from cppf_tpu_torch.train import loop, step
    from cppf_tpu_torch.train.decode_val import DecodeValidator

    device = "cuda"
    cfg = _train_config()
    n_poses = cfg.decode_val_poses

    # (a) one epoch from the flax-style init, a decode validation at its end,
    # launch counts reset just before
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "bowl")
        vh.reset_launches()
        t0 = time.perf_counter()
        out = loop.train(cfg, out_dir=out_dir, epoch_len=TRAIN_STEPS * cfg.batch_size,
                         device=device)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        launches = dict(vh.LAUNCHES)
        state = out["state"]
        check(state.step == TRAIN_STEPS, f"{state.step} steps, not {TRAIN_STEPS}")
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            row = json.loads(f.readline())
        with open(os.path.join(out_dir, "decode_metrics.jsonl")) as f:
            dv_row = json.loads(f.readline())
        _finite_comps({k: v for k, v in row.items() if k.startswith("loss")}, "epoch")
        print(f"phase 12: one epoch of {TRAIN_STEPS} steps at batch {cfg.batch_size} and a "
              f"decode validation of {n_poses} poses in {epoch_s:.2f} s (the loop's own "
              f"wall_s {row['wall_s']}); epoch losses {json.dumps(row)}; decode val "
              f"{json.dumps(dv_row)}; launches {launches}", flush=True)
        check(launches["bound_projections_pairs"] == n_poses,
              f"training decode-val: bound_projections_pairs launched "
              f"{launches['bound_projections_pairs']} times over {n_poses} poses")
        check(0 < launches["refine_window_pairs"] <= 2 * n_poses,
              f"training decode-val: refine_window_pairs launched "
              f"{launches['refine_window_pairs']} times over {n_poses} poses")
        check(launches["bound_projections"] == launches["refine_window"] == 0
              and launches["dense_hist"] == launches["dense_hist_pairs"] == 0,
              "training decode-val launched a votes front end or dense_hist")

        # the trained params_best.npz, served by the runner on a committed view
        runner = CategoryRunner("bowl", ckpt_path=tmp, device=device)
        with np.load(os.path.join(ASSETS, "bowl_views.npz")) as z:
            view = z["pc_0"]
        draws = PoseDraws.sample(runner.pcfg, torch.Generator(device=device).manual_seed(3),
                                 device, n_raw=runner.cfg.npoint_max)
        served, pre = runner.estimate(view, draws=draws)
        direct = estimate_pose(state.point, state.ppf, pre.pc, pre.normals, pre.n_valid,
                               runner.sphere, runner.pcfg, nbr_idx=pre.nbr_idx, draws=draws)
        same = all(torch.equal(getattr(served, k), getattr(direct, k)) for k in ("T", "R", "scale"))
        print(f"phase 12: CategoryRunner('bowl', ckpt_path=<run>) serves the trained "
              f"params_best.npz: T {served.T.tolist()}, equal to the trained modules' "
              f"estimate: {same}", flush=True)
        check(same and bool(torch.isfinite(served.RT).all())
              and float(torch.det(served.R)) > 0, "the served checkpoint's estimate")

    # warm times of the loop's parts, the peak memory of a step, its launches
    ds = ShapeNetRenderDataset(cfg, seed=1)
    med, peak, batch, statics = train_step_times(cfg, state, ds)
    loop_ms = med["render"] + med["draws"] + med["prep"] + med["step"]
    wall_ms, busy_ms, step_launches = device_profile(
        lambda: step.train_step(state, batch, statics), "one warm train step", top=8)
    print(f"phase 12 ({smi}): warm ms a step {loop_ms:.2f} = host render "
          f"{med['render']:.2f} ({med['render'] / cfg.batch_size:.2f} a sample) + draws "
          f"{med['draws']:.2f} + batch prep {med['prep']:.2f} + step (forward, backward, "
          f"Adam) {med['step']:.2f} (device {med['step_device']:.2f}); "
          f"{cfg.batch_size * 1e3 / loop_ms:.2f} samples/s; the epoch's "
          f"{TRAIN_STEPS * cfg.batch_size / row['wall_s']:.2f} samples/s; peak device memory "
          f"of a step {peak / 2**30:.3f} GiB above its inputs; {step_launches} kernel launches "
          f"a step (idle share of a step alone {1 - busy_ms / wall_ms:.3f})", flush=True)
    if profile:
        device_profile(lambda: loop.loop_step(cfg, ds, threefry.key(1), state, statics, device),
                       "one warm loop step (render, prep, step)")

    # (b) a fixed batch from the flax-style init: the loss must fall
    fresh = step.init_train_state(cfg, device)
    losses = [_finite_comps(step.train_step(fresh, batch, statics), "fixed batch")["loss"]
              for _ in range(FIXED_BATCH_STEPS)]
    print(f"phase 12: {FIXED_BATCH_STEPS} steps on one batch: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}", flush=True)
    check(losses[-1] < losses[0], f"the loss did not fall on a fixed batch: {losses}")

    # CPU against CUDA: one step from the same init on the same batch
    states = {dev: step.init_train_state(cfg, dev) for dev in ("cpu", device)}
    batches = {device: batch, "cpu": batch.to("cpu")}
    loss, grads = {}, {}
    for dev, st in states.items():
        st.opt.zero_grad()
        total, _ = step.loss_fn(st, batches[dev], statics)
        total.backward()
        loss[dev] = total.item()
        grads[dev] = [p.grad.cpu() for p in st.opt.param_groups[0]["params"]]
        st.opt.step()
    dl = abs(loss["cpu"] - loss[device]) / abs(loss["cpu"])
    dg = max(float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
             for a, b in zip(grads["cpu"], grads[device]))
    dp = max(float((a.detach() - b.detach().cpu()).abs().max()) for a, b in
             zip(states["cpu"].opt.param_groups[0]["params"],
                 states[device].opt.param_groups[0]["params"]))
    print(f"phase 12: cpu vs cuda, one step: loss {loss['cpu']:.6f} / {loss[device]:.6f} "
          f"(rel {dl:.2e}), gradients within {dg:.2e} of each tensor's max, parameters after "
          f"the step within {dp:.2e}", flush=True)
    check(dl < 1e-5, "CPU and CUDA losses differ")
    check(dg < 1e-3, "CPU and CUDA gradients differ")
    check(dp < 1e-6, "CPU and CUDA parameters differ after a step")

    # decode validation of the committed bowl params, card against CPU
    params = load_npz_params(os.path.join(ASSETS, "bowl_params_best.npz"))
    key = threefry.key(7)
    dv_metrics = {}
    for dev in (device, "cpu"):
        st = step.init_train_state(cfg, dev, params=params)
        validator = DecodeValidator(cfg, dev)
        vh.reset_launches()
        t0 = time.perf_counter()
        dv_metrics[dev] = validator(st.point, st.ppf, key)
        dv_s = time.perf_counter() - t0
        if dev == device:
            dv_launches = dict(vh.LAUNCHES)
            first = validator.poses[0].pc
        print(f"phase 12: decode val of the committed bowl params on {dev}: "
              f"{json.dumps(dv_metrics[dev])} in {dv_s:.2f} s", flush=True)
    check(dv_launches["bound_projections_pairs"] == n_poses
          and 0 < dv_launches["refine_window_pairs"] <= 2 * n_poses
          and dv_launches["bound_projections"] == dv_launches["refine_window"] == 0
          and dv_launches["dense_hist"] == dv_launches["dense_hist_pairs"] == 0,
          f"decode val launches {dv_launches}")
    check(dv_metrics[device] == dv_metrics["cpu"], "decode val differs between CPU and CUDA")
    check(dv_metrics[device]["dv_up_deg"] < 15.0,
          f"decode val up error {dv_metrics[device]['dv_up_deg']} deg >= 15")

    # both peak kernels at a decode-val pose's shapes, against the plain version
    runner = CategoryRunner("bowl", device=device)
    pad, n_raw = _pad_cloud(first, cfg.npoint_max)
    records = kernel_phase(main_path_inputs(runner, pad[:n_raw], runner.pcfg.grid_shape),
                           "training decode-val pose 0 (bowl 64^3)")
    return records, launches


# ---- 13. the pair-sharded pose and the data-parallel step -------------------
LAPTOP_FRAME = "nocs_laptop_frame"
LAPTOP_TRAIN_S = 45.0         # phase 14's training budget, the timing steps apart
LAPTOP_MIN_STEPS = 20
LAPTOP_FRAME_REPS = 3         # warm frame loops timed, after one warm-up
LAPTOP_BATCH = 16             # the JAX trainer's defaults: batch 16, 224², Adam 1e-3
LAPTOP_CHECK_BATCH = 2        # samples of the float64 CPU-against-CUDA step
LAPTOP_UP_TOL_RAD = 1e-5
LAPTOP_POSE_UP_TOL_DEG = 0.1


def _seg_step_times(ds, device, reps=3):
    """Warm times of the segmenter trainer's parts: rendering a batch on the
    host (host clock) and the step (forward, backward, Adam; CUDA events),
    medians of ``reps`` after a warm-up step; and the peak device memory of
    a step above its inputs."""
    from cppf_tpu_torch.models.segmenter import FCNResNet50
    from cppf_tpu_torch.train import laptop_aux as tl

    model = FCNResNet50().to(device).train()
    opt = tl.make_optimizer(model)
    dropout = torch.Generator(device=device).manual_seed(1)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    render, step, peak = [], [], 0
    for r in range(reps + 1):
        t0 = time.perf_counter()
        rgb, labels = tl.sample_batch(ds, LAPTOP_BATCH, device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ev[0].record()
        tl.seg_train_step(model, opt, rgb, labels, dropout)
        ev[1].record()
        torch.cuda.synchronize()
        if r:
            render.append((t1 - t0) * 1e3)
            step.append(ev[0].elapsed_time(ev[1]))
            peak = max(peak, torch.cuda.max_memory_allocated() - base)
    return statistics.median(render), statistics.median(step), peak, (model, opt, rgb, labels)


def _seg_step_cpu_cuda(rgb, labels, dtype, device):
    """One step from the same flax-style init on the same batch on the CPU
    and on the card, in ``dtype``: (relative loss difference, gradients'
    largest difference over each tensor's maximum, parameters' largest
    difference after the step, the losses)."""
    from cppf_tpu_torch.models.segmenter import FCNResNet50
    from cppf_tpu_torch.train import laptop_aux as tl
    from cppf_tpu_torch.train.step import flax_init_

    loss, grads, params = {}, {}, {}
    for dev in ("cpu", device):
        model = FCNResNet50()
        flax_init_(model, torch.Generator().manual_seed(3))
        model = model.to(dev, dtype).train()
        opt = tl.make_optimizer(model)
        opt.zero_grad()
        total = tl.ce_ignore_loss(model(rgb.to(dev, dtype)), labels.to(dev))
        total.backward()
        loss[dev] = total.item()
        grads[dev] = [p.grad.cpu() for p in model.parameters()]
        opt.step()
        params[dev] = [p.detach().cpu() for p in model.parameters()]
    dl = abs(loss["cpu"] - loss[device]) / abs(loss["cpu"])
    dg = max(float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
             for a, b in zip(grads["cpu"], grads[device]))
    dp = max(float((a - b).abs().max()) for a, b in zip(params["cpu"], params[device]))
    return dl, dg, dp, loss


def laptop_phase(smi, profile=False):
    """Phase 14: the laptop segmenter trained on the card, served, and the
    NOCS driver's laptop override on the committed laptop frame.
    Returns (kernel records, launches) of the driver's run on the frame."""
    import pickle
    import tempfile

    from cppf_tpu_torch.core import threefry
    from cppf_tpu_torch.data.laptop_aux import LaptopAuxDataset
    from cppf_tpu_torch.data.png import read_png
    from cppf_tpu_torch.eval import nocs_inference as ni
    from cppf_tpu_torch.models.segmenter import FCNResNet50, SegmenterRunner
    from cppf_tpu_torch.ops import vote_hist as vh
    from cppf_tpu_torch.train import laptop_aux as tl
    from cppf_tpu_torch.train.step import flax_init_

    device = "cuda"
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    no_blender = os.path.join(tmp, "no_blender_renders")

    # (a) training at full width on the synthetic stream
    ds = LaptopAuxDataset(data_root=no_blender, seed=11)
    render_ms, step_ms, peak, (model, opt, rgb, labels) = _seg_step_times(ds, device)
    steps = max(LAPTOP_MIN_STEPS, int(LAPTOP_TRAIN_S * 1e3 / (render_ms + step_ms)))
    aux_dir = os.path.join(tmp, "checkpoints", "laptop_aux")
    t0 = time.perf_counter()
    _, losses = tl.train(max_epoch=1, batch_size=LAPTOP_BATCH, epoch_len=LAPTOP_BATCH * steps,
                         out_dir=aux_dir, data_root=no_blender, device=device)
    train_s = time.perf_counter() - t0
    check(all(np.isfinite(losses)), "phase 14: a training loss is not finite")
    head, tail = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"phase 14 ({smi}): the segmenter trained {steps} steps at batch {LAPTOP_BATCH}, 224², "
          f"Adam 1e-3 in {train_s:.1f} s: loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of "
          f"the first 10 {head:.4f}, of the last 10 {tail:.4f}); warm ms a step "
          f"{render_ms + step_ms:.2f} = host render {render_ms:.2f} "
          f"({render_ms / LAPTOP_BATCH:.2f} a sample) + device step {step_ms:.2f}; peak device "
          f"memory of a step {peak / 2**30:.3f} GiB above its inputs", flush=True)
    check(tail < head, f"phase 14: the training loss did not fall: {head} -> {tail}")
    if profile:
        device_profile(lambda: tl.seg_train_step(model, opt, rgb, labels), "one warm segmenter "
                       "train step", top=10)

    # a fixed batch from the flax-style init: the loss must fall
    fresh = FCNResNet50()
    flax_init_(fresh, torch.Generator().manual_seed(5))
    fresh = fresh.to(device).train()
    fresh_opt = tl.make_optimizer(fresh)
    gen = torch.Generator(device=device).manual_seed(5)
    fixed = [float(tl.seg_train_step(fresh, fresh_opt, rgb, labels, gen)) for _ in range(10)]
    print(f"phase 14: 10 steps on one batch: loss {fixed[0]:.4f} -> {fixed[-1]:.4f}", flush=True)
    check(all(np.isfinite(fixed)) and fixed[-1] < fixed[0],
          f"phase 14: the loss did not fall on a fixed batch: {fixed}")
    del model, opt, fresh, fresh_opt

    # one step on the CPU against the card.  Held in float64: in float32 the
    # InstanceNorm backward of the deep layers is ill-conditioned (the torch
    # step alone is up to ~25 % of a layer's largest gradient off its float64
    # result, tests/test_torch_segmenter.py), so two float32 devices part
    # there; the float32 numbers are printed beside
    sub_rgb, sub_labels = rgb[:LAPTOP_CHECK_BATCH].cpu(), labels[:LAPTOP_CHECK_BATCH].cpu()
    for dtype in (torch.float32, torch.float64):
        dl, dg, dp, loss = _seg_step_cpu_cuda(sub_rgb, sub_labels, dtype, device)
        print(f"phase 14: cpu vs cuda, one step ({dtype}, batch {LAPTOP_CHECK_BATCH}): loss "
              f"{loss['cpu']:.6f} / {loss[device]:.6f} (rel {dl:.2e}), gradients within "
              f"{dg:.2e} of each tensor's max, parameters after the step within {dp:.2e}",
              flush=True)
        check(dl < 1e-5, f"phase 14: CPU and CUDA losses differ ({dtype})")
    check(dg < 1e-3, "phase 14: CPU and CUDA gradients differ (float64)")
    check(dp < 1e-6, "phase 14: CPU and CUDA parameters differ after a step (float64)")

    # (b) the trained segmenter's forward on the frame's crop, CPU against CUDA
    seg_dir, nocs_dir, ckpt, record, stored = unpack_nocs_frame(
        os.path.join(tmp, "frame"), LAPTOP_FRAME, aux_dir)
    k = int(stored["laptop"])
    path = os.path.join(nocs_dir, record["image_path"][5:])
    img, depth = read_png(path + "_color.png")[:, :, :3], read_png(path + "_depth.png")
    mask_idxs = np.where(record["pred_masks"][:, :, k])
    crop, idxs, _ = ni.laptop_crop(img, mask_idxs)
    segs = {dev: SegmenterRunner(aux_dir, device=dev) for dev in ("cpu", device)}
    logits = {dev: seg.logits(crop).cpu().numpy() for dev, seg in segs.items()}
    d_logit = float(np.abs(logits["cpu"] - logits[device]).max())
    scale = float(np.abs(logits["cpu"]).max())
    same = float((logits["cpu"].argmax(-1) == logits[device].argmax(-1)).mean())
    fwd_ms = cuda_ms(lambda: segs[device].logits(crop))
    print(f"phase 14 ({smi}): the trained segmenter on the frame's crop: cpu vs cuda logits "
          f"within {d_logit:.2e} (max |logit| {scale:.3f}), labels equal on {same * 100:.3f} % "
          f"of pixels; lid {int((logits[device].argmax(-1) == 1).sum())} of 224²; "
          f"{fwd_ms:.3f} ms a forward (batch 1)", flush=True)
    check(d_logit <= 1e-4 * scale, "phase 14: CPU and CUDA segmenter logits differ")
    check(same >= 0.999, "phase 14: CPU and CUDA segmenter labels differ")

    # (c) JAX's stored laptop path, from JAX's stored labels
    check(float(np.abs(crop - stored["crop"]).max()) <= 1e-6, "phase 14: laptop_crop differs "
          "from the stored crop")
    check(np.array_equal(idxs, stored["idxs_resized"]), "phase 14: the crop coordinates differ")
    runner = ni.CategoryRunner("laptop", device=device)
    pc = ni.frame_crops(depth, record, {"laptop": runner})["laptop"][0][1]
    r_inst, r_plane = (tuple(int(v) for v in stored[n]) for n in ("r_inst", "r_plane"))
    draws = runner.draws(r_inst)
    pre = runner.preprocess(pc, draws)
    n = int(pre.n_valid)
    up = ni.laptop_up_from_labels(stored["labels"].astype(np.int64), idxs,
                                  pre.pc[:n].cpu().numpy(), pre, r_plane)
    d_up = np.radians(_angle(up, stored["laptop_up"]))
    second, _ = runner.estimate(pc, draws=draws, laptop_up=stored["laptop_up"])
    dT = float(np.linalg.norm(second.T.cpu().numpy() - stored["after_T"]))
    d_pose_up = _angle(second.up.cpu().numpy(), stored["after_R"][:, 1])
    print(f"phase 14: from JAX's stored labels on the card: crop equal (1e-6), laptop_up "
          f"{d_up:.2e} rad from JAX's; the second pose T {dT * 1e3:.4f} mm, up "
          f"{d_pose_up:.4f} deg from JAX's", flush=True)
    check(d_up <= LAPTOP_UP_TOL_RAD, "phase 14: laptop_up differs from JAX's")
    check(dT <= 1e-5, "phase 14: the second pose's T is not JAX's voxel")
    check(d_pose_up <= LAPTOP_POSE_UP_TOL_DEG, "phase 14: the second pose's up differs")

    # (d) the whole driver on the frame with the trained segmenter, card and CPU
    argv = ["--seg_dir", seg_dir, "--nocs_dir", nocs_dir, "--ckpt_path", ckpt,
            "--seed", str(int(stored["seed"]))]
    names = [ni.SYNSET_NAMES[c] for c in record["pred_class_ids"]]
    res = {}
    for dev in (device, "cpu"):
        out_dir = os.path.join(tmp, f"pred_{dev}")
        torch.cuda.synchronize()
        vh.reset_launches()
        t0 = time.perf_counter()
        ni.main(argv + ["--out_dir", out_dir, "--device", dev])
        torch.cuda.synchronize()
        if dev == device:
            launches = dict(vh.LAUNCHES)
        with open(ni.result_path(out_dir, record), "rb") as f:
            res[dev] = pickle.load(f)
        print(f"phase 14: the driver on the laptop frame on {dev}: "
              f"{time.perf_counter() - t0:.2f} s (runners, weights and first calls included)",
              flush=True)
    runners = ni.load_runners(ni.build_parser().parse_args(argv + ["--device", device]))
    passes = sum(2 if runners[c].pcfg.asym_center_refine else 1 for c in names) + 1
    print(f"phase 14: driver launches {launches} ({passes} center passes: the laptop posed "
          f"twice)", flush=True)
    check(launches["bound_projections_pairs"] == passes,
          f"phase 14: bound_projections_pairs launched {launches['bound_projections_pairs']} "
          f"times, not once a center pass ({passes})")
    check(passes <= launches["refine_window_pairs"] <= 2 * passes,
          f"phase 14: refine_window_pairs launched {launches['refine_window_pairs']} times "
          f"for {passes} center passes")
    check(all(launches[x] == 0 for x in ("bound_projections", "refine_window", "dense_hist",
                                         "dense_hist_pairs")),
          "phase 14: a votes front end or dense_hist launched")
    R = {dev: r["pred_RTs"][:, :3, :3] / np.cbrt(np.linalg.det(r["pred_RTs"][:, :3, :3]))[
        :, None, None] for dev, r in res.items()}
    for i, cat in enumerate(names):
        RT = res[device]["pred_RTs"][i]
        check(not np.allclose(RT, np.eye(4)) and np.linalg.det(RT[:3, :3]) > 0,
              f"phase 14: instance {i} was not posed")
        dT = float(np.linalg.norm(RT[:3, 3] - res["cpu"]["pred_RTs"][i][:3, 3]))
        d_up = _angle(R[device][i][:, 1], R["cpu"][i][:, 1])
        gt = record["gt_RTs"][i]
        gt_up = gt[:3, 1] / np.linalg.norm(gt[:3, 1])
        print(f"  instance {i} ({cat}): cuda minus cpu T {dT * 1e3:.3f} mm, up {d_up:.3f} deg; "
              f"against GT T {np.linalg.norm(RT[:3, 3] - gt[:3, 3]) * 1e3:.1f} mm, up "
              f"{_angle(R[device][i][:, 1], gt_up, fold=cat in UP_SYMMETRIC):.2f} deg", flush=True)
        check(dT <= NOCS_T_TOL, f"phase 14: instance {i} T differs between CPU and CUDA")
        check(d_up <= NOCS_UP_TOL_DEG, f"phase 14: instance {i} up differs between CPU and CUDA")

    # the frame loop, warm, with the override and without it
    seg = segs[device]
    laptop = ni.LaptopFrame(seg, img, ni.frame_masks(record))
    seconds, laptop_ms = {}, {}
    for label, lap in (("with the override", laptop), ("without it", None)):
        runs = []
        for _ in range(LAPTOP_FRAME_REPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            groups = ni.frame_crops(depth, record, runners)
            _, _, _, chunks = ni.infer_frame(groups, len(names), runners,
                                             threefry.key(int(stored["seed"])), laptop=lap)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0,
                         next(c.seconds for c in chunks if c.category == "laptop") * 1e3))
        seconds[label] = statistics.median(r[0] for r in runs[1:])
        laptop_ms[label] = statistics.median(r[1] for r in runs[1:])
    print(f"phase 14 ({smi}): warm s/frame (median of {LAPTOP_FRAME_REPS}) " + "; ".join(
        f"{label} {seconds[label]:.3f}, the laptop instance {laptop_ms[label]:.1f} ms"
        for label in seconds), flush=True)

    # both peak kernels on the laptop instance, against the plain version
    records = kernel_phase(main_path_inputs(runner, pc, runner.pcfg.grid_shape),
                           f"laptop frame instance {k} (laptop)")
    tmp_dir.cleanup()
    return records, launches


PARALLEL_RANKS = 4            # gloo ranks sharing one card
PARALLEL_CATEGORIES = ("bowl", "mug")
DP_RANKS = 2
RANK_TIMEOUT_S = 300.0
PROBED = ("all_reduce", "all_gather", "all_gather uint8", "all_gather_into_tensor",
          "broadcast", "reduce_scatter_tensor")


def view_keys(z):
    """Each committed view's JAX key: ``jax_key_i``, or, in bowl's views,
    which were written before the keys were stored, the schedule that
    wrote them remade (scripts/export_torch_assets.py::render_views:
    PRNGKey(0), one split a view)."""
    from cppf_tpu_torch.core import threefry

    n = int(z["n_views"])
    if "jax_key_0" in z:
        return [tuple(int(v) for v in z[f"jax_key_{i}"]) for i in range(n)]
    keys, key = [], threefry.key(0)
    for _ in range(n):
        key, k = threefry.split(key)
        keys.append(k)
    return keys


def probe_collectives(device, world_size):
    """Which collectives the default group takes on tensors of ``device``:
    name → "ok" or the first line of its refusal."""
    import torch.distributed as dist

    def run(name):
        x = torch.arange(4 * world_size, dtype=torch.float32, device=device)
        part = torch.empty(4, device=device)
        if name == "all_reduce":
            dist.all_reduce(x)
        elif name in ("all_gather", "all_gather uint8"):
            src = x[:4].to(torch.uint8) if "uint8" in name else x[:4].clone()
            dist.all_gather([torch.empty_like(src) for _ in range(world_size)], src)
        elif name == "all_gather_into_tensor":
            dist.all_gather_into_tensor(x, part.fill_(1.0))
        elif name == "broadcast":
            dist.broadcast(x, 0)
        else:
            dist.reduce_scatter_tensor(part, x)
        _sync(device)

    out = {}
    for name in PROBED:
        try:
            run(name)
            out[name] = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[name] = "refused: " + (str(e).strip().splitlines() or [type(e).__name__])[0][:160]
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parallel_pose_rank(rank, world_size, device, job):
    """One rank of phase 13's pair-sharded pose: ``sharded_estimate_pose``
    of each category's views (the parent's preprocessed clouds, the views'
    JAX draws remade here) on a (1, world_size) mesh, launch counts and
    collective traffic reset just before and read just after; then the
    warm time of a pose (host clock, the ranks started together by a
    barrier).  A job's entry may name its ``category`` (default: its key)
    and pose ``flags`` set on the runner's PoseConfig (phase 16).  Returns
    the poses (on the host), the counts and the times."""
    import dataclasses

    import torch.distributed as dist

    from cppf_tpu_torch.eval.nocs_inference import CategoryRunner
    from cppf_tpu_torch.ops import vote_hist as vh
    from cppf_tpu_torch.parallel.mesh import make_mesh
    from cppf_tpu_torch.parallel.pose import sharded_estimate_pose

    mesh = make_mesh(world_size, shape=(1, world_size), device=device)
    out = {"collectives": probe_collectives(device, world_size) if job["probe"] else None}
    for cat, views in job["poses"].items():
        runner = CategoryRunner(views.get("category", cat), device=device)
        runner.pcfg = dataclasses.replace(runner.pcfg, **views.get("flags", {}))
        pres = [{k: t.to(device) for k, t in v.items()} for v in views["pre"]]
        draws = [runner.draws(k) for k in views["keys"]]

        def pose(v, d):
            return sharded_estimate_pose(mesh, runner.point_encoder, runner.ppf_encoder,
                                         v["pc"], v["normals"], v["n_valid"], runner.sphere,
                                         runner.pcfg, d, nbr_idx=v["nbr_idx"])

        _sync(device)
        dist.barrier()
        vh.reset_launches()
        mesh.traffic.clear()
        res = [pose(v, d) for v, d in zip(pres, draws)]
        _sync(device)
        launches, traffic = dict(vh.LAUNCHES), dict(mesh.traffic)
        times = []
        for _ in range(job["reps"]):
            for v, d in zip(pres, draws):
                dist.barrier()
                _sync(device)
                t0 = time.perf_counter()
                pose(v, d)
                _sync(device)
                times.append((time.perf_counter() - t0) * 1e3)
        out[cat] = dict(poses=[{k: t.cpu() for k, t in r._asdict().items()} for r in res],
                        launches=launches, traffic=traffic,
                        ms=statistics.median(times) if times else None)
        del draws
    return out


def dp_rank(rank, world_size, device, job):
    """One rank of phase 13's data-parallel step (and phase 17's
    pair-sharded one: ``job["shape"]``, default (world_size, 1)): the
    flax-style init from ``cfg.seed``, one ``data_parallel_train_step`` on
    the rank's share of the parent's batch (collective traffic counted),
    then the warm time of a step (median of 3, the ranks started together by
    a barrier)."""
    import torch.distributed as dist

    from cppf_tpu_torch.device import pin_float32
    from cppf_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from cppf_tpu_torch.parallel.train_step import data_parallel_train_step
    from cppf_tpu_torch.train import step

    pin_float32()
    mesh = make_mesh(world_size, shape=job.get("shape", (world_size, 1)), device=device)
    cfg = job["cfg"]
    statics = step.TrainStatics.from_config(cfg)
    state = step.init_train_state(cfg, device)
    params = state.opt.param_groups[0]["params"]
    init = [p.detach().cpu().clone() for p in params]
    local = shard_batch(job["batch"].to(device), mesh)
    comps = data_parallel_train_step(state, local, statics, mesh)
    out = dict(comps={k: float(v) for k, v in comps.items()}, init=init,
               grads=[p.grad.cpu() for p in params], weights=[p.detach().cpu() for p in params],
               traffic=dict(mesh.traffic), samples=local.pc.shape[0])
    times = []
    for _ in range(3):
        dist.barrier()
        _sync(device)
        t0 = time.perf_counter()
        data_parallel_train_step(state, local, statics, mesh)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    out["ms"] = statistics.median(times)
    return out


def _dense_value_ok(runner, pre, draws, held, other=None):
    """Whether each center of ``held`` holds a maximum, within KERNEL_RTOL,
    of the port's dense center-vote grid (ROADMAP port rule 5): the pose's
    own pairs, gated and weighted as its center pass gates and weights them
    (``center_vote_masks``).  ``other``, a center that need not, is shown
    beside them."""
    from cppf_tpu_torch.ops.voting import ppf_vote_dense
    from cppf_tpu_torch.pipeline.pose import (center_vote_masks, decode_translation, grid_frame,
                                              pair_predictions)

    pcfg = runner.pcfg
    with torch.no_grad():
        idxs, preds = pair_predictions(runner.point_encoder, runner.ppf_encoder, pre.pc,
                                       pre.normals, pre.n_valid, pcfg, draws.pair_u, pre.nbr_idx)
        preds_tr = decode_translation(preds, draws.tr_gumbel, pcfg)
        corner, dims = grid_frame(pre.pc, pre.valid_mask, pcfg)
        mask, _, hs = center_vote_masks(pre.pc, pre.normals, idxs, pcfg)
        grid = ppf_vote_dense(pre.pc, preds_tr, torch.ones(pre.pc.shape[0], device=pre.pc.device),
                              idxs, corner, pcfg.res, dims, pcfg.grid_shape, n_rots=pcfg.num_rots,
                              pair_mask=mask, halfspace=hs)
    top = float(grid.max())
    vals = []
    for t in list(held) + ([] if other is None else [other]):
        ijk = torch.round((torch.as_tensor(t, device=corner.device) - corner) / pcfg.res).long()
        vals.append(float(grid[tuple(torch.clamp(ijk, min=0, max=pcfg.grid_shape[0] - 1))]))
    print(f"    centers {[torch.as_tensor(t).tolist() for t in held]} hold {vals[:len(held)]} "
          f"votes" + ("" if other is None else f", {other.tolist()} {vals[-1]:.6f}")
          + f"; the grid's maximum {top:.6f}", flush=True)
    return min(vals[:len(held)]) >= top * (1 - KERNEL_RTOL)


def hold_sharded(cat, ranks, refs, runner, z, world_size, backend):
    """Phase 13's checks of one category's sharded poses against the
    one-rank poses and the stored JAX estimates; returns each rank's
    launches."""
    passes = 2 if runner.pcfg.asym_center_refine else 1
    n = len(refs["outs"])
    for r, ro in enumerate(ranks):
        for i in range(n):
            for k, v in ro[cat]["poses"][i].items():
                check(torch.equal(v, ranks[0][cat]["poses"][i][k]),
                      f"{backend} {cat} view {i}: rank {r}'s {k} differs from rank 0's")
        lr = ro[cat]["launches"]
        check(lr["bound_projections_pairs"] == passes * n
              and passes * n <= lr["refine_window_pairs"] <= 2 * passes * n
              and lr["bound_projections"] == lr["refine_window"] == 0
              and lr["dense_hist"] == lr["dense_hist_pairs"] == 0,
              f"{backend} {cat}: rank {r} launched {lr}, not {passes} bound pass(es) and 1-2 "
              f"windows a center pass")
    d_jax_T, d_jax_up = [], []
    for i in range(n):
        got, want = ranks[0][cat]["poses"][i], refs["outs"][i]
        same_T = torch.equal(got["T"], want.T.cpu())
        if not same_T:
            check(passes == 1 and _dense_value_ok(runner, refs["pres"][i], refs["draws"][i],
                                                  [got["T"]], want.T),
                  f"{backend} {cat} view {i}: sharded T {got['T'].tolist()} is neither the "
                  f"one-rank {want.T.tolist()} nor a maximum of its grid")
        d = {k: float((got[k] - getattr(want, k).cpu()).abs().max()) for k in ("T", "up", "right")}
        d_scale = float(((got["scale"] - want.scale.cpu()) / want.scale.cpu()).abs().max())
        print(f"  {backend} x{world_size} {cat} view {i}: |dT| {d['T']:.2e}, |d up| "
              f"{d['up']:.2e}, |d right| {d['right']:.2e}, scale rel {d_scale:.2e}, survivors "
              f"{int(got['n_filtered'])} / {int(want.n_filtered)} (one rank)", flush=True)
        if same_T:
            check(d["up"] <= 1e-6 and d["right"] <= 1e-6,
                  f"{backend} {cat} view {i}: axes differ from the one-rank pose: {d}")
        check(d_scale <= 1e-5, f"{backend} {cat} view {i}: scale differs by {d_scale:.2e}")
        check(int(got["n_filtered"]) == int(want.n_filtered),
              f"{backend} {cat} view {i}: back-vote survivors differ")
        d_jax_T.append(float(np.linalg.norm(got["T"].numpy() - z[f"jax_T_{i}"])))
        d_jax_up.append(_angle(got["up"].numpy(), z[f"jax_up_{i}"]))
    t_med, up_med = _median(d_jax_T), _median(d_jax_up)
    print(f"  {backend} x{world_size} {cat}: sharded minus stored JAX estimate, median T "
          f"{t_med * 1e3:.3f} mm, up {up_med:.3f} deg", flush=True)
    check(t_med < 0.02 and up_med < 15.0,
          f"{backend} {cat}: sharded pose {t_med * 1e3:.1f} mm / {up_med:.1f} deg from JAX's")
    return [ro[cat]["launches"] for ro in ranks]


def parallel_phase(smi):
    """Phase 13 (see the docstring).  Returns (both peak kernels' records on
    rank 0's shard, rank 0's launches on bowl, every rank's launches by
    category)."""
    import tempfile

    from cppf_tpu_torch.core import threefry
    from cppf_tpu_torch.data.shapenet import ShapeNetRenderDataset
    from cppf_tpu_torch.eval.nocs_inference import CategoryRunner
    from cppf_tpu_torch.models.convert import ASSETS
    from cppf_tpu_torch.parallel.launch import run_ranks
    from cppf_tpu_torch.parallel.mesh import PairMesh, shard_rows
    from cppf_tpu_torch.pipeline.pose import estimate_pose
    from cppf_tpu_torch.train import loop, step

    # one-rank poses of every view on its JAX draws, and their warm time
    # from the preprocessed cloud
    runners, refs, jobs, views = {}, {}, {}, {}
    for cat in PARALLEL_CATEGORIES:
        runner = runners[cat] = CategoryRunner(cat)
        pcfg = runner.pcfg
        check(pcfg.n_pairs == 100000 and pcfg.num_rots == 72 and pcfg.knn == 60
              and runner.cfg.npoint_pad == 4096, f"phase 13 {cat}: not full width: {pcfg}")
        z = views[cat] = np.load(os.path.join(ASSETS, f"{cat}_views.npz"))
        keys = view_keys(z)
        draws = [runner.draws(k) for k in keys]
        outs, pres = zip(*(runner.estimate(z[f"pc_{i}"], draws=d) for i, d in enumerate(draws)))
        times = []
        for _ in range(3):
            for pre, d in zip(pres, draws):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                estimate_pose(runner.point_encoder, runner.ppf_encoder, pre.pc, pre.normals,
                              pre.n_valid, runner.sphere, pcfg, nbr_idx=pre.nbr_idx, draws=d)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        refs[cat] = dict(outs=outs, pres=pres, draws=draws, ms=statistics.median(times))
        jobs[cat] = dict(keys=keys, pre=[dict(pc=p.pc.cpu(), normals=p.normals.cpu(),
                                              n_valid=p.n_valid.cpu(), nbr_idx=p.nbr_idx.cpu())
                                         for p in pres])
    all_launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) 4 gloo ranks on one card
        work = os.path.join(tmp, "gloo")
        os.makedirs(work)
        t0 = time.perf_counter()
        gloo = run_ranks(parallel_pose_rank, "gloo", ["cuda:0"] * PARALLEL_RANKS,
                         dict(poses=jobs, probe=True, reps=3), work, RANK_TIMEOUT_S)
        print(f"phase 13 ({smi}): gloo, {PARALLEL_RANKS} ranks on one card, "
              f"{time.perf_counter() - t0:.1f} s; collectives gloo takes on CUDA tensors: "
              f"{json.dumps(gloo[0]['collectives'])}", flush=True)
        for cat in PARALLEL_CATEGORIES:
            n = len(refs[cat]["outs"])
            all_launches[cat] = hold_sharded(cat, gloo, refs[cat], runners[cat], views[cat],
                                             PARALLEL_RANKS, "gloo")
            per_pose = {k: v / n for k, v in gloo[0][cat]["traffic"].items()}
            print(f"phase 13 ({smi}): {cat} pair-sharded over {PARALLEL_RANKS} gloo ranks of "
                  f"one card (one-card gloo: says nothing of NCCL across cards), warm "
                  f"{gloo[0][cat]['ms']:.2f} ms/pose (rank 0's host clock) against one rank's "
                  f"{refs[cat]['ms']:.2f} ms/pose; a pose's collectives on each rank: "
                  f"{json.dumps(per_pose)}; launches a rank over {n} poses: "
                  f"{json.dumps(all_launches[cat])}", flush=True)

        # (b) NCCL, one rank a card
        n_cards = torch.cuda.device_count()
        work = os.path.join(tmp, "nccl")
        os.makedirs(work)
        t0 = time.perf_counter()
        bowl1 = dict(keys=jobs["bowl"]["keys"][:1], pre=jobs["bowl"]["pre"][:1])
        nccl = run_ranks(parallel_pose_rank, "nccl", [f"cuda:{r}" for r in range(n_cards)],
                         dict(poses={"bowl": bowl1}, probe=False, reps=3), work, RANK_TIMEOUT_S)
        ref1 = dict(refs["bowl"], outs=refs["bowl"]["outs"][:1], pres=refs["bowl"]["pres"][:1],
                    draws=refs["bowl"]["draws"][:1])
        hold_sharded("bowl", nccl, ref1, runners["bowl"], views["bowl"], n_cards, "nccl")
        print(f"phase 13 ({smi}): NCCL, {n_cards} rank(s), one a card, bowl view 0: warm "
              f"{nccl[0]['bowl']['ms']:.2f} ms/pose (one rank: {refs['bowl']['ms']:.2f}); "
              f"collectives a pose: {json.dumps(nccl[0]['bowl']['traffic'])}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        # (c) the data-parallel step: 2 gloo ranks on one card against one rank
        cfg = _train_config()
        ds = ShapeNetRenderDataset(cfg, seed=2)
        samples = [ds.sample() for _ in range(cfg.batch_size)]
        draws = loop.BatchDraws.from_jax_key(threefry.key(11), cfg.batch_size, cfg, "cuda")
        batch = loop.build_batch(cfg, draws, samples, cfg.npoint_pad, "cuda")
        statics = step.TrainStatics.from_config(cfg)
        single = step.init_train_state(cfg, "cuda")
        ps = single.opt.param_groups[0]["params"]
        single.opt.zero_grad()
        loss, _ = step.loss_fn(single, batch, statics)
        loss.backward()
        grads = [p.grad.cpu() for p in ps]
        single.opt.step()
        weights = [p.detach().cpu() for p in ps]
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step.train_step(single, batch, statics)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        work = os.path.join(tmp, "dp")
        os.makedirs(work)
        t0 = time.perf_counter()
        dp = run_ranks(dp_rank, "gloo", ["cuda:0"] * DP_RANKS,
                       dict(cfg=cfg, batch=batch.to("cpu")), work, RANK_TIMEOUT_S)
        dp_s = time.perf_counter() - t0
    for r in dp[1:]:
        check(all(torch.equal(a, b) for a, b in zip(r["init"], dp[0]["init"])),
              "data-parallel ranks start from different weights")
        check(all(torch.equal(a, b) for a, b in zip(r["weights"], dp[0]["weights"])),
              "data-parallel ranks hold different weights after the step")
    dl = abs(dp[0]["comps"]["loss"] - loss.item()) / abs(loss.item())
    dg = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
             for a, b in zip(dp[0]["grads"], grads))
    dw = max(float((a - b).abs().max()) for a, b in zip(dp[0]["weights"], weights))
    print(f"phase 13 ({smi}): data-parallel step, {DP_RANKS} gloo ranks of one card, "
          f"{dp[0]['samples']} sample(s) of {cfg.train_pairs} pairs a rank, against one rank on "
          f"the batch of {cfg.batch_size}: loss {dp[0]['comps']['loss']:.6f} / {loss.item():.6f} "
          f"(rel {dl:.2e}), gradients within {dg:.2e} of each tensor's maximum, weights after "
          f"the step within {dw:.2e}; warm {dp[0]['ms']:.2f} ms a step (rank 0; one-card gloo) "
          f"against one rank's {statistics.median(times):.2f}; collectives a step "
          f"{json.dumps(dp[0]['traffic'])} ({sum(p.numel() for p in ps)} parameters); "
          f"{dp_s:.1f} s", flush=True)
    check(dl < 1e-5, "data-parallel loss differs from one rank's")
    check(dg < 1e-4, "data-parallel gradients differ from one rank's")
    check(dw < 1e-6, "data-parallel weights differ from one rank's after the step")

    # both peak kernels on rank 0's shard of bowl's first view
    runner = runners["bowl"]
    p = runner.pcfg.n_pairs
    rows = shard_rows(p, PairMesh(0, (1, PARALLEL_RANKS), (0, 0), torch.device("cuda"), None,
                                  None))
    records = kernel_phase(main_path_inputs(runner, views["bowl"]["pc_0"],
                                            runner.pcfg.grid_shape, rows=rows),
                           f"bowl 64^3, rank 0's {rows.stop - rows.start} of {p} pairs")
    return records, all_launches["bowl"][0], all_launches


# ---- phase 16: the pose flags no config turns on; phase 17: entry points ----
_SOFA_SET = {"coplanar_halfspace": True, "pair_sep_power": 2.0, "pair_balance": 1.0,
             "subvoxel_refine": True}
_MUG_SET = {"sharp_axis_votes": True, "aux_align_weight": True, "subvoxel_refine": True}
# (name, category, flags, views): each setting alone on view 0, two sets on
# all four; scripts/export_torch_assets.py --flags stores JAX's estimates of
# each in assets/flag_views.npz
FLAG_CELLS = (
    ("halfspace", "sofa", {"coplanar_halfspace": True}, (0,)),
    ("balance", "sofa", {"pair_balance": 1.0}, (0,)),
    ("sep", "sofa", {"pair_sep_power": 2.0}, (0,)),
    ("grid_halfspace", "sofa", {"center_mode": "grid", "coplanar_halfspace": True}, (0,)),
    ("sharp", "mug", {"sharp_axis_votes": True}, (0,)),
    ("align", "mug", {"aux_align_weight": True}, (0,)),
    ("subvoxel", "bowl", {"subvoxel_refine": True}, (0,)),
    ("grid", "bowl", {"center_mode": "grid"}, (0,)),
    ("sofa_set", "sofa", _SOFA_SET, (0, 1, 2, 3)),
    ("mug_set", "mug", _MUG_SET, (0, 1, 2, 3)),
)


FLAG_CPU_PAIRS = 20_000       # phase 16 (c): phase 9's CPU = CUDA width
# phase 16: an axis on the same back-vote survivor count as JAX's pose is
# JAX's sphere point (1.5° apart); the right axis's orthonormalisation
# leaves ~0.02°.  With other survivors (float rounding upstream of the
# vote, amplified by the subsample's CDF: ROADMAP §C) an axis may part, but
# only as a near tie: on the port's own sphere counts, JAX's direction
# holds at least 1 - AXIS_TIE_FRAC of the winner's votes.  The largest
# shortfall recorded on such a part is 3.9 % (sofa view 2's right axis,
# 920 of 957, when the stratified sample's CDF was rounded otherwise)
AXIS_TOL_DEG = 0.1
AXIS_TIE_FRAC = 0.05
# a sub-voxel center against JAX's, in voxels: on equal survivors the
# Gauss-Newton steps differ only by the order of their sums (the port's in
# float64, JAX's in float32), 6.5e-6 m at most on the CPU at full width
# (mug, 4 mm voxels); a hundredth of a voxel is far below a refine's step
# off the voxel centre, so a skipped refine cannot pass
SUBVOXEL_T_TOL = 0.01
SHARDED_FLAG_CELLS = ("sofa_set", "mug_set")


def flag_launches_ok(pcfg, launches, n_poses=1):
    """Whether ``launches`` are those of ``n_poses`` poses at ``pcfg``: a
    center pass launches, under ``coplanar_halfspace``, the votes front end
    of ``bound_projections`` once and of ``refine_window`` 1 to
    ``peak_rounds`` times (``center_mode`` hier) or of ``dense_hist`` once
    (grid); without the gate the pairs front ends likewise; nothing else of
    ``vote_hist.cu``."""
    n = (2 if pcfg.asym_center_refine else 1) * n_poses
    gated = pcfg.coplanar_halfspace
    launches = {k: v for k, v in launches.items() if k != "sphere_count"}
    if pcfg.center_mode == "grid":
        want = {"dense_hist" if gated else "dense_hist_pairs": n}
        return all(launches[k] == want.get(k, 0) for k in launches)
    bound, window = (("bound_projections", "refine_window") if gated else
                     ("bound_projections_pairs", "refine_window_pairs"))
    return (launches[bound] == n and n <= launches[window] <= pcfg.peak_rounds * n
            and sum(launches.values()) == launches[bound] + launches[window])


def axis_margins(runner, pc_raw, draws, want_axes):
    """The margins of a parted axis (ROADMAP §C): the pose run again with its
    sphere counts captured (``rot_vote_sphere_count``'s calls: up, then
    right), and for each axis of ``want_axes`` (JAX's up and right, or None)
    the counts at the port's winning sphere direction and at JAX's."""
    return sphere_margins(lambda: runner.estimate(pc_raw, draws=draws), runner.sphere,
                          want_axes)


def sphere_margins(pose_fn, sphere, want_axes):
    """:func:`axis_margins` of the pose that ``pose_fn()`` makes on the axis
    sphere ``sphere``."""
    from cppf_tpu_torch.pipeline import pose as pose_mod

    real, counts = pose_mod.rot_vote_sphere_count, []

    def capture(*args, **kwargs):
        counts.append(real(*args, **kwargs))
        return counts[-1]

    pose_mod.rot_vote_sphere_count = capture
    try:
        pose_fn()
    finally:
        pose_mod.rot_vote_sphere_count = real
    sphere = sphere.cpu().numpy()
    out = []
    for c, want in zip(counts, want_axes):
        if want is None:
            continue
        c = c.cpu().numpy()
        j = int(np.argmax(np.abs(sphere @ want)))
        out.append((float(c.max()), float(c[j])))
    return out


def _hold_flag_axes(what, runner, pc_raw, draws, n_filtered, stored, name, i, up_d, right_d):
    """Phase 16's rule for the axes of one flagged pose, ``up_d`` and
    ``right_d`` degrees from JAX's stored ``<name>_up_<i>`` / ``_right_``:
    within AXIS_TOL_DEG; else only on another back-vote survivor count than
    JAX's, and only as a near tie on the port's sphere counts."""
    if up_d <= AXIS_TOL_DEG and (right_d or 0.0) <= AXIS_TOL_DEG:
        return
    check(n_filtered != int(stored[f"{name}_n_filtered_{i}"]),
          f"{what}: the axes part from JAX's on the same back-vote survivor count")
    jr = stored[f"{name}_right_{i}"] if runner.cfg.regress_right else None
    margins = axis_margins(runner, pc_raw, draws, (stored[f"{name}_up_{i}"], jr))
    print(f"    parted axes: up {up_d:.3f} deg, right {right_d} deg from JAX's, the survivors "
          f"differing; the port's sphere counts at its winner and at JAX's (up, right): "
          f"{margins}", flush=True)
    for (top, at_jax), deg in zip(margins, (up_d, right_d)):
        check(deg <= AXIS_TOL_DEG or at_jax >= (1 - AXIS_TIE_FRAC) * top,
              f"{what}: a parted axis is no near tie: JAX's direction holds {at_jax} of the "
              f"winner's {top} votes")


def gated_kernel_records(inp, label):
    """Phase 16: the votes front ends of the three kernels on the votes of a
    gated center pass (``main_path_inputs(..., halfspace=True)``), held and
    timed as phases 3 and 6 hold and time them (``kernel_phase``,
    ``dense_record``).  Returns their records for the kernels line, marked
    as votes front ends."""
    recs = kernel_phase(inp, label, pairs=False)
    recs["dense_hist"] = dense_record(None, None, inp["grid_shape"], (1, 1, 1), label,
                                      n_rots=inp["n_rots"], votes=inp["votes"])
    return {name: dict(front="votes", library_ms=rec["library_ms"],
                       **{k[len("votes_"):]: v for k, v in rec.items() if k.startswith("votes_")})
            for name, rec in recs.items()}


def flags_phase(smi):
    """Phase 16 (see the docstring).  Returns (the votes front ends'
    records on sofa's gated votes, the launches of (a)'s poses)."""
    import dataclasses
    import tempfile

    from cppf_tpu_torch.eval.nocs_inference import CategoryRunner
    from cppf_tpu_torch.models.convert import ASSETS
    from cppf_tpu_torch.ops import vote_hist as vh
    from cppf_tpu_torch.parallel.launch import run_ranks
    from cppf_tpu_torch.pipeline.pose import PoseDraws, grid_frame

    stored = np.load(os.path.join(ASSETS, "flag_views.npz"))
    runners, views, refs, errors_by_cat, refined = {}, {}, {}, {}, []
    totals = {k: 0 for k in vh.LAUNCHES}
    for name, cat, flags, idx in FLAG_CELLS:
        if cat not in runners:
            runners[cat] = CategoryRunner(cat)
            views[cat] = np.load(os.path.join(ASSETS, f"{cat}_views.npz"))
        runner, z = runners[cat], views[cat]
        keys = view_keys(z)
        base = runner.pcfg
        g = runner.cfg.resolved_grid_edge()
        check(base.n_pairs == 100000 and base.num_rots == 72 and base.grid_shape == (g, g, g),
              f"phase 16 {cat}: not full width: {base}")
        runner.pcfg = pcfg = dataclasses.replace(base, **flags)
        try:
            outs, pres, draws, rows = [], [], [], []
            for i in idx:
                d = runner.draws(keys[i])
                torch.cuda.synchronize()
                vh.reset_launches()
                out, pre = runner.estimate(z[f"pc_{i}"], draws=d)
                torch.cuda.synchronize()
                launches = dict(vh.LAUNCHES)
                for k in totals:
                    totals[k] += launches[k]
                check(flag_launches_ok(pcfg, launches),
                      f"phase 16 {name} view {i}: launched {launches}")
                T = out.T.cpu().numpy()
                T_j = stored[f"{name}_T_{i}"]
                dT = float(np.abs(T - T_j).max())
                tol = SUBVOXEL_T_TOL * pcfg.res if pcfg.subvoxel_refine else 1e-5
                up_d = _angle(out.up.cpu().numpy(), stored[f"{name}_up_{i}"])
                right_d = (_angle(out.right.cpu().numpy(), stored[f"{name}_right_{i}"])
                           if runner.cfg.regress_right else None)
                e = category_errors(T, out.up.cpu().numpy(), out.right.cpu().numpy(),
                                    out.scale.cpu().numpy(), z, i, runner.cfg)
                je = category_errors(T_j, stored[f"{name}_up_{i}"],
                                     stored[f"{name}_right_{i}"] if runner.cfg.regress_right
                                     else None, stored[f"{name}_scale_{i}"], z, i, runner.cfg)
                print(f"  phase 16 {name} ({cat}) view {i}: port minus JAX: T {dT * 1e3:.4f} mm "
                      f"(tolerance {tol * 1e3:.4f}), up {up_d:.4f} deg, right "
                      f"{right_d if right_d is None else round(right_d, 4)} deg, survivors "
                      f"{int(out.n_filtered)} / {int(stored[f'{name}_n_filtered_{i}'])}; "
                      f"against GT: port T {e[0] * 1e3:.2f} mm up {e[1]:.2f} deg, JAX T "
                      f"{je[0] * 1e3:.2f} mm up {je[1]:.2f} deg; launches "
                      f"{ {k: v for k, v in launches.items() if v} }", flush=True)
                _hold_flag_axes(f"phase 16 {name} view {i}", runner, z[f"pc_{i}"], d,
                                int(out.n_filtered), stored, name, i, up_d, right_d)
                if pcfg.subvoxel_refine:
                    # off the voxel lattice of the center vote: a refined T
                    corner = grid_frame(pre.pc, pre.valid_mask, pcfg)[0].double().cpu().numpy()
                    off, off_j = (float(np.abs(t - corner - np.round((t - corner) / pcfg.res)
                                               * pcfg.res).max()) for t in (T, T_j))
                    print(f"    sub-voxel T off its voxel centre: port {off * 1e3:.4f} mm, JAX "
                          f"{off_j * 1e3:.4f} mm", flush=True)
                    check(dT <= tol, f"phase 16 {name} view {i}: sub-voxel T {T.tolist()} is "
                          f"{dT} m from JAX's {T_j.tolist()}")
                    check(off_j <= 2 * tol or off > tol, f"phase 16 {name} view {i}: T sits on "
                          f"a voxel centre where JAX's refined T left it")
                    refined.append(off_j > 2 * tol)
                elif dT > tol:
                    check(_dense_value_ok(runner, pre, d, [out.T, T_j]),
                          f"phase 16 {name} view {i}: T {T.tolist()} is not JAX's {T_j.tolist()}")
                outs.append(out), pres.append(pre), draws.append(d), rows.append((e, je))
            errors_by_cat.setdefault(cat, []).extend(rows)
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runner.estimate(z[f"pc_{idx[0]}"], draws=draws[0])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            print(f"phase 16 ({smi}) {name} ({cat}, {flags}): warm "
                  f"{statistics.median(times):.2f} ms/pose (view {idx[0]}, median of 3)",
                  flush=True)
            refs[name] = dict(outs=outs, pres=pres, keys=[keys[i] for i in idx])
            del draws
        finally:
            runner.pcfg = base
    print(f"phase 16: launches of (a) and (b)'s poses: {totals}", flush=True)
    check(any(refined), "phase 16: no sub-voxel pose of JAX's left its voxel centre")
    for cat, rows in errors_by_cat.items():
        med = [_median([r[0][k] for r in rows]) for k in range(3)]
        jmed = [_median([r[1][k] for r in rows]) for k in range(3)]
        print(f"phase 16 {cat}: {len(rows)} flagged poses, median T / up / right error "
              f"against GT {med}, JAX's {jmed}", flush=True)
        # phase 8's rule
        check(med[0] <= 2 * jmed[0] + 5 * runners[cat].cfg.res,
              f"phase 16 {cat}: median T error {med[0] * 1e3:.1f} mm > twice JAX's "
              f"{jmed[0] * 1e3:.1f} mm + 5 voxels")
        for k, axis in ((1, "up"), (2, "right")):
            check(np.isnan(jmed[k]) or med[k] <= jmed[k] + 15.0,
                  f"phase 16 {cat}: median {axis} error {med[k]:.1f} deg > JAX's "
                  f"{jmed[k]:.1f} + 15 deg")

    # the votes front ends on sofa's gated votes
    sofa = runners["sofa"]
    base = sofa.pcfg
    sofa.pcfg = dataclasses.replace(base, coplanar_halfspace=True)
    try:
        inp = main_path_inputs(sofa, views["sofa"]["pc_0"], base.grid_shape, halfspace=True)
    finally:
        sofa.pcfg = base
    records = gated_kernel_records(inp, f"sofa {base.grid_shape[0]}^3, half-space gate")
    del inp

    # CPU = CUDA on identical draws at FLAG_CPU_PAIRS pairs
    cpus = {}
    for name, cat, flags, idx in FLAG_CELLS:
        runner, z = runners[cat], views[cat]
        cpu = cpus.setdefault(cat, CategoryRunner(cat, device="cpu"))
        base = runner.pcfg
        pcfg = dataclasses.replace(base, n_pairs=FLAG_CPU_PAIRS, **flags)
        cpu.pcfg = runner.pcfg = pcfg
        try:
            d = PoseDraws.sample(pcfg, torch.Generator().manual_seed(16), "cpu",
                                 n_raw=runner.cfg.npoint_max)
            out_cpu = cpu.estimate(z["pc_1"], draws=d)[0]
            out_gpu = runner.estimate(z["pc_1"], draws=d.to("cuda"))[0]
        finally:
            runner.pcfg = base
        diff = {k: float((getattr(out_cpu, k) - getattr(out_gpu, k).cpu()).abs().max())
                for k in ("T", "up", "right")}
        print(f"phase 16 cpu vs cuda, {name} ({cat}), {FLAG_CPU_PAIRS} pairs, identical draws: "
              f"{diff}, survivors {int(out_cpu.n_filtered)} vs {int(out_gpu.n_filtered)}",
              flush=True)
        check(diff["T"] <= (1e-5 if pcfg.subvoxel_refine else 1e-6)
              and max(diff["up"], diff["right"]) <= 1e-6,
              f"phase 16 {name}: CPU and CUDA poses differ: {diff}")

    # the two sets over 4 gloo ranks of the card against the one-rank poses
    jobs = {}
    for name, cat, flags, idx in FLAG_CELLS:
        if name in SHARDED_FLAG_CELLS:
            jobs[name] = dict(category=cat, flags=flags, keys=refs[name]["keys"],
                              pre=[dict(pc=p.pc.cpu(), normals=p.normals.cpu(),
                                        n_valid=p.n_valid.cpu(), nbr_idx=p.nbr_idx.cpu())
                                   for p in refs[name]["pres"]])
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        ranks = run_ranks(parallel_pose_rank, "gloo", ["cuda:0"] * PARALLEL_RANKS,
                          dict(poses=jobs, probe=False, reps=0), work, RANK_TIMEOUT_S)
    for name, cat, flags, idx in FLAG_CELLS:
        if name not in jobs:
            continue
        pcfg = dataclasses.replace(runners[cat].pcfg, **flags)
        for r, ro in enumerate(ranks):
            check(flag_launches_ok(pcfg, ro[name]["launches"], len(idx)),
                  f"phase 16 {name}: rank {r} launched {ro[name]['launches']}")
            for i in range(len(idx)):
                for k, v in ro[name]["poses"][i].items():
                    check(torch.equal(v, ranks[0][name]["poses"][i][k]),
                          f"phase 16 {name} view {i}: rank {r}'s {k} differs from rank 0's")
        for i, want in enumerate(refs[name]["outs"]):
            got = ranks[0][name]["poses"][i]
            d = {k: float((got[k] - getattr(want, k).cpu()).abs().max())
                 for k in ("T", "up", "right")}
            print(f"  phase 16 {name} view {i}, {PARALLEL_RANKS} gloo ranks against one: {d}, "
                  f"survivors {int(got['n_filtered'])} / {int(want.n_filtered)}", flush=True)
            check(max(d.values()) <= 1e-6 and int(got["n_filtered"]) == int(want.n_filtered),
                  f"phase 16 {name} view {i}: the sharded pose differs from one rank's: {d}")
    print(f"phase 16 ({smi}): both sets over {PARALLEL_RANKS} gloo ranks of one card equal the "
          f"one-rank poses; launches a rank "
          f"{json.dumps({n: ranks[0][n]['launches'] for n in jobs})}"
          f"; {time.perf_counter() - t0:.1f} s", flush=True)
    return records, totals


def entry_phase(smi):
    """Phase 17 (see the docstring)."""
    import tempfile

    from cppf_tpu_torch import entry as entry_t
    from cppf_tpu_torch.data.shapenet import ShapeNetRenderDataset
    from cppf_tpu_torch.core import threefry
    from cppf_tpu_torch.ops import vote_hist as vh
    from cppf_tpu_torch.parallel.launch import run_ranks
    from cppf_tpu_torch.train import loop, step

    fn, args = entry_t.entry()
    fn(*args)
    torch.cuda.synchronize()
    vh.reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    launches = dict(vh.LAUNCHES)
    check(all(bool(torch.isfinite(v.float()).all()) for v in out),
          "phase 17: entry() gave a non-finite pose")
    check(launches["bound_projections_pairs"] == 1 and 1 <= launches["refine_window_pairs"] <= 2
          and sum(launches.values()) == launches["bound_projections_pairs"]
          + launches["refine_window_pairs"] + launches["sphere_count"],
          f"phase 17: entry() launched {launches}")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"phase 17 ({smi}): entry() on the card: T {out.T.tolist()}, survivors "
          f"{int(out.n_filtered)}, launches {launches}; warm {statistics.median(times):.2f} ms "
          f"(median of 3)", flush=True)

    # dryrun_multichip(4): a (2, 2) mesh of gloo ranks on the card
    t0 = time.perf_counter()
    ranks = entry_t.dryrun_multichip(4, backend="gloo", devices=["cuda:0"] * 4)
    dry_s = time.perf_counter() - t0
    cfg = entry_t.dryrun_config()
    batch = entry_t.dryrun_batch(cfg, 2, 2).to("cuda")
    single = step.init_train_state(cfg, "cuda")
    comps = step.train_step(single, batch, step.TrainStatics.from_config(cfg))
    ps = single.opt.param_groups[0]["params"]
    _hold_step(ranks, float(comps["loss"]), [p.grad.cpu() for p in ps],
               [p.detach().cpu() for p in ps], "phase 17 dryrun_multichip(4)")
    print(f"phase 17 ({smi}): dryrun_multichip(4), mesh {ranks[0]['mesh']} of gloo ranks on one "
          f"card, equals one rank's step on the whole batch; the sharded pose T "
          f"{ranks[0]['pose']['T'].tolist()}; {dry_s:.1f} s", flush=True)

    # the pair-sharded step at bowl's training width on a (2, 2) mesh
    cfg = _train_config()
    ds = ShapeNetRenderDataset(cfg, seed=2)
    samples = [ds.sample() for _ in range(cfg.batch_size)]
    draws = loop.BatchDraws.from_jax_key(threefry.key(17), cfg.batch_size, cfg, "cuda")
    batch = loop.build_batch(cfg, draws, samples, cfg.npoint_pad, "cuda")
    statics = step.TrainStatics.from_config(cfg)
    single = step.init_train_state(cfg, "cuda")
    ps = single.opt.param_groups[0]["params"]
    single.opt.zero_grad()
    loss, _ = step.loss_fn(single, batch, statics)
    loss.backward()
    grads = [p.grad.cpu() for p in ps]
    single.opt.step()
    weights = [p.detach().cpu() for p in ps]
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step.train_step(single, batch, statics)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        pair = run_ranks(dp_rank, "gloo", ["cuda:0"] * 4,
                         dict(cfg=cfg, batch=batch.to("cpu"), shape=(2, 2)), work, RANK_TIMEOUT_S)
        pair_s = time.perf_counter() - t0
    _hold_step(pair, loss.item(), grads, weights, "phase 17 pair-sharded step")
    print(f"phase 17 ({smi}): pair-sharded step on a (2, 2) mesh of gloo ranks on one card "
          f"({pair[0]['samples']} sample a rank, {cfg.train_pairs // 2} of its "
          f"{cfg.train_pairs} pairs), equal to one rank's on the batch of {cfg.batch_size}; warm "
          f"{pair[0]['ms']:.2f} ms a step (rank 0; one-card gloo) against one rank's "
          f"{statistics.median(times):.2f}; collectives a step {json.dumps(pair[0]['traffic'])}; "
          f"{pair_s:.1f} s", flush=True)
    return launches


def _hold_step(ranks, loss, grads, weights, what):
    """Every rank's step equal to rank 0's weights, and rank 0's to the
    one-rank step: loss 1e-5 relative, gradients 1e-4 of each tensor's
    maximum, weights 1e-6."""
    for r in ranks[1:]:
        check(all(torch.equal(a, b) for a, b in zip(r["weights"], ranks[0]["weights"])),
              f"{what}: ranks hold different weights after the step")
    got = ranks[0]
    dl = abs(float(got["comps"]["loss"]) - loss) / abs(loss)
    dg = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
             for a, b in zip(got["grads"], grads))
    dw = max(float((a - b).abs().max()) for a, b in zip(got["weights"], weights))
    print(f"  {what}: loss {float(got['comps']['loss']):.6f} / {loss:.6f} (rel {dl:.2e}), "
          f"gradients within {dg:.2e} of each maximum, weights {dw:.2e}", flush=True)
    check(dl < 1e-5 and dg < 1e-4 and dw < 1e-6, f"{what}: differs from one rank's step")


# ---- phase 15: the zero-shot model's contrast validation, training, CLI ----
VAL_ASSET = "contrast_val_bowl.npz"
VAL_PAIRS = 500_000           # the trainer's proposal_contrast_score arguments
VAL_ROTS = 36
VAL_CHECK_PAIRS = 150_000     # CPU against CUDA, the threshold scaled with them
VAL_CHECK_THRESH = 10.0 * VAL_CHECK_PAIRS / VAL_PAIRS
# of the mean boundary contrast at the hits, against JAX's stored CPU run and
# between the CPU and the card: the card's KNN, normals and network round
# otherwise than XLA's CPU code (PPF logits 4.6e-5 apart, a normal ~1e-4)
VAL_CONTRAST_RTOL = 1e-2
ZS_EPOCHS = 3
ZS_STEPS = 2                  # an epoch of phase 15's trainer (batch 2)
CLI_CORNER_PX = 2.0
DEMO_COLOR = os.path.join(ROOT, "data", "demo", "0000_color.png")
DEMO_DEPTH = os.path.join(ROOT, "data", "demo", "0000_depth.png")


def _zs_train_config():
    """``checkpoints/bowl_reg/config.yaml``, the zero-shot model's training
    snapshot (batch 2, 200 000 pairs a sample, Adam 1e-3 with decay 1e-4,
    the regression head), its contrast validation after every epoch."""
    from cppf_tpu_torch.config import load_config

    cfg = load_config("bowl", snapshot=os.path.join(ROOT, "checkpoints", "bowl_reg",
                                                    "config.yaml"))
    check((cfg.batch_size, cfg.npoint_pad, cfg.npoint_max, cfg.knn, cfg.res, cfg.train_pairs,
           cfg.out_dim, cfg.cls_bins, cfg.contrast_val_every, cfg.opt.lr,
           cfg.opt.weight_decay) == (2, 4096, 10000, 60, 0.004, 200000, 9, False, 10, 1e-3,
                                     1e-4), f"phase 15 not at bowl_reg's width: {cfg}")
    cfg.contrast_val_every = 1
    cfg.max_epoch = ZS_EPOCHS
    return cfg


def validation_stages(encoders, cfg, depth, centers, device):
    """One contrast validation stage by stage (``proposal_contrast_score``
    split), each synchronised.  Returns (HeatmapState, scores, the peak
    voxel near each GT center, {stage: seconds})."""
    from cppf_tpu_torch.data.shapenet import TRAIN_INTRINSICS
    from cppf_tpu_torch.eval.contrast_val import contrast_scores

    times = {}
    timed = _timer(device, times)
    hm, _ = heatmap_stages(encoders, cfg, depth, TRAIN_INTRINSICS, VAL_PAIRS, device,
                           VAL_ROTS, timed)
    scores, peaks = timed("host score (smoothing, contrast, proposals)", lambda: contrast_scores(
        hm.grid, hm.corner, cfg.res, centers))
    return hm, scores, peaks, times


def _scores_agree(got, want, what):
    d = abs(got["zs_mean_contrast"] - want["zs_mean_contrast"]) / max(
        abs(want["zs_mean_contrast"]), 1e-12)
    check(got["zs_hits"] == want["zs_hits"] and got["zs_false"] == want["zs_false"],
          f"{what}: hits/false {got['zs_hits']}/{got['zs_false']}, not "
          f"{want['zs_hits']}/{want['zs_false']}")
    check(d <= VAL_CONTRAST_RTOL, f"{what}: mean contrast {got['zs_mean_contrast']} is "
          f"{d:.2e} of {want['zs_mean_contrast']} off (> {VAL_CONTRAST_RTOL})")
    return d


def _box_mask(shape, dets):
    """The pixels the CLI paints for ``dets`` and each detection's
    projected corners."""
    from cppf_tpu_torch.eval import viz
    from cppf_tpu_torch.eval import zero_shot as zs

    mask = np.zeros(shape[:2], bool)
    corners = []
    for d in dets:
        proj = zs.detection_box(d)
        corners.append(proj)
        for i, j in zs.CLI_EDGES:
            mask |= viz.line_mask(shape, proj[i], proj[j], 2)
    return mask, corners


def cli_run(ckpt, out, what):
    """``python -m cppf_tpu_torch.eval.zero_shot --ckpt <ckpt>`` in this
    process on the demo frame at full width (5 M pairs); its PNG must read
    back, equal the colour frame outside the painted pixels and be red on
    them, and be drawn within ``CLI_CORNER_PX`` of every projected corner
    inside the image.  Returns (detections, seconds, launches)."""
    from cppf_tpu_torch.data.png import read_png
    from cppf_tpu_torch.eval import zero_shot as zs
    from cppf_tpu_torch.ops import vote_hist as vh

    vh.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dets, img = zs.main(["--ckpt", ckpt, "--color", DEMO_COLOR, "--depth", DEMO_DEPTH,
                         "--out", out])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(vh.LAUNCHES)
    png, color = read_png(out), read_png(DEMO_COLOR)
    check(png.shape == color.shape and np.array_equal(png, img), f"{what}: the PNG does not "
          f"read back as the drawn image")
    mask, corners = _box_mask(png.shape, dets)
    check(np.array_equal(png[~mask], color[~mask]), f"{what}: the PNG differs from the colour "
          f"frame outside the boxes")
    check(bool((png[mask] == [255, 0, 0]).all()), f"{what}: a box pixel is not red")
    drawn = np.argwhere(mask)[:, ::-1]
    far = 0.0
    for proj in corners:
        for c in proj:
            if 0 <= c[0] < png.shape[1] and 0 <= c[1] < png.shape[0]:
                far = max(far, float(np.min(np.linalg.norm(drawn - c, axis=1))))
    check(far <= CLI_CORNER_PX, f"{what}: a projected corner is {far:.1f} px from the drawing")
    print(f"{what}: {len(dets)} detections in {secs:.3f} s, {int(mask.sum())} "
          f"pixels drawn, every corner within {far:.1f} px of them; launches {launches}",
          flush=True)
    return dets, secs, launches


def zero_shot_train_phase(smi):
    """Phase 15: the zero-shot model's proposal-contrast validation, its
    training on the card and its command line.  Returns (the record of
    ``dense_hist``'s pairs front end on the val scene, the launches of the
    trainer's run)."""
    import tempfile

    from cppf_tpu_torch.data.shapenet import ShapeNetRenderDataset
    from cppf_tpu_torch.eval import contrast_val as cv
    from cppf_tpu_torch.models.convert import ASSETS, load_encoders, load_npz_params
    from cppf_tpu_torch.ops import vote_hist as vh
    from cppf_tpu_torch.ops.voting import pair_vote_params
    from cppf_tpu_torch.train import loop

    device = "cuda"
    cfg = _zs_train_config()
    params = load_npz_params(os.path.join(ASSETS, "bowl_reg_params_zs.npz"))
    encoders = load_encoders(params, 9, device)
    z = dict(np.load(os.path.join(ASSETS, VAL_ASSET)))
    jax_score = {k: z["jax_" + k].item() for k in ("zs_score", "zs_hits", "zs_false",
                                                   "zs_mean_contrast")}

    # (a) the committed params_zs on the val scene against JAX's stored run
    t0 = time.perf_counter()
    depth, centers = cv.make_val_scene("bowl")
    render_s = time.perf_counter() - t0
    check(np.array_equal(depth, z["depth"]), "phase 15: the val scene's depth is not JAX's")
    check(np.array_equal(np.stack(centers), z["gt_centers"]),
          "phase 15: the val scene's centers are not JAX's")
    vh.reset_launches()
    score = cv.proposal_contrast_score(depth, centers, encoders, cfg)
    torch.cuda.synchronize()
    launches = dict(vh.LAUNCHES)
    check(launches["dense_hist_pairs"] == 1 and sum(launches.values()) == 1,
          f"phase 15: a validation launched {launches}, not dense_hist_pairs once")
    runs = [validation_stages(encoders, cfg, depth, centers, device) for _ in range(3)]
    hm, staged, peaks, _ = runs[0]
    d_jax = _scores_agree(score, jax_score, "phase 15 (a) against JAX")
    _scores_agree(staged, score, "phase 15 (a) the staged validation")
    check(np.array_equal(np.stack(peaks), z["jax_peaks"]),
          f"phase 15: the peak voxels {np.stack(peaks).tolist()} are not JAX's "
          f"{z['jax_peaks'].tolist()}")
    stage_ms = {k: statistics.median(r[3][k] for r in runs) * 1e3 for k in runs[0][3]}
    print(f"phase 15 (a) ({smi}): committed params_zs on the val scene ({VAL_PAIRS} pairs, "
          f"{VAL_ROTS} rotations, {hm.point_idxs.shape[0]} after the degenerate filter, heatmap "
          f"{tuple(int(d) for d in hm.dims)}): {json.dumps(score)}; JAX's {json.dumps(jax_score)} "
          f"(contrast {d_jax:.2e} apart), peak voxels {np.stack(peaks).tolist()} = JAX's; "
          f"depth equal to JAX's; launches {launches}", flush=True)
    print(f"phase 15 (a) ({smi}): a validation by stage (median of 3, ms): scene render "
          f"{render_s * 1e3:.2f} (once a run), " + ", ".join(
              f"{k} {v:.2f}" for k, v in stage_ms.items())
          + f"; total {sum(stage_ms.values()):.2f}", flush=True)
    preds_tr = hm.preds[:, :2].contiguous()
    n = hm.pc.shape[0]
    vparams = pair_vote_params(hm.pc, preds_tr, torch.ones(n, device=device), hm.point_idxs,
                               cfg.res, VAL_ROTS, True,
                               torch.ones(hm.point_idxs.shape[0], dtype=torch.bool,
                                          device=device))
    frame = vh.vote_frame(torch.as_tensor(hm.corner, device=device), cfg.res,
                          torch.as_tensor(hm.dims, device=device).float())
    gshape = tuple(int(np.ceil(d / 8) * 8) for d in hm.dims)
    record = dense_record(vparams, frame, gshape, (1, 1, 1), "val scene, unpooled",
                          n_rots=VAL_ROTS)
    del hm, runs, vparams

    # (b) CPU (plain versions) against CUDA (kernels) on the same scene
    t0 = time.perf_counter()
    cpu = cv.proposal_contrast_score(depth, centers, params, cfg, n_pairs=VAL_CHECK_PAIRS,
                                     prop_thresh=VAL_CHECK_THRESH, device="cpu")
    cpu_s = time.perf_counter() - t0
    gpu = cv.proposal_contrast_score(depth, centers, encoders, cfg, n_pairs=VAL_CHECK_PAIRS,
                                     prop_thresh=VAL_CHECK_THRESH)
    d_cpu = _scores_agree(gpu, cpu, "phase 15 (b) cpu vs cuda")
    print(f"phase 15 (b): cpu vs cuda at {VAL_CHECK_PAIRS} pairs, threshold "
          f"{VAL_CHECK_THRESH}: {json.dumps(cpu)} / {json.dumps(gpu)} (contrast {d_cpu:.2e} "
          f"apart; cpu run {cpu_s:.1f} s)", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        # (c) the trainer from the committed params_zs, a validation an epoch
        out_dir = os.path.join(tmp, "bowl_reg")
        vh.reset_launches()
        t0 = time.perf_counter()
        out = loop.train(cfg, out_dir=out_dir, epoch_len=ZS_STEPS * cfg.batch_size,
                         device=device, init_params=params)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = dict(vh.LAUNCHES)
        check(out["state"].step == ZS_EPOCHS * ZS_STEPS, f"{out['state'].step} steps")
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        with open(os.path.join(out_dir, "zs_metrics.jsonl")) as f:
            zs_rows = [json.loads(line) for line in f]
        for row in rows:
            _finite_comps({k: v for k, v in row.items() if k.startswith("loss")},
                          "phase 15 epoch")
        check(len(rows) == ZS_EPOCHS and len(zs_rows) == ZS_EPOCHS,
              f"phase 15: {len(rows)} epochs and {len(zs_rows)} validations logged")
        check(train_launches["dense_hist_pairs"] == ZS_EPOCHS
              and sum(train_launches.values()) == ZS_EPOCHS,
              f"phase 15: the trainer launched {train_launches}, not dense_hist_pairs once a "
              f"validation")
        zs_path = os.path.join(out_dir, "params_zs.npz")
        check(os.path.exists(zs_path), "phase 15: the trainer wrote no params_zs.npz")
        # the first best, as the trainer keeps a score only when it is higher
        best = max(zs_rows, key=lambda r: r["zs_score"])
        reloaded = load_encoders(load_npz_params(zs_path), 9, device)
        again = cv.proposal_contrast_score(depth, centers, reloaded, cfg)
        d_best = _scores_agree(again, best, "phase 15 (c) params_zs.npz against the logged best")
        last = all(torch.equal(a, b) for m, r in zip((out["state"].point, out["state"].ppf),
                                                      reloaded)
                   for a, b in zip(m.parameters(), r.parameters()))
        check(last == (best["epoch"] == ZS_EPOCHS - 1), f"phase 15: params_zs.npz is "
              f"{'' if last else 'not '}the last epoch's weights, the best being epoch "
              f"{best['epoch']}")
        print(f"phase 15 (c) ({smi}): {ZS_EPOCHS} epochs of {ZS_STEPS} steps at batch "
              f"{cfg.batch_size}, {cfg.train_pairs} pairs a sample, from the committed params_zs "
              f"in {train_s:.2f} s; losses {[round(r['loss'], 6) for r in rows]}; validations "
              f"{json.dumps(zs_rows)}; params_zs.npz reloaded scores {json.dumps(again)} "
              f"(the logged best, epoch {best['epoch']}: contrast {d_best:.2e} apart); "
              f"launches {train_launches}", flush=True)
        ds = ShapeNetRenderDataset(cfg)
        med, peak, _, _ = train_step_times(cfg, out["state"], ds)
        step_ms = sum(med[k] for k in ("render", "draws", "prep", "step"))
        print(f"phase 15 (c) ({smi}): warm ms a regression train step {step_ms:.2f} = "
              f"host render {med['render']:.2f} + draws {med['draws']:.2f} + prep "
              f"{med['prep']:.2f} + step {med['step']:.2f} (device {med['step_device']:.2f}); "
              f"peak {peak / 2**30:.3f} GiB above the batch", flush=True)

        # (d) the command line at full width: the repo's checkpoint, then the run's
        demo = np.load(os.path.join(ASSETS, "demo_frame.npz"))
        dets, cli_s, cli_launches = cli_run(os.path.join(ROOT, "checkpoints", "bowl_reg"),
                                            os.path.join(tmp, "cli_asset.png"),
                                            "phase 15 (d) checkpoints/bowl_reg")
        check(len(dets) == 2, f"phase 15: the CLI gave {len(dets)} detections, not 2")
        chunks = -(-int(demo["jax_n_pairs"]) // DENSE_CHUNK)
        check(cli_launches["dense_hist_pairs"] == chunks
              and sum(cli_launches.values()) == chunks,
              f"phase 15: the CLI launched {cli_launches}, not dense_hist_pairs {chunks} times")
        for dist, d in _match(dets, BOWL_CENTERS):
            check(dist < 0.04, f"phase 15: a CLI detection is {dist * 1e3:.1f} mm from its bowl")
        for T, R in zip(demo["jax_T"], demo["jax_R"]):
            dist, d = _match(dets, [T])[0]
            up = float(np.degrees(np.arccos(np.clip(d.R[:, 1] @ R[:, 1], -1, 1))))
            print(f"phase 15 (d): against the JAX CPU detection at {np.round(T, 4)}: T "
                  f"{dist * 1e3:.3f} mm, up {up:.3f} deg", flush=True)
            check(dist < 0.01 and up < 5.0, "phase 15: a CLI detection is > 1 cm or > 5 deg "
                  "from JAX's")
        dets2, cli2_s, _ = cli_run(out_dir, os.path.join(tmp, "cli_run.png"),
                                   "phase 15 (d) phase 15's trained params_zs.npz")
        print(f"phase 15 (d) ({smi}): s a CLI run at {ZS_PAIRS} pairs (read, detect, draw, "
              f"write): {cli_s:.3f} (checkpoints/bowl_reg), {cli2_s:.3f} (the trained run: "
              f"{[np.round(d.T, 4).tolist() for d in dets2]})", flush=True)
    return {"dense_hist": record}, train_launches


# ---- phase 18: the quality gauges, the checkpoint eval and the demo -------
GAUGE_ASSET = "gauge_runs.npz"
GAUGE_CATEGORIES = ("bottle", "bowl", "camera", "can", "laptop", "mug", "table", "chair",
                    "bed", "sofa", "bookshelf", "bathtub")
GAUGE_POSES = 4
# --set flags of eval_checkpoints, one pose each (the committed view 0 and
# its key), with the kernel they reach and the cell of FLAG_CELLS that holds
# JAX's estimate of the same view and key under the same flag
GAUGE_FLAG_SETS = (("bowl", "center_mode=grid", "dense_hist_pairs", "grid"),
                   ("sofa", "coplanar_halfspace=true", "bound_projections", "halfspace"))


def _launched(fn):
    """(fn(), the launch counts of its run): counts set to 0 just before,
    read just after, the card synchronised around it; the script's own
    printing kept in a buffer."""
    import contextlib
    import io

    from cppf_tpu_torch.ops import vote_hist as vh

    torch.cuda.synchronize()
    vh.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        out = fn()
    torch.cuda.synchronize()
    return out, dict(vh.LAUNCHES)


def _peak_path_ok(launches, passes, what):
    """The pairs front ends of the peak kernels, once and 1-2 times a
    center pass, and nothing else."""
    check(launches["bound_projections_pairs"] == passes,
          f"{what}: bound_projections_pairs launched {launches['bound_projections_pairs']} times, "
          f"not once a center pass ({passes})")
    check(passes <= launches["refine_window_pairs"] <= 2 * passes,
          f"{what}: refine_window_pairs launched {launches['refine_window_pairs']} times for "
          f"{passes} center passes")
    check(all(launches[k] == 0 for k in ("bound_projections", "refine_window", "dense_hist",
                                         "dense_hist_pairs")),
          f"{what}: a votes front end or dense_hist launched")


def _dense_path_ok(launches, what):
    check(launches["dense_hist_pairs"] > 0, f"{what}: dense_hist_pairs never launched")
    check(all(launches[k] == 0 for k in ("dense_hist", "bound_projections", "refine_window")),
          f"{what}: a votes front end launched: {launches}")


def checkpoint_eval_gauge(total):
    """Phase 18 (a): ``eval_checkpoints.eval_category`` at 4 poses, seed 0,
    for every category: its views must be the committed views (the clouds
    as the runner takes them, the stored keys), each pose is printed beside
    JAX's stored estimate (the laptop's override pose beside
    ``jax_ov_*``), the medians against GT are held to phase 8's rule, and
    the launches to the peak kernels' rule; then one pose under each
    ``--set`` of ``GAUGE_FLAG_SETS``, held to JAX's estimate under that
    flag by phase 16's rule.  Returns ({category: the script's
    summary}, the kernel records of bowl's first view)."""
    from cppf_tpu_torch.eval.nocs_inference import _pad_cloud
    from cppf_tpu_torch.models.convert import ASSETS
    from cppf_tpu_torch.scripts import eval_checkpoints as ec

    ckpt = os.path.join(ROOT, "checkpoints")
    summary, records = {}, None
    for cat in GAUGE_CATEGORIES:
        z = np.load(os.path.join(ASSETS, f"{cat}_views.npz"))
        runner = ec.load_runner(cat, ckpt)
        cfg, pcfg = runner.cfg, runner.pcfg
        poses = []
        summary[cat], launches = _launched(lambda: ec.eval_category(
            cat, ckpt, GAUGE_POSES, 0, poses=poses, runner=runner))
        total.update(launches)
        ov = cat == "laptop"
        passes = (2 if pcfg.asym_center_refine else 1) * GAUGE_POSES * (2 if ov else 1)
        _peak_path_ok(launches, passes, f"phase 18 (a) {cat}")
        check(len(poses) == GAUGE_POSES == int(z["n_views"]), f"phase 18 (a) {cat}: "
              f"{len(poses)} poses")
        sets = [("", "jax_")] + ([("ov_", "jax_ov_")] if ov else [])
        for prefix, jax in sets:
            errs, jerrs = [], []
            for i, p in enumerate(poses):
                v = p["view"]
                pad, n_raw = _pad_cloud(v.pc, cfg.npoint_max)
                check(np.array_equal(pad[:n_raw], z[f"pc_{i}"]),
                      f"phase 18 (a) {cat} view {i}: not the committed view")
                if f"jax_key_{i}" in z.files:
                    check(np.array_equal(np.asarray(v.key, np.uint32), z[f"jax_key_{i}"]),
                          f"phase 18 (a) {cat} view {i}: not the stored JAX key")
                T, up, right = (p[prefix + k] for k in ("T", "up", "right"))
                jr = z[f"{jax}right_{i}"] if cfg.regress_right else None
                errs.append(category_errors(T, up, right, p[prefix + "scale"], z, i, cfg))
                jerrs.append(category_errors(z[f"{jax}T_{i}"], z[f"{jax}up_{i}"], jr,
                                             z[f"{jax}scale_{i}"], z, i, cfg))
                print(f"  phase 18 (a) {cat}{' override' if prefix else ''} view {i}: port minus "
                      f"JAX T {np.linalg.norm(T - z[f'{jax}T_{i}']) * 1e3:.3f} mm, up "
                      f"{_angle(up, z[f'{jax}up_{i}']):.3f} deg"
                      + (f", right {_angle(right, jr):.3f} deg" if jr is not None else ""),
                      flush=True)
            med = [_median([e[k] for e in errs]) for k in range(3)]
            jmed = [_median([e[k] for e in jerrs]) for k in range(3)]
            what = f"phase 18 (a) {cat}{' override' if prefix else ''}"
            check(med[0] <= 2 * jmed[0] + 5 * cfg.res, f"{what}: median T error "
                  f"{med[0] * 1e3:.1f} mm > twice JAX's {jmed[0] * 1e3:.1f} mm + 5 voxels")
            check(med[1] <= jmed[1] + 15.0, f"{what}: median up error {med[1]:.1f} deg > "
                  f"JAX's {jmed[1]:.1f} + 15 deg")
            if cfg.regress_right:
                check(med[2] <= jmed[2] + 15.0, f"{what}: median right error {med[2]:.1f} deg "
                      f"> JAX's {jmed[2]:.1f} + 15 deg")
            print(f"{what}: median T {med[0] * 1e3:.2f} mm, up {med[1]:.2f} deg, right "
                  f"{med[2]:.2f} deg (JAX's stored estimates: {jmed[0] * 1e3:.2f} mm, "
                  f"{jmed[1]:.2f}, {jmed[2]:.2f} deg); launches {launches}", flush=True)
        print(f"phase 18 (a) {cat}: eval_checkpoints {json.dumps(summary[cat])}", flush=True)
        if cat == "bowl":
            records = kernel_phase(main_path_inputs(runner, poses[0]["view"].pc,
                                                    pcfg.grid_shape),
                                   "eval_checkpoints bowl view 0")
        del runner
    stored = np.load(os.path.join(ASSETS, "flag_views.npz"))
    for cat, flag, kernel, name in GAUGE_FLAG_SETS:
        what = f"phase 18 (a) {cat} --set {flag}"
        runner = ec.load_runner(cat, ckpt, overrides=ec.parse_overrides([flag]))
        poses = []
        r, launches = _launched(lambda: ec.eval_category(cat, ckpt, 1, 0, poses=poses,
                                                         runner=runner))
        total.update(launches)
        check(flag_launches_ok(runner.pcfg, launches), f"{what}: launched {launches}")
        check(launches[kernel] >= 1, f"{what}: {kernel} not launched")
        # held to JAX's estimate of the same view and key under the same
        # flag (phase 16's cell ``name``) by phase 16's rule
        p, view = poses[0], poses[0]["view"]
        dT = float(np.abs(p["T"] - stored[f"{name}_T_0"]).max())
        up_d = _angle(p["up"], stored[f"{name}_up_0"])
        right_d = (_angle(p["right"], stored[f"{name}_right_0"]) if runner.cfg.regress_right
                   else None)
        print(f"{what}: {json.dumps(r)}; port minus JAX (phase 16's {name} cell): T "
              f"{dT * 1e3:.4f} mm, up {up_d:.4f} deg, right {right_d} deg, survivors "
              f"{p['n_filtered']} / {int(stored[f'{name}_n_filtered_0'])}; launches {launches}",
              flush=True)
        draws = runner.draws(view.key)
        _hold_flag_axes(what, runner, view.pc, draws, p["n_filtered"], stored, name, 0, up_d,
                        right_d)
        if dT > 1e-5:
            _, pre = runner.estimate(view.pc, draws=draws)
            check(_dense_value_ok(runner, pre, draws, [p["T"], stored[f"{name}_T_0"]]),
                  f"{what}: T {p['T'].tolist()} is not JAX's {stored[f'{name}_T_0'].tolist()}")
        del runner
    return summary, records


def _axes(RTs):
    """(T, up) of each R·|s| pose row [n, 4, 4]."""
    R = RTs[:, :3, :3] / np.cbrt(np.linalg.det(RTs[:, :3, :3]))[:, None, None]
    return RTs[:, :3, 3], R[:, :, 1]


def _hold_poses(what, T, up, T_j, up_j, fold, t_tol, up_tol, parts):
    """One pose against the stored JAX run's: within ``t_tol`` and
    ``up_tol`` it is JAX's; else it is listed in ``parts`` as (what, T, up
    of JAX's, whether T parted) for :func:`_hold_parts`."""
    dT = float(np.linalg.norm(T - T_j))
    d_up = _angle(up, up_j, fold=fold)
    print(f"  {what}: port minus JAX T {dT * 1e3:.3f} mm, up {d_up:.3f} deg", flush=True)
    if dT > t_tol or d_up > up_tol:
        parts.append((what, T, up_j, dT > t_tol, d_up > up_tol))


class _PoseRecorder:
    """Records each ``CategoryRunner.estimate`` call of the runs inside it:
    (runner, cloud, draws, T), so that a pose that parts from JAX's can be
    run again with its sphere counts captured."""

    def __enter__(self):
        from cppf_tpu_torch.eval.nocs_inference import CategoryRunner

        self.calls, self.real = [], CategoryRunner.estimate

        def estimate(runner, pc_raw, generator=None, draws=None, laptop_up=None):
            out = self.real(runner, pc_raw, generator, draws, laptop_up)
            self.calls.append((runner, pc_raw, draws, out[0].T.cpu().numpy()))
            return out

        CategoryRunner.estimate = estimate
        return self

    def __exit__(self, *exc):
        from cppf_tpu_torch.eval.nocs_inference import CategoryRunner

        CategoryRunner.estimate = self.real

    def margins(self, what, T, up_j, t_part):
        """The port's sphere counts at its winning up direction and at
        JAX's, the recorded pose whose T is ``T`` run again on its draws.
        Its T may part only after a second center pass (that of
        ``asym_center_refine`` weighs the points by their asymmetry about
        the first pass's up axis)."""
        mine = [c for c in self.calls if np.allclose(c[3], T, rtol=0, atol=1e-6)]
        check(len(mine) >= 1, f"{what}: no recorded pose")
        runner, pc_raw, draws, _ = mine[0]
        check(not t_part or runner.pcfg.asym_center_refine,
              f"{what}: T parts from JAX's without a second center pass")
        (top, at_jax), = axis_margins(runner, pc_raw, draws, (up_j,))
        return top, at_jax


class _UpVoteRecorder:
    """Records the sphere counts of each zero-shot detection's up vote
    (``sphere_bin_count`` in ``detect_from_heatmap``: one call a detection,
    in the order of the detections) of the runs inside it."""

    def __enter__(self):
        from cppf_tpu_torch.eval import zero_shot as zs

        self.counts, self.real = [], zs.sphere_bin_count

        def count(points, sphere, cos_tol):
            c = self.real(points, sphere, cos_tol)
            self.counts.append((c.cpu().numpy(), sphere.cpu().numpy()))
            return c

        zs.sphere_bin_count = count
        return self

    def __exit__(self, *exc):
        from cppf_tpu_torch.eval import zero_shot as zs

        zs.sphere_bin_count = self.real

    def margins_of(self, detections):
        """:func:`_hold_parts`' margins over the run's ``detections`` (a
        list a frame): a zero-shot T comes from the heatmap's peak and the
        box anchor, with no second center pass, so it never parts."""
        flat = [d for dets in detections for d in dets]
        check(len(flat) == len(self.counts), f"{len(self.counts)} up votes recorded for "
              f"{len(flat)} detections")

        def margins(what, T, up_j, t_part):
            check(not t_part, f"{what}: a zero-shot T parts from JAX's")
            k = next(k for k, d in enumerate(flat) if np.allclose(d.T, T, rtol=0, atol=1e-9))
            c, sphere = self.counts[k]
            # the vote picks a sphere point, the aux logits its sign
            return float(c.max()), float(max(c[np.argmax(sphere @ up_j)],
                                             c[np.argmax(-(sphere @ up_j))]))
        return margins


def _hold_parts(run, parts, margins):
    """The parted poses of one run (``_hold_poses``): at most one, and only
    as a near tie of its up axis (ROADMAP §C): JAX's up direction holds at
    least 1 - ``AXIS_TIE_FRAC`` of the winning sphere point's votes, as
    ``margins(what, T, up_j, t_part)`` counts them (``_PoseRecorder``,
    ``_UpVoteRecorder``) after checking that the pose's T may part.  A T
    beyond the tolerance passes only with its up axis parted."""
    check(len(parts) <= 1, f"phase 18 (b) {run}: {[p[0] for p in parts]} part from JAX's")
    for what, T, up_j, t_part, up_part in parts:
        check(up_part, f"{what}: T parts from JAX's with the up axis JAX's")
        top, at_jax = margins(what, T, up_j, t_part)
        print(f"    {what}: a parted up axis; the port's sphere counts at its winner {top} and "
              f"at JAX's direction {at_jax}", flush=True)
        check(at_jax >= (1 - AXIS_TIE_FRAC) * top, f"{what}: the parted up axis is no near tie")


def _ap_line(name, got, want, cells):
    return f"{name}: " + ", ".join(f"{k} {got[k]:.1f} (JAX {want[k]:.1f})" for k in cells)


def synthetic_gauges(tmp, total):
    """Phase 18 (b): the NOCS, SUN RGB-D and zero-shot synthetic runs at the
    settings of ``assets/gauge_runs.npz``, each instance against the stored
    JAX run (T within 1 cm, up within 5°, as phases 10-11 hold them; at
    most one parted pose a run, held as a near tie by :func:`_hold_parts`),
    the zero-shot detections counted as JAX's, the AP tables printed beside
    JAX's.  Returns {run: port summary}."""
    import pickle

    from cppf_tpu_torch.config import load_config
    from cppf_tpu_torch.eval.nocs_inference import SYNSET_NAMES, result_path
    from cppf_tpu_torch.models.convert import ASSETS
    from cppf_tpu_torch.scripts import (sunrgbd_synthetic_benchmark as sun_bench,
                                        synthetic_benchmark as synth,
                                        zero_shot_benchmark as zs_bench)

    z = np.load(os.path.join(ASSETS, GAUGE_ASSET))
    settings = json.loads(str(z["settings"]))
    ckpt = os.path.join(ROOT, "checkpoints")
    out = {}

    # NOCS: the driver on bowl, mug and can with clutter
    s = settings["nocs"]
    d = os.path.join(tmp, "nocs")
    with _PoseRecorder() as rec:
        got, launches = _launched(lambda: synth.main([
            "--category", s["category"], "--n_frames", str(s["n_frames"]), "--instances",
            str(s["instances"]), "--clutter", str(s["clutter"]), "--seed", str(s["seed"]),
            "--ckpt_path", ckpt, "--out_dir", d]))
    total.update(launches)
    check(launches["bound_projections_pairs"] > 0 and launches["refine_window_pairs"] > 0
          and launches["dense_hist_pairs"] == 0 and launches["bound_projections"] == 0,
          f"phase 18 (b) nocs: launches {launches}")
    parts = []
    check(got["frames"] == len(z["nocs_frames"]), "phase 18 (b) nocs: not JAX's frames")
    for f in z["nocs_frames"]:
        with open(result_path(os.path.join(d, "pred"),
                              {"image_path": f"data/real/scene_1/{f:04d}"}), "rb") as fh:
            res = pickle.load(fh)
        check(np.array_equal(res["pred_class_ids"], z[f"nocs_class_ids_{f}"]),
              f"phase 18 (b) nocs frame {f}: not JAX's instances")
        (T, up), (T_j, up_j) = _axes(res["pred_RTs"]), _axes(z[f"nocs_RTs_{f}"])
        for i, c in enumerate(res["pred_class_ids"]):
            name = SYNSET_NAMES[c]
            _hold_poses(f"phase 18 (b) nocs frame {f} instance {i} ({name})", T[i], up[i],
                        T_j[i], up_j[i], name in UP_SYMMETRIC, NOCS_T_TOL, NOCS_UP_TOL_DEG, parts)
    _hold_parts("nocs", parts, rec.margins)
    del rec
    want = synth.ap_table(z["nocs_iou_aps"], z["nocs_pose_aps"], got["categories"])
    for cat in got["categories"]:
        print(_ap_line(f"phase 18 (b) nocs {cat} AP %", got["aps"][cat], want[cat],
                       ("iou_25", "iou_50", "5deg_5cm", "10deg_10cm", "15deg_15cm")), flush=True)
    out["nocs"] = dict(got, eval=None, jax_aps=want)

    # SUN RGB-D: table scans
    s = settings["sun"]
    d = os.path.join(tmp, "sun")
    with _PoseRecorder() as rec:
        got, launches = _launched(lambda: sun_bench.main([
            "--category", s["category"], "--n_scans", str(s["n_scans"]), "--instances",
            str(s["instances"]), "--seed", str(s["seed"]), "--up_prior_deg",
            str(s["up_prior_deg"]), "--ckpt_path", ckpt, "--out_dir", d]))
    total.update(launches)
    # asym_center_refine is overlaid from the repo's config, up_sym the snapshot's
    cfg = load_config(s["category"], snapshot=os.path.join(ckpt, s["category"], "config.yaml"))
    _peak_path_ok(launches, got["instances"]
                  * (2 if load_config(s["category"]).asym_center_refine else 1),
                  "phase 18 (b) sun")
    with open(os.path.join(d, "pred", f"results_{s['category']}.pkl"), "rb") as fh:
        rows = pickle.load(fh)
    parts = []
    for scan in z["sun_scans"]:
        mine = np.asarray(rows[str(scan)], np.float64).reshape(-1, 17)
        theirs = z[f"sun_rows_{scan}"]
        check(len(mine) == len(theirs), f"phase 18 (b) sun scan {scan}: {len(mine)} poses, "
              f"JAX {len(theirs)}")
        for k, (a, b) in enumerate(zip(mine, theirs)):
            _hold_poses(f"phase 18 (b) sun scan {scan} box {k}", a[14:17],
                        a[5:14].reshape(3, 3)[:, 1], b[14:17], b[5:14].reshape(3, 3)[:, 1],
                        cfg.up_sym, SUN_T_TOL, SUN_UP_TOL_DEG, parts)
    _hold_parts("sun", parts, rec.margins)
    del rec
    degs, cms = sun_bench.POSE_DEGS, sun_bench.POSE_CMS
    want = {"iou_25": z["sun_iou_aps"][1, 25] * 100, "iou_50": z["sun_iou_aps"][1, 50] * 100}
    want.update({f"{dd}deg_{c}cm": z["sun_pose_aps"][1, degs.index(dd), cms.index(c)] * 100
                 for dd, c in sun_bench.SUMMARY_CELLS})
    print(_ap_line(f"phase 18 (b) sun {s['category']} AP %", got["aps"], want, list(want)),
          flush=True)
    out["sun"] = dict(got, eval=None, posed=None, jax_aps=want)

    # zero-shot: bowls, no detection priors
    s = settings["zs"]
    d = os.path.join(tmp, "zs")
    with _UpVoteRecorder() as rec:
        got, launches = _launched(lambda: zs_bench.main([
            "--category", s["category"], "--n_frames", str(s["n_frames"]), "--instances",
            str(s["instances"]), "--clutter", str(s["clutter"]), "--n_pairs", str(s["n_pairs"]),
            "--seed", str(s["seed"]), "--out_dir", d]))
    total.update(launches)
    _dense_path_ok(launches, "phase 18 (b) zero-shot")
    parts = []
    for f, dets in zip(z["zs_frames"], got["detections"]):
        T_j, up_j = _axes(z[f"zs_RTs_{f}"])
        check(len(dets) == len(T_j), f"phase 18 (b) zero-shot frame {f}: {len(dets)} "
              f"detections, JAX {len(T_j)}")
        for k in range(len(T_j)):
            dist, det = _match(dets, [T_j[k]])[0]
            _hold_poses(f"phase 18 (b) zero-shot frame {f} detection {k}", det.T, det.R[:, 1],
                        T_j[k], up_j[k], True, NOCS_T_TOL, NOCS_UP_TOL_DEG, parts)
    _hold_parts("zero-shot", parts, rec.margins_of(got["detections"]))
    del rec
    cls = SYNSET_NAMES.index(s["category"])
    want = {"iou_ap_25": round(float(z["zs_iou_aps"][cls, 25]) * 100, 1),
            "iou_ap_50": round(float(z["zs_iou_aps"][cls, 50]) * 100, 1),
            "pose_ap": {k: round(float(z["zs_pose_aps"][cls, i, j]) * 100, 1)
                        for k, (i, j) in zip(got["pose_ap"], np.ndindex(3, 3))}}
    print(f"phase 18 (b) zero-shot AP %: iou 25 {got['iou_ap_25']:.1f} (JAX "
          f"{want['iou_ap_25']:.1f}), pose {json.dumps(got['pose_ap'])} (JAX "
          f"{json.dumps(want['pose_ap'])}); {got['n_detections']} detections", flush=True)
    out["zero_shot"] = dict(got, eval=None, detections=None, jax_aps=want)
    return out


def default_gauges(tmp, total):
    """Phase 18 (c): each gauge at its defaults, the heatmap timer on the
    demo frame and the demo in both modes, each with its launches held to
    its path's rule.  Returns the ``gauges`` record and the dense_hist
    record of a synthetic zero-shot frame's first pair chunk."""
    from cppf_tpu_torch.config import load_config
    from cppf_tpu_torch.data.png import read_png
    from cppf_tpu_torch.demo import pose_single
    from cppf_tpu_torch.eval import zero_shot as zs
    from cppf_tpu_torch.eval.nocs_inference import REAL275_INTRINSICS
    from cppf_tpu_torch.models.convert import load_encoders
    from cppf_tpu_torch.scripts import (bench_zero_shot, sunrgbd_synthetic_benchmark as sun_bench,
                                        synthetic_benchmark as synth,
                                        zero_shot_benchmark as zs_bench)

    ckpt = os.path.join(ROOT, "checkpoints")
    gauges = {}
    t0 = time.perf_counter()
    nocs, launches = _launched(lambda: synth.main(["--ckpt_path", ckpt,
                                                    "--out_dir", os.path.join(tmp, "nocs")]))
    total.update(launches)
    _peak_path_ok(launches, nocs["instances"], "phase 18 (c) nocs")
    gauges["nocs"] = {k: nocs[k] for k in ("categories", "frames", "instances", "aps",
                                           "s_per_frame", "pose_s_per_frame")}
    gauges["nocs"]["run_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sun, launches = _launched(lambda: sun_bench.main(["--ckpt_path", ckpt,
                                                      "--out_dir", os.path.join(tmp, "sun")]))
    total.update(launches)
    _peak_path_ok(launches, sun["instances"] * (2 if load_config("table").asym_center_refine
                                                else 1), "phase 18 (c) sun")
    gauges["sun"] = {k: sun[k] for k in ("category", "scans", "instances", "aps", "s_per_scan")}
    gauges["sun"]["run_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    zsr, launches = _launched(lambda: zs_bench.main(["--out_dir", os.path.join(tmp, "zs")]))
    total.update(launches)
    _dense_path_ok(launches, "phase 18 (c) zero-shot")
    gauges["zero_shot"] = {k: zsr[k] for k in ("n_frames", "instances", "n_detections",
                                               "iou_ap_25", "iou_ap_50", "pose_ap",
                                               "s_per_frame", "first_s")}
    gauges["zero_shot"]["run_s"] = time.perf_counter() - t0
    heat, launches = _launched(lambda: bench_zero_shot.main([]))
    total.update(launches)
    _dense_path_ok(launches, "phase 18 (c) bench_zero_shot")
    gauges["heatmap"] = heat
    demo = {}
    dcfg = load_config("bottle")
    passes = 2 if dcfg.asym_center_refine else 1
    for mode, argv in (("oracle", []), ("ckpt", ["--ckpt", os.path.join(ckpt, "bottle")])):
        r, launches = _launched(lambda: pose_single.main(argv))
        total.update(launches)
        _peak_path_ok(launches, passes, f"phase 18 (c) demo, {mode} mode")
        T_err = float(np.linalg.norm(r["out"].T.cpu().numpy() - r["T_true"]))
        up_err = _angle(r["out"].up.cpu().numpy(), r["R_true"][:, 1], fold=dcfg.up_sym)
        check(np.isfinite(T_err) and np.isfinite(up_err), f"phase 18 (c) demo {mode}: not finite")
        demo[mode] = {"T_err_mm": T_err * 1e3, "up_err_deg": up_err, "s": r["seconds"],
                      "survivors": int(r["out"].n_filtered)}
        print(f"phase 18 (c) demo, {mode} mode: {json.dumps(demo[mode])}; launches {launches}",
              flush=True)
    check(demo["oracle"]["T_err_mm"] < 10.0 and demo["oracle"]["up_err_deg"] < 10.0,
          f"phase 18 (c) the oracle demo is off: {demo['oracle']}")
    gauges["demo"] = demo

    # dense_hist on the first synthetic zero-shot frame's first pair chunk
    zcfg, params = zs_bench.load_zero_shot(os.path.join(ckpt, "bowl_reg"))
    depth = read_png(os.path.join(tmp, "zs", "nocs", "real", "scene_1", "0000_depth.png"))
    hm = zs.zero_shot_heatmap(depth, load_encoders(params, 9, "cuda"), zcfg,
                              intrinsics=REAL275_INTRINSICS, n_pairs=2_000_000)
    label, make, frame, grid_shape, pool = dense_shapes(hm, zcfg.res)[0]
    record = dense_record(make(True), frame, grid_shape, pool,
                          f"zero-shot benchmark frame 0, {label}")
    return gauges, record


def gauges_phase(smi):
    """Phase 18: (a) the checkpoint eval against the committed views, (b)
    the synthetic runs against the stored JAX run, (c) the gauges at their
    defaults; prints the ``gauges`` line.  Returns (kernel records, the
    launches summed over the phase's runs)."""
    import collections
    import tempfile

    total = collections.Counter()
    t0 = time.perf_counter()
    medians, records = checkpoint_eval_gauge(total)
    t_a = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        synthetic = synthetic_gauges(os.path.join(tmp, "b"), total)
        t_b = time.perf_counter() - t0
        t0 = time.perf_counter()
        gauges, records["dense_hist"] = default_gauges(os.path.join(tmp, "c"), total)
        t_c = time.perf_counter() - t0
    gauges.update(eval_checkpoints=medians, card=smi,
                  against_jax={k: {"aps": v["aps"] if "aps" in v else v["pose_ap"],
                                   "jax_aps": v.get("jax_aps")} for k, v in synthetic.items()},
                  phase_s={"a": t_a, "b": t_b, "c": t_c})
    print(json.dumps({"gauges": gauges}, default=float), flush=True)
    print(smi_line(), flush=True)
    print(f"phase 18: launches over its runs {dict(total)}", flush=True)
    return records, dict(total)


# ---- phase 19: the reference CPPF's .pth checkpoints -----------------------
PTH_CATEGORIES = ("bowl", "mug")
PTH_TIMING_ROUNDS = 2         # warm passes over the views, in turns between the sources
PTH_LOAD_REPS = 5
SEG_CHECK_SHAPE = (224, 224)  # phase 14's crop
POSE_FIELDS = ("T", "up", "right", "scale", "n_filtered")


def _median_ms(fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _write_upstream(params, ckpt_dir, config):
    """``params`` as the upstream release lays a category out: the pair
    ``{point,ppf}_encoder_epochbest.pth`` and the config snapshot."""
    import shutil

    from cppf_tpu_torch.models.convert import export_reference_pth
    from cppf_tpu_torch.train.checkpoints import reference_pair

    os.makedirs(ckpt_dir, exist_ok=True)
    export_reference_pth(params, *reference_pair(ckpt_dir, "best"))
    shutil.copy(config, ckpt_dir)


def pth_category_poses(tmp, launches):
    """Phase 19 (a): each of ``PTH_CATEGORIES`` served from the upstream
    pair and from the committed ``.npz``, its views posed on JAX's draws:
    equal to the bit, the peak kernels' launches by their rule (added to
    ``launches`` for the ``.pth`` source).  Returns {category: {source: warm
    ms a pose}}."""
    from cppf_tpu_torch.core import threefry
    from cppf_tpu_torch.eval.nocs_inference import CategoryRunner
    from cppf_tpu_torch.models.convert import ASSETS, load_npz_params

    ms = {}
    for cat in PTH_CATEGORIES:
        _write_upstream(load_npz_params(os.path.join(ASSETS, f"{cat}_params_best.npz")),
                        os.path.join(tmp, "ckpt", cat),
                        os.path.join(ROOT, "checkpoints", cat, "config.yaml"))
        runners = {"pth": CategoryRunner(cat, ckpt_path=os.path.join(tmp, "ckpt")),
                   "npz": CategoryRunner(cat)}
        z = np.load(os.path.join(ASSETS, f"{cat}_views.npz"))
        n = int(z["n_views"])
        # bowl's views keep no JAX key: PRNGKey(i) for view i
        keys = [z[f"jax_key_{i}"] if f"jax_key_{i}" in z.files else threefry.key(i)
                for i in range(n)]
        poses = {}
        for src, r in runners.items():
            pcfg, cfg = r.pcfg, r.cfg
            g = cfg.resolved_grid_edge()
            check(pcfg.n_pairs == 100000 and pcfg.num_rots == 72 and pcfg.knn == 60
                  and pcfg.grid_shape == (g, g, g), f"phase 19 {cat}: not full width: {pcfg}")
            draws = [r.draws(k) for k in keys]
            poses[src], counts = _launched(
                lambda: [r.estimate(z[f"pc_{i}"], draws=draws[i])[0] for i in range(n)])
            passes = (2 if pcfg.asym_center_refine else 1) * n
            _peak_path_ok(counts, passes, f"phase 19 {cat} ({src})")
            if src == "pth":
                launches.update(counts)
            del draws
        for i in range(n):
            for k in POSE_FIELDS:
                a, b = (getattr(poses[src][i], k).cpu().numpy() for src in ("pth", "npz"))
                check(np.array_equal(a, b), f"phase 19 {cat} view {i}: {k} from the .pth pair "
                      f"{a.tolist()} is not the .npz's {b.tolist()}")
        times = {src: [] for src in runners}
        for rnd in range(PTH_TIMING_ROUNDS):
            for src in list(runners)[::1 if rnd % 2 == 0 else -1]:
                r = runners[src]
                for i in range(n):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    r.estimate(z[f"pc_{i}"])
                    torch.cuda.synchronize()
                    times[src].append((time.perf_counter() - t0) * 1e3)
        ms[cat] = {src: statistics.median(t) for src, t in times.items()}
        p0 = poses["pth"][0]
        print(f"phase 19 {cat}: {n} views on JAX's draws, the .pth pair's poses equal the "
              f".npz's in {', '.join(POSE_FIELDS)} (view 0: T {p0.T.tolist()}, survivors "
              f"{int(p0.n_filtered)}); warm ms a pose {ms[cat]['pth']:.2f} (.pth) / "
              f"{ms[cat]['npz']:.2f} (.npz), median of {len(times['pth'])}", flush=True)
    return ms


def pth_zero_shot_cli(tmp, launches):
    """Phase 19 (b): the zero-shot CLI at full width from a directory that
    holds ``bowl_reg``'s ``params_zs`` as the upstream pair, against the
    repo's ``checkpoints/bowl_reg`` (its orbax ``params_zs``, equal to the
    ``.npz`` asset; ``npz`` below): the same 2 detections to the bit,
    ``dense_hist_pairs`` once a chunk (the first ``.pth`` run's added to
    ``launches``); the sources in turns, .npz, .pth, .pth, .npz.  Returns {source: median seconds of a CLI run}."""
    from cppf_tpu_torch.models.convert import ASSETS, load_npz_params

    zs_dir = os.path.join(tmp, "bowl_reg")
    _write_upstream(load_npz_params(os.path.join(ASSETS, "bowl_reg_params_zs.npz")), zs_dir,
                    os.path.join(ROOT, "checkpoints", "bowl_reg", "config.yaml"))
    demo = np.load(os.path.join(ASSETS, "demo_frame.npz"))
    chunks = -(-int(demo["jax_n_pairs"]) // DENSE_CHUNK)
    ckpts = {"npz": os.path.join(ROOT, "checkpoints", "bowl_reg"), "pth": zs_dir}
    first, secs = None, {src: [] for src in ckpts}
    for turn, src in enumerate(("npz", "pth", "pth", "npz")):
        dets, s, counts = cli_run(ckpts[src], os.path.join(tmp, f"cli_{turn}.png"),
                                  f"phase 19 (b) the CLI from the .{src} weights")
        secs[src].append(s)
        check(len(dets) == 2, f"phase 19: the CLI from the .{src} weights gave {len(dets)} "
              f"detections, not 2")
        check(counts["dense_hist_pairs"] == chunks and sum(counts.values()) == chunks,
              f"phase 19: the CLI launched {counts}, not dense_hist_pairs {chunks} times")
        if turn == 1:
            launches.update(counts)
        first = first or dets
        for a, b in zip(dets, first):
            for k in ("T", "R", "scale"):
                check(np.array_equal(getattr(a, k), getattr(b, k)), f"phase 19: a CLI "
                      f"detection's {k} from the .{src} weights differs from the first run's")
    return {src: statistics.median(s) for src, s in secs.items()}


def _torchvision_segmenter(seed=19):
    """A torchvision-keyed fcn_resnet50 state dict (InstanceNorms with
    running statistics and their ``num_batches_tracked`` counters), its
    weights and statistics drawn from ``seed``: He-normal kernels, norm
    scales near 1, so that the logits vary across the image."""
    from cppf_tpu_torch.models.convert import fcn_resnet50_to_torch, segmenter_flat_params
    from cppf_tpu_torch.models.segmenter import FCNResNet50

    rng = np.random.default_rng(seed)
    tree: dict = {}
    flat = segmenter_flat_params(FCNResNet50(2, track_stats=True))
    for key in sorted(flat):
        *parts, leaf = key.split("/")
        node = tree
        for part in parts:
            node = node.setdefault(part, {})
        shape = flat[key].shape
        if leaf == "kernel":  # HWIO
            arr = rng.normal(size=shape) * np.sqrt(2.0 / np.prod(shape[:3]))
        elif leaf == "scale":
            arr = 1.0 + 0.1 * rng.normal(size=shape)
        elif leaf == "var":
            arr = rng.random(shape) * 0.5 + 0.75
        else:  # bias, mean
            arr = 0.1 * rng.normal(size=shape)
        node[leaf] = arr.astype(np.float32)
    sd = {}
    for k, v in fcn_resnet50_to_torch(tree).items():
        sd[k] = torch.from_numpy(v)
        if k.endswith(".running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(100)
    return sd


def pth_segmenter(tmp, device):
    """Phase 19 (c): a torchvision-keyed segmenter through
    ``fcn_resnet50_from_torch``, written as the ``.npz`` that
    ``SegmenterRunner`` serves; its logits on a seeded 224² image, CPU
    against CUDA with phase 14's limits.  Returns the record."""
    from cppf_tpu_torch.models.convert import (fcn_resnet50_from_torch, save_segmenter_npz,
                                               segmenter_state_dict)
    from cppf_tpu_torch.models.segmenter import FCNResNet50, SegmenterRunner

    sd = _torchvision_segmenter()
    params = fcn_resnet50_from_torch(sd)
    model = FCNResNet50(2, track_stats=True)
    model.load_state_dict(segmenter_state_dict(params), strict=True)
    aux_dir = os.path.join(tmp, "laptop_aux")
    save_segmenter_npz(os.path.join(aux_dir, "params_best.npz"), model)
    segs = {dev: SegmenterRunner(aux_dir, device=dev) for dev in ("cpu", device)}
    check(all(seg.model.stem_bn.track_stats for seg in segs.values()),
          "phase 19: the converted segmenter does not normalise by its running statistics")
    rgb = np.random.default_rng(20).random(SEG_CHECK_SHAPE + (3,)).astype(np.float32)
    logits = {dev: seg.logits(rgb).cpu().numpy() for dev, seg in segs.items()}
    d_logit = float(np.abs(logits["cpu"] - logits[device]).max())
    scale = float(np.abs(logits["cpu"]).max())
    same = float((logits["cpu"].argmax(-1) == logits[device].argmax(-1)).mean())
    rec = dict(keys=len(sd), max_abs_logit=scale, cpu_cuda_max_abs_err=d_logit,
               labels_equal=same, forward_ms=cuda_ms(lambda: segs[device].logits(rgb)))
    print(f"phase 19 (c): a torchvision-keyed segmenter ({len(sd)} keys, running statistics) "
          f"through fcn_resnet50_from_torch and SegmenterRunner: cpu vs cuda logits within "
          f"{d_logit:.2e} (max |logit| {scale:.3f}), labels equal on {same * 100:.3f} % of "
          f"224²; {rec['forward_ms']:.3f} ms a forward", flush=True)
    check(np.isfinite(scale) and scale > 0, "phase 19: the converted segmenter's logits")
    check(d_logit <= 1e-4 * scale, "phase 19: CPU and CUDA segmenter logits differ")
    check(same >= 0.999, "phase 19: CPU and CUDA segmenter labels differ")
    return rec


def reference_pth_phase(smi):
    """Phase 19: the reference CPPF's ``.pth`` checkpoints served by the
    runner, the zero-shot CLI and the segmenter's converter; prints the
    ``reference_pth`` line.  Returns the launches of the runs on ``.pth``
    weights."""
    import collections
    import tempfile

    from cppf_tpu_torch.models.convert import ASSETS
    from cppf_tpu_torch.train.checkpoints import (load_params, load_reference_pth,
                                                  reference_pair)

    launches = collections.Counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pose_ms = pth_category_poses(tmp, launches)
        t_a = time.perf_counter() - t0
        # bowl's weights read as each source holds them
        pair = reference_pair(os.path.join(tmp, "ckpt", "bowl"), "best")
        load_ms = {"pth_pair": _median_ms(lambda: load_reference_pth(*pair), PTH_LOAD_REPS),
                   "npz": _median_ms(lambda: load_params(ASSETS, "bowl_params_best"),
                                     PTH_LOAD_REPS)}
        t0 = time.perf_counter()
        cli_s = pth_zero_shot_cli(tmp, launches)
        t_b = time.perf_counter() - t0
        t0 = time.perf_counter()
        seg = pth_segmenter(tmp, "cuda")
        t_c = time.perf_counter() - t0
    print(json.dumps({"reference_pth": dict(load_ms=load_ms, ms_per_pose=pose_ms,
                                            cli_s=cli_s, segmenter=seg, card=smi,
                                            phase_s={"a": t_a, "b": t_b, "c": t_c})},
                     default=float), flush=True)
    print(smi_line(), flush=True)
    print(f"phase 19: launches of the runs on .pth weights {dict(launches)}", flush=True)
    return dict(launches)


# ---- phase 20: the repo's orbax checkpoints, read without JAX ---------------
ORBAX_CHECKPOINTS = 33        # 25 params_best, bowl_reg/params_zs, 7 best_decode
ORBAX_READ_REPS = 3           # reads of each checkpoint; the first is cold
ORBAX_ASSETS = dict([(f"{c}/params_best", f"{c}_params_best.npz") for c in
                     ("bathtub", "bed", "bookshelf", "bottle", "bowl", "camera", "can", "chair",
                      "laptop", "mug", "sofa", "table")]
                    + [("bowl_reg/params_zs", "bowl_reg_params_zs.npz")])
# a JAX train state whose params are the production bathtub's (same config):
# served by name, its view 0 must pose as the production weights pose it
BEST_DECODE = ("bathtub", "bathtub_r5")


def _orbax_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _orbax_leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _orbax_leaves(v, prefix + (str(i),))
    else:
        yield prefix, tree


def orbax_reads():
    """Phase 20 (a): every committed orbax checkpoint read by
    ``train/orbax.restore_numpy`` (``ORBAX_READ_REPS`` times, the first
    cold), its leaves held to its ``_METADATA`` (count, key paths, shapes,
    None where orbax stored none), the 12 categories' ``params_best`` and
    ``bowl_reg``'s ``params_zs`` to their ``.npz`` assets bit for bit; the
    decoder alone timed on ``laptop_aux``'s chunks.  Returns the record."""
    from cppf_tpu_torch.models.convert import ASSETS, load_npz_params
    from cppf_tpu_torch.train import orbax

    t0 = time.perf_counter()
    orbax.load_zstd()
    build_s = time.perf_counter() - t0
    dirs = sorted(os.path.dirname(p) for p in
                  glob.glob(os.path.join(ROOT, "checkpoints", "*", "*", "_METADATA")))
    check(len(dirs) == ORBAX_CHECKPOINTS, f"phase 20: {len(dirs)} orbax checkpoints, not "
          f"{ORBAX_CHECKPOINTS}")
    reads = {}
    for d in dirs:
        name = os.path.relpath(d, os.path.join(ROOT, "checkpoints"))
        times = []
        for _ in range(ORBAX_READ_REPS):
            t0 = time.perf_counter()
            tree = orbax.restore_numpy(d)
            times.append((time.perf_counter() - t0) * 1e3)
        leaves = dict(_orbax_leaves(tree))
        with open(os.path.join(d, "_METADATA")) as f:
            meta = json.load(f)["tree_metadata"]
        want = {tuple(k["key"] for k in m["key_metadata"]):
                (None if m["value_metadata"]["value_type"] == "None"
                 else tuple(m["value_metadata"]["write_shape"])) for m in meta.values()}
        got = {k: None if v is None else v.shape for k, v in leaves.items()}
        check(got == want, f"phase 20: {name}: leaves or shapes differ from its _METADATA")
        nbytes = sum(v.nbytes for v in leaves.values() if v is not None)
        reads[name] = dict(leaves=len(leaves), mb=nbytes / 1e6, first_ms=times[0],
                           ms=statistics.median(times[1:]))
        if name in ORBAX_ASSETS:
            flat = dict(_orbax_leaves(tree["params"]))
            asset = dict(_orbax_leaves(load_npz_params(os.path.join(ASSETS,
                                                                     ORBAX_ASSETS[name]))))
            check(sorted(flat) == sorted(asset) and all(
                flat[k].dtype == asset[k].dtype and flat[k].tobytes() == asset[k].tobytes()
                for k in asset), f"phase 20: {name} differs from {ORBAX_ASSETS[name]}")
        print(f"phase 20 (a) {name}: {len(leaves)} leaves, {nbytes / 1e6:.3f} MB, "
              f"{times[0]:.2f} ms cold, {reads[name]['ms']:.2f} ms warm"
              + (f"; equal to {ORBAX_ASSETS[name]} to the bit" if name in ORBAX_ASSETS
                 else ""), flush=True)
    # the decoder alone, on the segmenter's chunks held in memory
    aux = os.path.join(ROOT, "checkpoints", "laptop_aux", "params_best")
    with orbax.Database(aux) as db:
        items = db.items()
        raws = [db.value(v) for k, v in items.items() if not k.endswith(b"/.zarray")]
    times = []
    for _ in range(ORBAX_READ_REPS):
        t0 = time.perf_counter()
        out_bytes = sum(orbax.zstd_decompress(raw, 1 << 31).size for raw in raws)
        times.append(time.perf_counter() - t0)
    in_bytes = sum(len(r) for r in raws)
    dec = dict(chunks=len(raws), in_mb=in_bytes / 1e6, out_mb=out_bytes / 1e6,
               s=statistics.median(times), mb_per_s=out_bytes / 1e6 / statistics.median(times))
    total = {k: sum(r[k] for r in reads.values()) for k in ("first_ms", "ms", "mb")}
    print(f"phase 20 (a): {len(reads)} checkpoints read, {total['mb']:.1f} MB of arrays, "
          f"{total['first_ms']:.1f} ms cold / {total['ms']:.1f} ms warm in all; laptop_aux "
          f"{reads['laptop_aux/params_best']['first_ms']:.1f} / "
          f"{reads['laptop_aux/params_best']['ms']:.1f} ms; the decoder alone on its "
          f"{len(raws)} chunks: {dec['out_mb']:.1f} MB out of {dec['in_mb']:.1f} MB in "
          f"{dec['s'] * 1e3:.1f} ms, {dec['mb_per_s']:.1f} MB/s; the library built in "
          f"{build_s:.2f} s", flush=True)
    return dict(reads=reads, decoder=dec, build_s=build_s, total=total)


def orbax_laptop_frame(tmp, device):
    """Phase 20 (b): the laptop frame posed end to end from the committed
    ``checkpoints/laptop_aux`` (linked unchanged; no labels injected): the
    ms from reading the segmenter to the laptop's first pose, its labels
    against JAX's stored ones, ``laptop_up`` and the after-override pose
    against JAX's, then ``nocs_inference.main`` twice (the first run's
    launches by phase 14's rule) with every instance held to the stored
    JAX driver by phase 10's limits.  Returns (record, launches)."""
    import pickle

    from cppf_tpu_torch.data.png import read_png
    from cppf_tpu_torch.eval import nocs_inference as ni
    from cppf_tpu_torch.ops import vote_hist as vh

    aux = os.path.join(ROOT, "checkpoints", "laptop_aux")
    seg_dir, nocs_dir, ckpt, record, stored = unpack_nocs_frame(tmp, LAPTOP_FRAME, aux)
    names = [ni.SYNSET_NAMES[c] for c in record["pred_class_ids"]]
    k = int(stored["laptop"])
    path = os.path.join(nocs_dir, record["image_path"][5:])
    img, depth = read_png(path + "_color.png")[:, :, :3], read_png(path + "_depth.png")
    runner = ni.CategoryRunner("laptop", device=device)
    pc = ni.frame_crops(depth, record, {"laptop": runner})["laptop"][0][1]
    r_inst, r_plane = (tuple(int(v) for v in stored[n]) for n in ("r_inst", "r_plane"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seg = ni.load_segmenter(ckpt, device)
    check(not isinstance(seg, Exception) and seg is not None,
          f"phase 20: no segmenter from {aux}: {seg}")
    torch.cuda.synchronize()
    seg_ms = (time.perf_counter() - t0) * 1e3
    out, up = ni.pose_laptop(runner, ni.LaptopFrame(seg, img, ni.frame_masks(record)), k, pc,
                             r_inst, r_plane)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    crop, _, _ = ni.laptop_crop(img, np.where(record["pred_masks"][:, :, k]))
    labels = seg.predict(crop)
    same = float((labels == stored["labels"]).mean())
    check(up is not None, "phase 20: the segmenter gave no up axis")
    d_up = float(np.radians(_angle(up, stored["laptop_up"])))
    dT = float(np.linalg.norm(out.T.cpu().numpy() - stored["after_T"]))
    d_pose_up = _angle(out.up.cpu().numpy(), stored["after_R"][:, 1])
    print(f"phase 20 (b): the committed segmenter (orbax, read on the card's host) on the "
          f"laptop frame: labels equal JAX's on {same * 100:.3f} % of 224²; laptop_up "
          f"{d_up:.2e} rad from JAX's; the after-override pose T {dT * 1e3:.4f} mm, up "
          f"{d_pose_up:.4f} deg from JAX's; {seg_ms:.1f} ms to read and place the segmenter, "
          f"{first_ms:.1f} ms from the read to the laptop's first pose", flush=True)
    check(same >= 0.999, "phase 20: the committed segmenter's labels differ from JAX's")
    check(d_up <= LAPTOP_UP_TOL_RAD, "phase 20: laptop_up differs from JAX's")
    check(dT <= 1e-5, "phase 20: the after-override T is not JAX's voxel")
    check(d_pose_up <= LAPTOP_POSE_UP_TOL_DEG, "phase 20: the after-override up differs")
    del seg

    argv = ["--seg_dir", seg_dir, "--nocs_dir", nocs_dir, "--ckpt_path", ckpt,
            "--seed", str(int(stored["seed"])), "--device", device]
    secs, launches = [], None
    for rep in range(2):
        out_dir = os.path.join(tmp, f"pred_{rep}")
        torch.cuda.synchronize()
        vh.reset_launches()
        t0 = time.perf_counter()
        ni.main(argv + ["--out_dir", out_dir])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if launches is None:
            launches = dict(vh.LAUNCHES)
    with open(ni.result_path(out_dir, record), "rb") as f:
        res = pickle.load(f)
    runners = ni.load_runners(ni.build_parser().parse_args(argv))
    passes = sum(2 if runners[c].pcfg.asym_center_refine else 1 for c in names) + 1
    _peak_path_ok(launches, passes, "phase 20 (b) the driver")
    RTs = res["pred_RTs"]
    R = RTs[:, :3, :3] / np.cbrt(np.linalg.det(RTs[:, :3, :3]))[:, None, None]
    flips = []
    for i, cat in enumerate(names):
        check(not np.allclose(RTs[i], np.eye(4)) and np.linalg.det(RTs[i][:3, :3]) > 0,
              f"phase 20: instance {i} was not posed")
        dT = float(np.linalg.norm(RTs[i][:3, 3] - stored["T"][i]))
        d_up = _angle(R[i][:, 1], stored["up"][i], fold=cat in UP_SYMMETRIC)
        print(f"  instance {i} ({cat}): the driver minus JAX's T {dT * 1e3:.4f} mm, up "
              f"{d_up:.4f} deg", flush=True)
        check(dT <= NOCS_T_TOL, f"phase 20: instance {i} T {dT * 1e3:.2f} mm from JAX's")
        if d_up > NOCS_UP_TOL_DEG:
            flips.append(i)
    check(len(flips) <= 1 and k not in flips,
          f"phase 20: up axes of instances {flips} differ from JAX's")
    dT = float(np.linalg.norm(RTs[k][:3, 3] - stored["after_T"]))
    d_up = _angle(R[k][:, 1], stored["after_R"][:, 1])
    check(dT <= 1e-5 and d_up <= LAPTOP_POSE_UP_TOL_DEG,
          f"phase 20: the driver's laptop is not JAX's after-override pose ({dT}, {d_up})")
    print(f"phase 20 (b): the driver on the laptop frame from checkpoints/laptop_aux: "
          f"{secs[0]:.3f} s the first run (runners, the segmenter read and first calls), "
          f"{secs[1]:.3f} s the second; launches {launches} ({passes} center passes: the "
          f"laptop posed twice)", flush=True)
    return dict(labels_equal=same, laptop_up_rad=float(np.radians(
        _angle(up, stored["laptop_up"]))), segmenter_ms=seg_ms, first_laptop_pose_ms=first_ms,
        driver_s=secs), launches


def orbax_best_decode(tmp, device):
    """Phase 20 (c): ``eval_checkpoints --name best_decode`` on a ``*_r5*``
    experiment (linked as its category), view 0: the JAX train state's
    ``params`` are served, and the pose equals to the bit the one the
    production ``params_best`` of the same weights gives.  Returns the
    launches of the ``best_decode`` run."""
    from cppf_tpu_torch.models.convert import params_to_state_dicts
    from cppf_tpu_torch.scripts import eval_checkpoints as ec
    from cppf_tpu_torch.train.orbax import restore_numpy

    cat, exp = BEST_DECODE
    ckpt = os.path.join(tmp, "r5")
    os.makedirs(ckpt)
    os.symlink(os.path.join(ROOT, "checkpoints", exp), os.path.join(ckpt, cat))
    runner = ec.load_runner(cat, ckpt, "best_decode", device)
    state = restore_numpy(os.path.join(ROOT, "checkpoints", exp, "best_decode"))
    check(sorted(state) == ["opt_state", "params", "step"],
          f"phase 20: {exp}/best_decode is not a train state")
    for want, module in zip(params_to_state_dicts(state["params"]),
                            (runner.point_encoder, runner.ppf_encoder)):
        got = module.state_dict()
        check(sorted(got) == sorted(want) and all(
            torch.equal(got[k].cpu(), want[k]) for k in want),
            f"phase 20: the runner does not serve {exp}/best_decode's params")
    poses = {}
    summary, launches = _launched(lambda: ec.main(
        ["--categories", cat, "--ckpt_path", ckpt, "--name", "best_decode", "--n_poses", "1",
         "--device", device]))
    check(cat in summary, f"phase 20: eval_checkpoints --name best_decode gave {summary}")
    passes = 2 if runner.pcfg.asym_center_refine else 1
    _peak_path_ok(launches, passes, "phase 20 (c) eval_checkpoints --name best_decode")
    for src, path, name in (("best_decode", ckpt, "best_decode"),
                            ("params_best", os.path.join(ROOT, "checkpoints"), None)):
        poses[src] = []
        ec.eval_category(cat, path, 1, 0, ckpt_name=name, device=device, poses=poses[src])
    for f in ("T", "up", "right", "scale", "n_filtered"):
        a, b = (np.asarray(poses[src][0][f]) for src in ("best_decode", "params_best"))
        check(np.array_equal(a, b), f"phase 20: {cat} view 0 {f} from {exp}/best_decode "
              f"differs from checkpoints/{cat}/params_best's")
    r = summary[cat]
    print(f"phase 20 (c): eval_checkpoints --name best_decode on {exp} ({cat}, view 0, step "
          f"{int(state['step'])}): T err {r['t_err_mm_median']} mm, up err "
          f"{r['up_err_deg_median']} deg; the pose equals the production params_best's to "
          f"the bit; launches {launches}", flush=True)
    return launches


def orbax_phase(smi):
    """Phase 20: the repo's orbax checkpoints served on the card with no
    JAX; prints the ``orbax`` line.  Returns the launches of the laptop
    frame's first driver run."""
    import tempfile

    t0 = time.perf_counter()
    reads = orbax_reads()
    t_a = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        frame, launches = orbax_laptop_frame(tmp, "cuda")
        t_b = time.perf_counter() - t0
        t0 = time.perf_counter()
        bd_launches = orbax_best_decode(tmp, "cuda")
        t_c = time.perf_counter() - t0
    print(json.dumps({"orbax": dict(reads, laptop_frame=frame, best_decode_launches=bd_launches,
                                    card=smi, phase_s={"a": t_a, "b": t_b, "c": t_c})},
                     default=float), flush=True)
    print(smi_line(), flush=True)
    return launches


# ---- phase 21: bench.py's main cell against JAX's stored estimates ---------
BENCH_ASSET = "bench_cell.npz"
BENCH_T_TOL = 1e-5            # m: JAX's voxel
BENCH_UP_TOL_DEG = 1.0        # up to sign: bottle is up_sym
BENCH_SCALE_RTOL = 1e-4
BENCH_CPU_PAIRS = PHASE9_PAIRS


def hold_bench_pose(what, out, z, name, inputs, mode, key, parts):
    """Phase 21's rule for one pose of the bench cell against JAX's stored
    ``<name>_*`` (``scripts/export_torch_bench_cell.py``): T within
    ``BENCH_T_TOL`` of JAX's, or a tie: the port's voxel a maximum of its
    own center grid (``bench_cell.center_grid``), JAX's voxel one of JAX's,
    the two maxima equal; up within ``BENCH_UP_TOL_DEG`` of JAX's up to
    sign, or a near tie on the port's sphere counts (phase 16's
    ``AXIS_TIE_FRAC``); scale within ``BENCH_SCALE_RTOL``.  ``inputs``
    carry the pose's cloud; a tie or near tie is printed and added to
    ``parts``.  Returns the pose's row of the phase's JSON line."""
    from cppf_tpu_torch.pipeline.pose import grid_frame
    from cppf_tpu_torch.scripts.bench_cell import center_grid

    pre, res = inputs.pre, inputs.pcfg.res
    corner = grid_frame(pre.pc, pre.valid_mask, inputs.pcfg)[0].cpu().numpy()
    T, up = out.T.cpu().numpy(), out.up.cpu().numpy()
    voxel = np.rint((T - corner) / np.float32(res)).astype(np.int32)
    dT = float(np.abs(T - z[f"{name}_T"]).max())
    up_d = _angle(up, z[f"{name}_up"], fold=True)
    ds = float(np.abs(out.scale.cpu().numpy() / z[f"{name}_scale"] - 1).max())
    row = dict(pose=name, dT=dT, voxel=voxel.tolist(), jax_voxel=z[f"{name}_voxel"].tolist(),
               peak=float(out.grid_max), jax_peak=float(z[f"{name}_grid_max"]),
               jax_grid_ties=int(z[f"{name}_n_ties"]), up_deg=up_d, scale_rel=ds,
               survivors=int(out.n_filtered), jax_survivors=int(z[f"{name}_n_filtered"]))
    print(f"  {what}: port minus JAX: T {dT:.2e} m (voxel {row['voxel']}, JAX's "
          f"{row['jax_voxel']}), peak {row['peak']:g} (JAX {row['jax_peak']:g}, its grid's "
          f"maximum held by {row['jax_grid_ties']} cell(s)), up {up_d:.4f} deg, scale "
          f"{ds:.2e}, survivors {row['survivors']} (JAX {row['jax_survivors']})", flush=True)
    if dT > BENCH_T_TOL:
        grid = center_grid(inputs, mode, key)[0].cpu().numpy()
        jax_peak = float(z[f"{name}_grid_peak"])
        in_jax = any(np.array_equal(voxel, t) for t in z[f"{name}_ties"])
        row["tie"] = dict(port_voxel_value=float(grid[tuple(voxel)]),
                          port_grid_peak=float(grid.max()), jax_grid_peak=jax_peak,
                          jax_voxel_value=float(z[f"{name}_voxel_value"]),
                          in_jax_ties=in_jax)
        print(f"    T parts: {row['tie']}", flush=True)
        check(row["tie"]["port_voxel_value"] == row["tie"]["port_grid_peak"] == jax_peak
              == row["tie"]["jax_voxel_value"],
              f"{what}: T {T.tolist()} is not JAX's {z[f'{name}_T'].tolist()}, and the two "
              f"are not maxima of equal value of their grids: {row['tie']}")
        parts["ties"].append(what)
    if up_d > BENCH_UP_TOL_DEG:
        ((top, at_jax),) = sphere_margins(
            lambda: pose_cell_on(inputs, mode, key), inputs.sphere, (z[f"{name}_up"],))
        row["up_counts"] = [top, at_jax]
        print(f"    up parts: the port's sphere count at its winner {top:g}, at JAX's up "
              f"{at_jax:g}", flush=True)
        check(at_jax >= (1 - AXIS_TIE_FRAC) * top, f"{what}: up {up_d:.2f} deg from JAX's is "
              f"no near tie: JAX's direction holds {at_jax:g} of the winner's {top:g} votes")
        parts["near_ties"].append(what)
    check(ds <= BENCH_SCALE_RTOL, f"{what}: scale {ds:.2e} relative from JAX's")
    return row


def pose_cell_on(inputs, mode, key):
    from cppf_tpu_torch.scripts.bench_cell import pose_cell

    return pose_cell(mode, [key], inputs=inputs)[0]


def bench_cell_phase(smi):
    """Phase 21 (see the docstring).  Returns the launches of the
    nearest-splat poses (the 4 single poses and the batch's 4 rows)."""
    import dataclasses

    from cppf_tpu_torch.core import threefry
    from cppf_tpu_torch.models.convert import ASSETS
    from cppf_tpu_torch.pipeline.pose import PoseResult
    from cppf_tpu_torch.pipeline.preprocess import PreprocessedCloud
    from cppf_tpu_torch.scripts import bench_cell as bc

    t0 = time.perf_counter()
    z = np.load(os.path.join(ASSETS, BENCH_ASSET))
    inputs = bc.bench_inputs("cuda")
    pcfg = inputs.pcfg
    check(pcfg.n_pairs == 100000 and pcfg.num_rots == 72 and pcfg.knn == 60
          and pcfg.grid_shape == (120, 120, 120) and inputs.pre.pc.shape[0] == 4096,
          f"phase 21: not bench.py's cell: {pcfg}")
    check(int(inputs.pre.n_valid) == int(z["n_valid"]),
          f"phase 21: {int(inputs.pre.n_valid)} points, JAX's cloud has {int(z['n_valid'])}")
    pre_b = bc.batch_cloud(inputs.device)
    check(pre_b.n_valid.tolist() == z["batch_n_valid"].tolist(),
          f"phase 21: the batch's points {pre_b.n_valid.tolist()}, JAX's "
          f"{z['batch_n_valid'].tolist()}")

    n_near = len(bc.KEYS) + bc.BATCH
    (near, batch), near_launches = _launched(lambda: (
        bc.pose_cell("nearest", bc.KEYS, inputs=inputs),
        bc.pose_batch(0, inputs=inputs, pre_b=pre_b)))
    _peak_path_ok(near_launches, n_near, "phase 21 nearest splat")
    tri, tri_launches = _launched(lambda: bc.pose_cell("trilinear", bc.KEYS, inputs=inputs))
    _peak_path_ok(tri_launches, len(bc.KEYS), "phase 21 trilinear splat")
    print(f"phase 21: launches of the {n_near} nearest-splat poses (4 keys, the batch's 4 "
          f"rows) {near_launches}; of the 4 trilinear {tri_launches}", flush=True)

    parts, rows = {"ties": [], "near_ties": []}, []
    for mode, outs in (("nearest", near), ("trilinear", tri)):
        for i, out in enumerate(outs):
            rows.append(hold_bench_pose(f"phase 21 {mode} PRNGKey({bc.POSE_SEED + i})", out, z,
                                        f"{mode}_{i}", inputs, mode, bc.KEYS[i], parts))
    batch_keys = threefry.split(threefry.key(bc.BATCH_SEED), bc.BATCH)
    for r in range(bc.BATCH):
        row_in = inputs._replace(pre=PreprocessedCloud(*(f[r] for f in pre_b)))
        rows.append(hold_bench_pose(f"phase 21 batch row {r}", PoseResult(*(f[r] for f in batch)),
                                    z, f"batch_{r}", row_in, "nearest", batch_keys[r], parts))

    # CPU (plain versions) against CUDA (kernels), phase 9's width and rule
    cpu_in = bc.bench_inputs("cpu", BENCH_CPU_PAIRS)
    gpu_in = inputs._replace(pcfg=dataclasses.replace(pcfg, n_pairs=BENCH_CPU_PAIRS))
    cpu_cuda = {}
    for mode in bc.MODES:
        a, b = (pose_cell_on(inp, mode, bc.KEYS[0]) for inp in (cpu_in, gpu_in))
        d = {k: float((getattr(a, k) - getattr(b, k).cpu()).abs().max())
             for k in ("T", "up", "right")}
        cpu_cuda[mode] = d
        print(f"phase 21 cpu vs cuda, {mode} splat, {BENCH_CPU_PAIRS} pairs, PRNGKey("
              f"{bc.POSE_SEED}): |dT| {d['T']:.2e}, |d up| {d['up']:.2e}, |d right| "
              f"{d['right']:.2e}, survivors {int(a.n_filtered)} vs {int(b.n_filtered)}",
              flush=True)
        check(max(d.values()) < 1e-6, f"phase 21 {mode}: CPU and CUDA poses differ: {d}")
    seconds = time.perf_counter() - t0
    print(f"phase 21 ({smi}): {len(rows)} poses of bench.py's cell against JAX's stored "
          f"estimates: {len(parts['ties'])} T ties {parts['ties']}, {len(parts['near_ties'])} "
          f"up near ties {parts['near_ties']}", flush=True)
    print(json.dumps({"bench_cell": dict(poses=rows, ties=parts["ties"],
                                         near_ties=parts["near_ties"],
                                         launches=dict(nearest=near_launches,
                                                       trilinear=tri_launches),
                                         cpu_cuda=cpu_cuda, card=smi, phase_s=seconds)},
                     default=float), flush=True)
    print(smi_line(), flush=True)
    return near_launches


SPHERE_VIEWS = (("bottle", ("up",)), ("mug", ("up", "right")))


def sphere_count_phase(smi):
    """Phase 22: the axis vote's sphere count on the calls of bottle's and
    mug's view 0 (see the module's docstring); returns a record a call."""
    from cppf_tpu_torch.eval.nocs_inference import CategoryRunner
    from cppf_tpu_torch.models.convert import ASSETS
    from cppf_tpu_torch.ops import vote_hist as vh
    from cppf_tpu_torch.ops import voting
    from cppf_tpu_torch.pipeline import pose as pose_mod

    real, calls = pose_mod.rot_vote_sphere_count, []

    def capture(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    whats = []
    pose_mod.rot_vote_sphere_count = capture
    try:
        for cat, axes in SPHERE_VIEWS:
            with np.load(os.path.join(ASSETS, f"{cat}_views.npz")) as z:
                pc0 = z["pc_0"]
            before = vh.LAUNCHES["sphere_count"]
            CategoryRunner(cat).estimate(pc0)
            torch.cuda.synchronize()
            check(vh.LAUNCHES["sphere_count"] - before == len(axes),
                  f"phase 22: {cat} launched sphere_count "
                  f"{vh.LAUNCHES['sphere_count'] - before} times, not once an axis")
            whats += [f"{cat} {axis}" for axis in axes]
    finally:
        pose_mod.rot_vote_sphere_count = real
    records = []
    for (args, kwargs), what in zip(calls, whats):
        pc, angles, idxs, sphere, cos_tol = args
        n_rots, weights = kwargs["n_rots"], kwargs.get("weights")
        got = voting.rot_vote_sphere_count(*args, **kwargs)
        want = voting.rot_vote_sphere_count_plain(*args, **kwargs)
        check(torch.equal(got, want), f"phase 22: {what}: the kernel's counts are not the plain "
              f"version's ({int((got != want).sum())} of {want.numel()} directions differ)")
        pairs = voting.sphere_pair_params(pc, angles, idxs, weights)
        table, sph = voting.cone_table(n_rots, pc), sphere.float().contiguous()
        # the CUDA route's ~30 launches take the host longer than the card
        ms, route_ms, plain_ms = cuda_ms_turns([
            lambda: vh.sphere_count(pairs, table, sph, cos_tol, weighted=weights is not None),
            lambda: voting.rot_vote_sphere_count(*args, **kwargs),
            lambda: voting.rot_vote_sphere_count_plain(*args, **kwargs)], [True, True, False])
        n_pairs, n_sphere = idxs.shape[0], sphere.shape[0]
        tests = n_pairs * n_rots * n_sphere
        rec = dict(name="sphere_count", what=what, pairs=n_pairs, rotations=n_rots,
                   directions=n_sphere, tests=tests, hits=int(want.sum()), max_abs_err=0.0,
                   ms=ms, route_ms=route_ms, plain_ms=plain_ms)
        # 5 operations a test (3 products, 2 sums); the block, the table, the
        # sphere and the counts read or written once
        _set_bound(rec, "", 48 * n_pairs + 8 * n_rots + 12 * n_sphere + 4 * n_sphere, 5 * tests)
        print(f"phase 22: {what}: {n_pairs} pairs x {n_rots} x {n_sphere}, {rec['hits']} hits, "
              f"equal to the plain version; kernel {ms:.4f} ms, CUDA route {route_ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms, bound {rec['bound_ms']:.5f} ms "
              f"({rec['bound_terms']})", flush=True)
        records.append(rec)
    print(json.dumps({"sphere_count": records, "smi": smi}), flush=True)
    return records


DRAW_CELLS = (("bottle.frames", "bottle"), ("table.scans", "table"))
INT32_OPS_PER_S = FP32_OPS_PER_S / 2  # Hopper: 64 int32 lanes an SM a clock, 128 float32
# operations an element: the hash (20 rounds of add, rotate, xor; 5 key
# injections), the uniform, and a gumbel's two logf or a normal's log1pf,
# square root and polynomial
HASH_OPS, UNIFORM_OPS, TRANSFORM_OPS = 77, 6, 50


def draw_pose_config(name):
    """(PoseConfig, npoint_max) of ``portbench/configs/<name>.json``."""
    import dataclasses

    from cppf_tpu_torch.pipeline.pose import PoseConfig

    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    fields = {fl.name for fl in dataclasses.fields(PoseConfig)}
    return PoseConfig(**{k: v for k, v in cfg.items()
                         if k in fields and not isinstance(v, (list, dict))}), cfg["npoint_max"]


def draws_phase(smi):
    """Phase 23: the JAX-key draws' kernel on one pose's requests of each
    cell that draws from JAX keys (see the module's docstring); returns a
    record a cell."""
    from cppf_tpu_torch.core import threefry
    from cppf_tpu_torch.ops import cuda_build
    from cppf_tpu_torch.pipeline.pose import PoseDraws

    (ptxas,) = cuda_build.resource_usage("threefry_draws").values()
    print(f"phase 23: threefry_draws_kernel: {ptxas}", flush=True)
    check("0 bytes spill stores, 0 bytes spill loads" in ptxas, "threefry_draws spills")
    dev = torch.device("cuda")
    records = []
    for cell, name in DRAW_CELLS:
        pcfg, n_raw = draw_pose_config(name)
        pre_key, pose_key = threefry.split(threefry.key(3_141_592_653))
        pose = lambda: PoseDraws.from_jax_keys(pcfg, pre_key, pose_key, dev, n_raw)
        calls, real = [], threefry.draw_many

        def capture(requests, device):
            calls.append(requests)
            return real(requests, device)

        threefry.draw_many = capture
        try:
            before = threefry.LAUNCHES["draws"]
            got = pose()
            torch.cuda.synchronize()
            launched = threefry.LAUNCHES["draws"] - before
        finally:
            threefry.draw_many = real
        check(len(calls) == 1 and launched == 1,
              f"phase 23: {cell}: {len(calls)} draw_many calls, {launched} launches, not one")
        (reqs,) = calls
        threefry.draw_many = threefry.draw_many_plain
        try:
            want = pose()
        finally:
            threefry.draw_many = real
        fields = lambda d: [d.pair_u, d.tr_gumbel, *d.up, d.fallback_normal, d.jitter,
                            *(d.right or ())]
        for n, (g, w) in enumerate(zip(fields(got), fields(want))):
            check(torch.equal(g, w), f"phase 23: {cell}: draw {n} differs from the plain path "
                  f"in {int((g != w).sum())} of {w.numel()} elements")
        sizes = {kind: 0 for kind in ("uniform", "gumbel", "normal", "bernoulli")}
        for kind, _, shape in reqs:
            sizes[kind] += int(np.prod(shape))
        elements = sum(sizes.values())
        ms, plain_ms = cuda_ms_turns([lambda: threefry.draw_many(reqs, dev),
                                      lambda: threefry.draw_many_plain(reqs, dev)],
                                     [True, False])
        host = []
        for _ in range(TIMING_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pose()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        ops = ((HASH_OPS + UNIFORM_OPS) * elements
               + TRANSFORM_OPS * (sizes["gumbel"] + sizes["normal"]))
        rec = dict(name="threefry_draws", what=cell, requests=len(reqs), elements=elements,
                   by_kind=sizes, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                   call_host_ms=statistics.median(host), operations=ops,
                   bytes=4 * elements, int32_bound_ms=ops / INT32_OPS_PER_S * 1e3,
                   ptxas=ptxas)
        _set_bound(rec, "", 4 * elements, ops)
        print(f"phase 23: {cell}: {len(reqs)} requests, {elements} elements {sizes}, equal to "
              f"the plain path to the bit; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, a whole "
              f"from_jax_keys call {rec['call_host_ms']:.3f} ms on the host's clock; bound "
              f"{rec['bound_ms']:.5f} ms ({rec['bound_terms']}; at the int32 rate "
              f"{rec['int32_bound_ms']:.5f} ms)", flush=True)
        records.append(rec)
    print(json.dumps({"draws": records, "smi": smi}), flush=True)
    return records


def main():
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU")
    ap.add_argument("--profile", action="store_true", help="profile one warm pose")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs one GPU")
    sys.path.insert(0, ROOT)
    from cppf_tpu_torch.eval.nocs_inference import CategoryRunner
    from cppf_tpu_torch.models.convert import ASSETS
    from cppf_tpu_torch.ops import cuda_build
    from cppf_tpu_torch.ops import vote_hist as vh
    from cppf_tpu_torch.pipeline.pose import PoseDraws

    # ---- 1. card -------------------------------------------------------------
    smi = smi_line()
    device = torch.cuda.get_device_name(0)
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {device}",
          flush=True)

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    sources = sorted(os.path.basename(p)[:-3] for p in
                     glob.glob(os.path.join(ROOT, "cppf_tpu_torch", "csrc", "*.cu")))
    cuda_build.build(sources)
    print(f"build: {sources} in {time.perf_counter() - t0:.1f} s", flush=True)
    for kernel, usage in {**cuda_build.resource_usage("vote_hist"),
                          **cuda_build.resource_usage("sphere_count"),
                          **cuda_build.resource_usage("threefry_draws")}.items():
        print(f"  ptxas {kernel}: {usage}", flush=True)
        check("0 bytes spill stores, 0 bytes spill loads" in usage, f"{kernel} spills registers")

    # ---- 3. kernels against their plain versions -----------------------------
    runner = CategoryRunner("bowl")
    pcfg = runner.pcfg
    check(pcfg.n_pairs == 100000 and pcfg.num_rots == 72 and pcfg.grid_shape == (64, 64, 64)
          and runner.cfg.npoint_pad == 4096 and pcfg.knn == 60, f"not full width: {pcfg}")
    z = np.load(os.path.join(ASSETS, "bowl_views.npz"))
    n_views = int(z["n_views"])
    inp = main_path_inputs(runner, z["pc_0"], pcfg.grid_shape)
    check(inp["votes"][0].shape[0] == 7_200_000, f"V = {inp['votes'][0].shape[0]}")
    records = kernel_phase(inp, "bowl 64^3")
    kernel_phase(inp, "bowl 64^3", splat="nearest", timed=False)
    kernel_phase(main_path_inputs(runner, z["pc_0"], pcfg.grid_shape, adaptive=True),
                 "bowl 64^3, adaptive rotations", timed=False, adaptive=True)
    kernel_phase(main_path_inputs(runner, z["pc_0"], (120, 120, 120)), "bottle pooled 120^3")
    # the other categories' shapes, on their own pairs and weights
    runners = {cat: CategoryRunner(cat) for cat in OTHER_CATEGORIES}
    for cat, label, second_pass in KERNEL_SHAPES:
        other = runners[cat]
        with np.load(os.path.join(ASSETS, f"{cat}_views.npz")) as zc:
            pc0 = zc["pc_0"]
        kernel_phase(main_path_inputs(other, pc0, other.pcfg.grid_shape,
                                      second_pass=second_pass), label)

    # ---- 4. the main path on the card ----------------------------------------
    # the center-vote stage alone must allocate less than one [P, R] vector
    from cppf_tpu_torch.ops.voting import ppf_vote_peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ppf_vote_peak(*inp["peak_args"], n_rots=pcfg.num_rots, max_rounds=pcfg.peak_rounds)
    torch.cuda.synchronize()
    stage_bytes = torch.cuda.max_memory_allocated() - base
    vector_bytes = 4 * inp["votes"][0].shape[0]
    print(f"center-vote stage: peak device memory {stage_bytes / 2**20:.2f} MiB above its "
          f"inputs (one [P, R] vote vector is {vector_bytes / 2**20:.2f} MiB)", flush=True)
    check(stage_bytes < vector_bytes, "the center-vote stage made a [P, R] tensor")
    del inp

    vh.reset_launches()
    outs = [runner.estimate(z[f"pc_{i}"])[0] for i in range(n_views)]
    torch.cuda.synchronize()
    launches = dict(vh.LAUNCHES)
    print(f"main path launches over {n_views} poses: {launches}", flush=True)
    check(launches["bound_projections_pairs"] == n_views,
          f"bound_projections_pairs launched {launches['bound_projections_pairs']} times over "
          f"{n_views} poses, not once a pose")
    check(0 < launches["refine_window_pairs"] <= 2 * n_views,
          f"refine_window_pairs launched {launches['refine_window_pairs']} times over "
          f"{n_views} poses, not 1 or 2 a pose")
    check(launches["bound_projections"] == 0 and launches["refine_window"] == 0,
          "the main path built vote vectors for the votes front ends")
    check(launches["sphere_count"] == n_views * (1 + pcfg.regress_right),
          f"sphere_count launched {launches['sphere_count']} times over {n_views} poses, not "
          f"once an axis")
    errs = [errors(out, z, i) for i, out in enumerate(outs)]
    for i, (t_err, up_err, s_err, t_jax, up_jax) in enumerate(errs):
        print(f"view {i}: T err {t_err * 1e3:.2f} mm, up err {up_err:.2f} deg, scale err "
              f"{s_err * 100:.2f} %; against the JAX CPU estimate: T {t_jax * 1e3:.2f} mm, "
              f"up {up_jax:.2f} deg; back-vote survivors {int(outs[i].n_filtered)}")
    t_med = float(np.median([e[0] for e in errs]))
    up_med = float(np.median([e[1] for e in errs]))
    times = []
    for _ in range(3):
        for i in range(n_views):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, _ = runner.estimate(z[f"pc_{i}"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    print(f"main path: median T err {t_med * 1e3:.2f} mm, median up err {up_med:.2f} deg, "
          f"warm {statistics.median(times):.2f} ms/pose (median of {len(times)}, "
          f"min {min(times):.2f})", flush=True)
    check(t_med < 0.02, f"median T error {t_med * 1e3:.1f} mm >= 20 mm")
    check(up_med < 15.0, f"median up error {up_med:.1f} deg >= 15 deg")
    torch.cuda.reset_peak_memory_stats()
    runner.estimate(z["pc_0"])
    torch.cuda.synchronize()
    print(f"main path: peak device memory of one warm pose "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    if args.profile:
        stage_times(runner, z["pc_0"])
        profile_pose(runner, z["pc_0"])

    # ---- 5. CPU (plain versions) against CUDA (kernels), identical draws ----
    draws = PoseDraws.sample(pcfg, torch.Generator().manual_seed(5), "cpu",
                             n_raw=runner.cfg.npoint_max)
    out_cpu, pre_cpu = CategoryRunner("bowl", device="cpu").estimate(z["pc_1"], draws=draws)
    out_gpu, pre_gpu = runner.estimate(z["pc_1"], draws=draws.to("cuda"))
    same_pts = bool(torch.equal(pre_cpu.raw_idx, pre_gpu.raw_idx.cpu()))
    dT = float((out_cpu.T - out_gpu.T.cpu()).abs().max())
    dup = float((out_cpu.up - out_gpu.up.cpu()).abs().max())
    print(f"cpu vs cuda, identical draws: same kept points {same_pts}, |dT| {dT:.2e}, "
          f"|d up| {dup:.2e}, survivors {int(out_cpu.n_filtered)} vs "
          f"{int(out_gpu.n_filtered)}", flush=True)
    check(dT < 1e-6, "CPU and CUDA peak voxels differ")
    check(dup < 1e-6, "CPU and CUDA up directions differ")

    # ---- 6-7. dense_hist, the zero-shot path ------------------------------
    zs_z = np.load(os.path.join(ASSETS, "demo_frame.npz"))
    dense, zs_launches = zero_shot_phase(zs_z, runner.device, args.profile)
    records["dense_hist"] = dense["frame chunk, unpooled"]
    launches["dense_hist"] = zs_launches["dense_hist"]
    launches["dense_hist_pairs"] = zs_launches["dense_hist_pairs"]

    # ---- 8-9. every other category; CPU against CUDA on each ----------------
    summary = category_phase(runners)
    print(json.dumps({"categories": summary}), flush=True)
    cpu_cuda_phase(runners)

    # ---- 10. the NOCS REAL275 driver on the committed frame ------------------
    import tempfile

    t10 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        nocs_records, nocs_launches = nocs_driver_phase(tmp, args.profile)
    print(f"phase 10 (nocs driver): {time.perf_counter() - t10:.1f} s", flush=True)

    # ---- 11. the SUN RGB-D driver on the committed scans ---------------------
    t11 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        sun_records, sun_launches = sun_driver_phase(tmp, args.profile)
    print(f"phase 11 (sun driver): {time.perf_counter() - t11:.1f} s", flush=True)

    # ---- 12. supervised training of bowl at full width ------------------------
    t12 = time.perf_counter()
    train_records, train_launches = training_phase(smi, args.profile)
    print(f"phase 12 (training): {time.perf_counter() - t12:.1f} s", flush=True)

    # ---- 13. the pair-sharded pose and the data-parallel step ---------------
    t13 = time.perf_counter()
    par_records, par_launches, par_all = parallel_phase(smi)
    print(f"phase 13 (parallel): {time.perf_counter() - t13:.1f} s", flush=True)

    # ---- 14. the laptop segmenter and the driver's laptop override ----------
    t14 = time.perf_counter()
    lap_records, lap_launches = laptop_phase(smi, args.profile)
    print(f"phase 14 (laptop): {time.perf_counter() - t14:.1f} s", flush=True)

    # ---- 15. the zero-shot model: contrast validation, training, the CLI ----
    t15 = time.perf_counter()
    zs_records, zs_train_launches = zero_shot_train_phase(smi)
    print(f"phase 15 (zero-shot training and CLI): {time.perf_counter() - t15:.1f} s",
          flush=True)

    # ---- 16. the pose flags no config turns on, and their sharded forms -----
    t16 = time.perf_counter()
    flag_records, flag_launches = flags_phase(smi)
    print(f"phase 16 (pose flags): {time.perf_counter() - t16:.1f} s", flush=True)

    # ---- 17. the entry points: entry(), dryrun_multichip, pair-sharded step --
    t17 = time.perf_counter()
    entry_launches = entry_phase(smi)
    print(f"phase 17 (entry points): {time.perf_counter() - t17:.1f} s", flush=True)

    # ---- 18. the quality gauges, the checkpoint eval and the demo ----------
    t18 = time.perf_counter()
    gauge_records, gauge_launches = gauges_phase(smi)
    print(f"phase 18 (quality gauges): {time.perf_counter() - t18:.1f} s", flush=True)

    # ---- 19. the reference CPPF's .pth checkpoints ------------------------
    t19 = time.perf_counter()
    pth_launches = reference_pth_phase(smi)
    print(f"phase 19 (reference .pth checkpoints): {time.perf_counter() - t19:.1f} s",
          flush=True)

    # ---- 20. the repo's orbax checkpoints, read without JAX ------------------
    t20 = time.perf_counter()
    orbax_launches = orbax_phase(smi)
    print(f"phase 20 (orbax checkpoints): {time.perf_counter() - t20:.1f} s", flush=True)

    # ---- 21. bench.py's main cell against JAX's stored estimates ----------
    t21 = time.perf_counter()
    bench_launches = bench_cell_phase(smi)
    print(f"phase 21 (bench cell): {time.perf_counter() - t21:.1f} s", flush=True)

    # ---- 22. the axis vote's sphere count ------------------------------------
    t22 = time.perf_counter()
    sphere_records = sphere_count_phase(smi)
    print(f"phase 22 (sphere count): {time.perf_counter() - t22:.1f} s", flush=True)

    # ---- 23. the JAX-key draws ------------------------------------------------
    t23 = time.perf_counter()
    draw_records = draws_phase(smi)
    print(f"phase 23 (JAX-key draws): {time.perf_counter() - t23:.1f} s", flush=True)

    # a kernel's record is that of its pairs front end, which its path
    # launches; its votes front end, launched by no path of this run but the
    # comparisons, stands beside it under votes_ keys.  The peak kernels
    # stand six times: on bowl's main path (phase 4), on the NOCS driver's
    # frame (phase 10), on the SUN driver's scans (phase 11), in the
    # trainer's decode validation (phase 12), on one rank's shard of the
    # pair-sharded pose (phase 13: rank 0's launches on bowl, every rank's
    # by category beside them) and on the laptop frame (phase 14);
    # dense_hist twice: on the zero-shot path (phase 7) and in the zero-shot
    # trainer's contrast validation (phase 15); each with the launches of
    # its own run.  Phase 16's records are the votes front ends, which its
    # gated center passes launch (sofa's gated votes): their launches are
    # those of the votes front ends, and the pairs front ends' stand beside
    # them (the flags' ungated and grid passes)
    kernels = []
    paths = [("main path (phase 4; dense_hist: zero-shot, phase 7)", records, launches),
             ("nocs driver (phase 10)", nocs_records, nocs_launches),
             ("sun driver (phase 11)", sun_records, sun_launches),
             ("training decode-val (phase 12)", train_records, train_launches),
             ("pair-sharded pose (phase 13)", par_records, par_launches),
             ("laptop frame with the segmenter override (phase 14)", lap_records,
              lap_launches),
             ("zero-shot training's contrast validation (phase 15)", zs_records,
              zs_train_launches),
             ("pose flags, votes front ends under the half-space gate (phase 16)", flag_records,
              flag_launches),
             ("quality gauges, the checkpoint eval and the demo (phase 18)", gauge_records,
              gauge_launches)]
    for path, recs, counts in paths:
        for name, rec in recs.items():
            if rec.get("front") == "votes":
                kernels.append(dict(name=name, path=path, route="cuda", front_end="votes",
                                    source="cppf_tpu_torch/csrc/vote_hist.cu",
                                    replaces=TPU_KERNELS[name], launches=counts[name],
                                    pairs_launches=counts[name + "_pairs"],
                                    **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                                           "bound_ms", "bound_by",
                                                           "library_ms")}))
                continue
            pairs = name + "_pairs" if name + "_pairs" in counts else name
            k = dict(name=name, path=path, route="cuda",
                     source="cppf_tpu_torch/csrc/vote_hist.cu", replaces=TPU_KERNELS[name],
                     launches=counts[pairs], max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                     plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                     bound_by=rec["bound_by"], library_ms=rec["library_ms"])
            if pairs != name:
                k.update({key: rec[key] for key in ("votes_max_abs_err", "votes_ms",
                                                    "votes_plain_ms", "votes_bound_ms",
                                                    "votes_bound_by")},
                         votes_launches=counts[name])
            if recs is par_records:
                k["launches_per_rank"] = {cat: [c[pairs] for c in ranks]
                                          for cat, ranks in par_all.items()}
            kernels.append(k)
    # entry() launches the pairs front ends of the peak kernels (phase 17);
    # the poses and the CLI on .pth weights all three (phase 19); the laptop
    # frame served from the committed orbax checkpoints the peak kernels
    # (phase 20); the bench cell's nearest-splat poses the peak kernels
    # (phase 21)
    for k in kernels:
        if k["path"].startswith("main path") and k["name"] != "dense_hist":
            k["entry_launches"] = entry_launches[k["name"] + "_pairs"]
        if k["path"].startswith("main path"):
            k["reference_pth_launches"] = pth_launches.get(k["name"] + "_pairs", 0)
            k["orbax_laptop_frame_launches"] = orbax_launches.get(k["name"] + "_pairs", 0)
            k["bench_cell_nearest_launches"] = bench_launches.get(k["name"] + "_pairs", 0)
    # the sphere count replaces no TPU kernel: bottle's up vote stands for it,
    # with the main path's launches (phase 4)
    kernels.append(dict(sphere_records[0], path="main path (phase 4; timed in phase 22)",
                        route="cuda", source="cppf_tpu_torch/csrc/sphere_count.cu",
                        replaces=None, launches=launches["sphere_count"]))
    # nor do the draws: the frames driver's poses (phase 10) stand for
    # bottle.frames, the scans driver's (phase 11) for table.scans, each with
    # the launches counted over its run of main; timed in phase 23
    driver_draws = {"bottle.frames": ("main path: nocs driver (phase 10; timed in phase 23)",
                                      nocs_launches),
                    "table.scans": ("main path: sun driver (phase 11; timed in phase 23)",
                                    sun_launches)}
    for rec in draw_records:
        path, counts = driver_draws[rec["what"]]
        kernels.append(dict(rec, path=path, route="cuda",
                            source="cppf_tpu_torch/csrc/threefry_draws.cu", replaces=None,
                            launches=counts["draws"], poses=counts["poses"]))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
