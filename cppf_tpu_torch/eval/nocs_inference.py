"""NOCS REAL275 inference driver (counterpart of cppf_tpu/eval/nocs_inference.py).

Reads Mask-RCNN detection priors (``results_*.pkl``), backprojects each
instance's masked depth, groups a frame's crops by category, runs each group
through :meth:`CategoryRunner.estimate_batch` (or :meth:`~CategoryRunner.estimate`
one instance at a time for singletons and laptop), and writes per-frame result
pkls in the reference format (``pred_RTs`` with the R·|s| convention,
``pred_scales`` unit-normalised), which ``cppf_tpu_torch.eval.nocs_eval``
scores with the NOCS mAP protocol.

With a segmenter under ``<ckpt_path>/laptop_aux`` a laptop is posed twice,
as the JAX driver poses it (:func:`pose_laptop`): the segmenter splits the
instance's colour crop into lid and base, a RANSAC plane through the base
points oriented toward the camera gives the up axis, and the second pose
overrides its up axis with it.

The random draws follow the JAX driver's key schedule (core/threefry.py), so
with the same ``--seed`` the port meets the draws the JAX driver met.

Usage:
    python -m cppf_tpu_torch.eval.nocs_inference --seg_dir ... --nocs_dir ... \\
        --out_dir ... --ckpt_path checkpoints [--bbox_mask] [--device cpu]
"""
from __future__ import annotations

import argparse
import glob
import logging
import os
import pickle
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from cppf_tpu_torch.config import REPO_ROOT, load_config
from cppf_tpu_torch.core import threefry
from cppf_tpu_torch.core.geometry import backproject
from cppf_tpu_torch.data.laptop_aux import CROP, resized_idxs
from cppf_tpu_torch.data.png import read_png
from cppf_tpu_torch.data.resize import resize_linear
from cppf_tpu_torch.device import pin_float32, resolve_device
from cppf_tpu_torch.eval.anchor import anchor_box_t
from cppf_tpu_torch.models.convert import load_encoders
from cppf_tpu_torch.models.segmenter import SegmenterRunner
from cppf_tpu_torch.ops.ransac import segment_plane
from cppf_tpu_torch.pipeline.pose import PoseConfig, PoseDraws, estimate_pose, up_prior_gate
from cppf_tpu_torch.pipeline.preprocess import preprocess_cloud
from cppf_tpu_torch.train.checkpoints import maybe_load_any
from cppf_tpu_torch.utils import prof

SYNSET_NAMES = ["BG", "bottle", "bowl", "camera", "can", "laptop", "mug"]

# NOCS REAL275 camera (reference nocs/inference.py:98)
REAL275_INTRINSICS = np.array([[591.0125, 0, 322.525], [0, 590.16775, 244.11084], [0, 0, 1]])

# Inference-only flags overlaid from the repo's category config onto the
# training-time snapshot, as the JAX runner does (nocs_inference.py:76-83).
OVERLAY = ("asym_right_votes", "asym_center_refine", "subvoxel_refine", "geo_right_sign",
           "geo_right_dir", "filter_coplanar", "coplanar_halfspace", "pair_balance",
           "pair_sep_power", "sharp_axis_votes", "aux_align_weight", "axis_topk",
           "pose_f32", "anchor_t")

# the laptop override's base plane (cppf_tpu/eval/nocs_inference.py:222-230)
LAPTOP_MIN_BASE = 10
LAPTOP_PLANE_PAD = 4096
LAPTOP_PLANE_TOL = 0.02
LAPTOP_PLANE_ITERS = 100

log = logging.getLogger("cppf_tpu_torch.nocs")


def load_detection_priors(seg_dir: str):
    pkls = sorted(glob.glob(os.path.join(seg_dir, "results_*.pkl")))
    if not pkls:
        raise FileNotFoundError(f"no detection pkls under {seg_dir}")
    results = []
    for p in pkls:
        with open(p, "rb") as f:
            r = pickle.load(f)
        if "gt_handle_visibility" not in r:
            r["gt_handle_visibility"] = np.ones_like(r["gt_class_ids"])
        results.extend(r if isinstance(r, list) else [r])
    return results


def _pad_cloud(pc_raw: np.ndarray, n_raw_pad: int):
    """(cloud padded or stride-subsampled to ``n_raw_pad`` points, real
    points).  A backprojected cloud is in scanline order, so truncation
    would keep only the top image rows of a large object; an even stride
    keeps its whole extent."""
    pad = np.zeros((n_raw_pad, 3), np.float32)
    n_raw = min(len(pc_raw), n_raw_pad)
    if len(pc_raw) > n_raw_pad:
        pad[:] = pc_raw[np.linspace(0, len(pc_raw) - 1, n_raw_pad).astype(int)]
    else:
        pad[:n_raw] = pc_raw[:n_raw]
    return pad, n_raw


def served_weights(cls_name: str, path: str) -> dict:
    """The params tree a runner serves for ``cls_name`` from the checkpoint
    directory ``path``, in the JAX runner's order of names: ``params_best``,
    then ``best`` (the upstream release's pair), each as
    ``train/checkpoints.maybe_load_any`` reads a name: the orbax directory
    ``<name>/`` (the repo's ``checkpoints/<cls_name>/params_best``), else
    ``<name>.npz``, else the reference pair ``point_encoder_epoch<name>.pth``
    + ``ppf_encoder_epoch<name>.pth``.  Raises ``FileNotFoundError``
    otherwise."""
    for name in ("params_best", "best"):
        params = maybe_load_any(path, name)
        if params is not None:
            return params
    raise FileNotFoundError(
        f"no params_best/ or best/ (orbax), params_best.npz, best.npz or reference pair "
        f"point_encoder_epoch<name>.pth + ppf_encoder_epoch<name>.pth (<name> params_best "
        f"or best) for {cls_name} under {path}")


class CategoryRunner:
    """Config, weights and pipeline for one category.

    The config is the training-time snapshot ``<ckpt_path>/<cls>/config.yaml``
    when present, else the layered repo config, with the repo config's
    inference flags overlaid.  The weights are those of ``ckpt_name`` under
    ``<ckpt_path>/<cls>`` when it is given (the orbax directory
    ``<ckpt_name>/``, else ``<ckpt_name>.npz``, else the reference pair
    ``point_encoder_epoch<ckpt_name>.pth`` +
    ``ppf_encoder_epoch<ckpt_name>.pth``), else :func:`served_weights`'
    (``params_best``, then ``best``).  A directory without them raises
    ``FileNotFoundError``, as the JAX runner raises on a directory without
    weights.
    Runs on ``cuda`` unless ``device`` says otherwise.
    """

    def __init__(self, cls_name: str, device=None, num_rots: int = 72, angle_prec: float = 1.5,
                 adaptive_voting: bool = False, ckpt_path: Optional[str] = None,
                 ckpt_name: Optional[str] = None):
        self.device = resolve_device(device)
        pin_float32()
        path = (os.path.join(ckpt_path, cls_name) if ckpt_path
                else os.path.join(REPO_ROOT, "checkpoints", cls_name))
        if ckpt_name:
            params = maybe_load_any(path, ckpt_name)
            if params is None:
                raise FileNotFoundError(f"no {ckpt_name}/ (orbax), {ckpt_name}.npz or "
                                        f"reference pair of {ckpt_name} for {cls_name} under "
                                        f"{path}")
        else:
            params = served_weights(cls_name, path)
        snap = os.path.join(path, "config.yaml")
        self.cfg = load_config(cls_name, snapshot=snap if os.path.exists(snap) else None)
        self.cfg.num_rots = num_rots
        self.cfg.angle_prec = angle_prec
        self.cfg.adaptive_voting = adaptive_voting
        repo_cfg = load_config(cls_name)
        for k in OVERLAY:
            setattr(self.cfg, k, getattr(repo_cfg, k))
        self.pcfg = PoseConfig.from_config(self.cfg, scale_multiplier=2.0)
        self.sphere = torch.from_numpy(self.pcfg.sphere_points()).to(self.device)
        self.point_encoder, self.ppf_encoder = load_encoders(params, self.cfg.out_dim,
                                                             self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        self._up_gate = None

    def up_gate(self):
        """The up vote's gravity gate (``pipeline/pose.py::up_prior_gate``) of
        the runner's sphere and prior, made at the first pose and again only
        when the prior changes: no pose uploads the prior.  None while the
        prior is off."""
        key = (self.pcfg.up_prior_deg, self.pcfg.up_prior_dir)
        if self._up_gate is None or self._up_gate[0] != key:
            self._up_gate = (key, up_prior_gate(self.sphere, self.pcfg))
        return self._up_gate[1]

    def draws(self, key) -> PoseDraws:
        """The draws the JAX ``estimate(key, ...)`` consumes."""
        return PoseDraws.from_jax_key(self.pcfg, key, self.device, n_raw=self.cfg.npoint_max)

    @torch.no_grad()
    def estimate(self, pc_raw: np.ndarray, generator: Optional[torch.Generator] = None,
                 draws: Optional[PoseDraws] = None, laptop_up=None):
        """Pose of one raw cloud [M, 3].  Draws come from ``draws`` (which
        must then carry ``jitter`` [npoint_max, 3]) or from ``generator``
        (default: the runner's own, seeded with 0 at construction).
        ``laptop_up`` [3], the base-plane normal oriented toward the camera,
        turns on the laptop plane override.
        Returns (PoseResult, PreprocessedCloud)."""
        with prof.span("pose", points=len(pc_raw)):
            if draws is None:
                draws = PoseDraws.sample(self.pcfg, generator or self.generator, self.device,
                                         n_raw=self.cfg.npoint_max)
            pre = self.preprocess(pc_raw, draws, generator)
            if laptop_up is not None:
                laptop_up = torch.as_tensor(np.asarray(laptop_up, np.float32),
                                            device=self.device)
                prof.host_sync(self.device)
            out = estimate_pose(self.point_encoder, self.ppf_encoder, pre.pc, pre.normals,
                                pre.n_valid, self.sphere, self.pcfg, nbr_idx=pre.nbr_idx,
                                draws=draws, laptop_up=laptop_up, up_gate=self.up_gate())
            if self.cfg.anchor_t:
                out = self._anchor(out, pc_raw)
            return out, pre

    def preprocess(self, pc_raw: np.ndarray, draws: PoseDraws,
                   generator: Optional[torch.Generator] = None):
        """The preprocessed cloud that :meth:`estimate` poses: ``pc_raw``
        padded or stride-subsampled to ``npoint_max``, with the jitter of
        ``draws``."""
        cfg = self.cfg
        with prof.span("pose.preprocess"):
            pad, n_raw = _pad_cloud(pc_raw, cfg.npoint_max)
            prof.host_sync(self.device)  # the upload of the padded cloud
            return preprocess_cloud(torch.from_numpy(pad).to(self.device), n_raw, cfg.res,
                                    npoint_pad=cfg.npoint_pad, knn=cfg.knn, noise=draws.jitter,
                                    generator=generator or self.generator)

    def _anchor(self, out, pc_raw: np.ndarray):
        """Host post-step of ``cfg.anchor_t``: observed-extent anchoring of
        the voted center (eval/anchor.py), written into T and RT's
        translation column."""
        prof.host_sync(out.T.device, n=4)  # three reads and the upload of T
        scale = out.scale.cpu().numpy().astype(np.float64)
        s_norm = float(np.linalg.norm(scale))
        T_new = anchor_box_t(out.T.cpu().numpy(), out.R.cpu().numpy(), scale,
                             np.asarray(pc_raw), clip=max(0.05, 0.15 * s_norm))
        T = torch.as_tensor(T_new.astype(np.float32), device=out.T.device)
        RT = out.RT.clone()
        RT[:3, 3] = T
        return out._replace(T=T, RT=RT)

    @torch.no_grad()
    def estimate_batch(self, pc_list, key, pad_to: Optional[int] = None):
        """Poses of a frame's crops of this category, on the draws the JAX
        ``estimate_batch(key, pc_list, pad_to)`` meets: ``key`` split into
        ``2·B_pad`` keys, row i preprocessed on key i and posed on key
        ``B_pad + i`` (B_pad = ``pad_to``, default the next power of two).
        The rows run one after another, as JAX's ``lax.map`` runs them; JAX
        also runs the padding rows (copies of instance 0) to fix its
        compiled shapes and drops them: here they are not run.  Returns
        (PoseResult, PreprocessedCloud) stacked over the ``len(pc_list)``
        real rows."""
        B = len(pc_list)
        B_pad = pad_to if pad_to is not None else 1 << (B - 1).bit_length()
        if not 0 < B <= B_pad:
            raise ValueError(f"{B} instances do not fit a batch of {B_pad}")
        keys = threefry.split((int(key[0]), int(key[1])), 2 * B_pad)
        rows = [self.estimate(pc, draws=PoseDraws.from_jax_keys(
                    self.pcfg, keys[i], keys[B_pad + i], self.device, n_raw=self.cfg.npoint_max))
                for i, pc in enumerate(pc_list)]
        return tuple(type(r[0])(*(torch.stack(f) for f in zip(*r))) for r in zip(*rows))


class Chunk(NamedTuple):
    """One pose call of the driver: a category's batched chunk, or one
    instance run alone; seconds include the copy of its poses to the host."""
    category: str
    instances: int
    batched: bool
    seconds: float


def frame_masks(res: dict, bbox_mask: bool = False) -> np.ndarray:
    """The instance masks [H, W, n] the crops are cut with: the detections'
    masks, each joined with its box under ``bbox_mask``."""
    masks = res["pred_masks"].copy()
    if bbox_mask:
        for i, bbox in enumerate(res["pred_bboxes"]):
            masks[:, :, i][bbox[0]:bbox[2], bbox[1]:bbox[3]] = True
    return masks


def frame_crops(depth: np.ndarray, res: dict, runners: dict, bbox_mask: bool = False):
    """A frame's instance clouds grouped by category, in the order the frame
    first meets each category: {category: [(instance index, cloud [M, 3])]}.
    Clouds are in meters in the camera frame; instances of a category
    without a runner and crops under 20 points are left out."""
    masks = frame_masks(res, bbox_mask)
    groups: dict = {}
    for i in range(len(res["pred_bboxes"])):
        cls_name = SYNSET_NAMES[res["pred_class_ids"][i]]
        if runners.get(cls_name) is None:
            continue
        pc, _ = backproject(depth, REAL275_INTRINSICS, masks[:, :, i])
        # backproject negates x and y; the reference driver negates them again
        pc = pc / 1000.0
        pc[:, 0] = -pc[:, 0]
        pc[:, 1] = -pc[:, 1]
        if len(pc) < 20:
            continue
        groups.setdefault(cls_name, []).append((i, pc.astype(np.float32)))
    return groups


def laptop_crop(img: np.ndarray, mask_idxs):
    """The segmenter's input for one instance: its masked colour pixels
    (``img`` [H, W, 3] uint8 RGB) in [0, 1], the mask's bounding box cut
    out and resized to 224² as ``cv2.resize`` does (``data/resize.py``).
    Returns (crop [224, 224, 3] float32, each mask pixel's (row, col) in the
    crop [n, 2], the box [[row min, max], [col min, max]])."""
    rows, cols = mask_idxs
    bbox = np.array([[rows.min(), rows.max()], [cols.min(), cols.max()]])
    rgb_obj = np.zeros(img.shape, np.float32)
    rgb_obj[rows, cols] = img[rows, cols] / 255.0
    crop = resize_linear(rgb_obj[bbox[0, 0]:bbox[0, 1] + 1, bbox[1, 0]:bbox[1, 1] + 1],
                         (CROP, CROP))
    return crop, resized_idxs(rows, cols, bbox), bbox


def laptop_up_from_labels(pred: np.ndarray, idxs_resized: np.ndarray, pc: np.ndarray, pre,
                          r_plane) -> Optional[np.ndarray]:
    """The laptop's up axis from the segmenter's labels ``pred`` [224, 224]
    (0 base, 1 lid): the label of each kept point ``pc`` [n, 3] (the
    preprocessed cloud's valid rows, found in the crop through
    ``pre.raw_idx``), a RANSAC plane through the first 4096 base points on
    the uniforms JAX's ``segment_plane`` draws from the key ``r_plane``,
    its normal turned toward the camera.  None under 10 base points.
    The plane is a host step, as in the JAX driver, on ``pc``'s numpy
    rows."""
    keep = pre.raw_idx[: len(pc)].cpu().numpy()
    pc_img = idxs_resized[keep]
    base = pc[pred[pc_img[:, 0], pc_img[:, 1]] == 0]
    if len(base) < LAPTOP_MIN_BASE:
        return None
    n = min(len(base), LAPTOP_PLANE_PAD)
    pad = torch.zeros(LAPTOP_PLANE_PAD, 3)
    pad[:n] = torch.from_numpy(np.asarray(base[:n], np.float32))
    u = threefry.draw_many([("uniform", r_plane, (LAPTOP_PLANE_ITERS, 3))], "cpu")[0]
    plane, _ = segment_plane(u, pad, LAPTOP_PLANE_TOL, torch.arange(LAPTOP_PLANE_PAD) < n)
    normal = plane[:3].numpy()
    # the RANSAC normal's sign is arbitrary; the camera at the origin sees
    # the top of the base, so the up normal has n·p < 0 on its points
    if float(normal @ base[:n].mean(0)) > 0:
        normal = -normal
    return normal


class LaptopFrame(NamedTuple):
    """What the laptop override needs of a frame: the segmenter (or the
    ``FileNotFoundError`` of a ``laptop_aux`` directory without its
    weights, raised at the first laptop), the colour image [H, W, 3] uint8
    RGB (None with no segmenter) and the masks the crops were cut with."""
    segmenter: object
    img: Optional[np.ndarray]
    masks: np.ndarray


def pose_laptop(runner: CategoryRunner, laptop: LaptopFrame, i: int, pc: np.ndarray,
                r_inst, r_plane):
    """Instance ``i``, a laptop, in the JAX driver's order: posed on the
    draws of ``r_inst``; its up axis from the segmenter's labels of its
    crop (:func:`laptop_up_from_labels` on ``r_plane``); where there is
    one, posed again on the same draws with it as ``laptop_up``.
    Returns (PoseResult, the up axis or None)."""
    if isinstance(laptop.segmenter, FileNotFoundError):
        raise laptop.segmenter
    draws = runner.draws(r_inst)
    out, pre = runner.estimate(pc, draws=draws)
    crop, idxs, _ = laptop_crop(laptop.img, np.where(laptop.masks[:, :, i]))
    n = int(pre.n_valid)
    up = laptop_up_from_labels(laptop.segmenter.predict(crop), idxs,
                               pre.pc[:n].cpu().numpy(), pre, r_plane)
    if up is not None:
        out, _ = runner.estimate(pc, draws=draws, laptop_up=up)
    return out, up


def load_segmenter(ckpt_path: str, device=None):
    """The laptop segmenter of ``<ckpt_path>/laptop_aux`` (its orbax
    ``params_best/``, else ``params_best.npz``: ``SegmenterRunner``); the
    ``FileNotFoundError`` itself where the directory holds no weights, for
    :func:`pose_laptop` to raise; None without the directory."""
    aux_dir = os.path.join(ckpt_path, "laptop_aux")
    if not os.path.isdir(aux_dir):
        return None
    try:
        return SegmenterRunner(aux_dir, device=device)
    except FileNotFoundError as e:
        return e


def infer_frame(groups: dict, n_instances: int, runners: dict, rng, serial: bool = False,
                max_batch: int = 4, laptop: Optional[LaptopFrame] = None):
    """Poses of one frame's groups (:func:`frame_crops`), on the JAX
    driver's key schedule from ``rng``; laptops through :func:`pose_laptop`
    when ``laptop`` is given.  Rows of instances that were not posed keep
    the identity RT and unit scales.
    Returns (RTs [n, 4, 4], scales [n, 3], the next rng, [Chunk])."""
    with prof.span("frame", instances=n_instances):
        RTs = np.tile(np.eye(4, dtype=np.float32), (n_instances, 1, 1))
        scales = np.ones((n_instances, 3), dtype=np.float32)
        chunks = []

        def timed(cls_name, n, batched, fn):
            t0 = time.perf_counter()
            out = fn()
            prof.host_sync(out.RT.device, n=2)  # the copies below
            RT, sc = out.RT.cpu().numpy(), out.scale_unit.cpu().numpy()
            chunks.append(Chunk(cls_name, n, batched, time.perf_counter() - t0))
            return RT, sc

        for cls_name, items in groups.items():
            runner = runners[cls_name]
            if not serial and cls_name != "laptop" and len(items) > 1:
                for k in range(0, len(items), max_batch):
                    chunk = items[k:k + max_batch]
                    rng, r_chunk = threefry.split(rng)
                    # the next power of two, as the JAX driver buckets its shapes
                    pad_to = 1 << (len(chunk) - 1).bit_length()
                    RT, sc = timed(cls_name, len(chunk), True, lambda: runner.estimate_batch(
                        [pc for _, pc in chunk], r_chunk, pad_to=pad_to)[0])
                    for b, (i, _) in enumerate(chunk):
                        RTs[i], scales[i] = RT[b], sc[b]
                continue
            for i, pc in items:
                rng, r_inst, r_plane = threefry.split(rng, 3)
                if cls_name == "laptop" and laptop is not None:
                    RTs[i], scales[i] = timed(cls_name, 1, False, lambda: pose_laptop(
                        runner, laptop, i, pc, r_inst, r_plane)[0])
                else:
                    RTs[i], scales[i] = timed(cls_name, 1, False, lambda: runner.estimate(
                        pc, draws=runner.draws(r_inst))[0])
        prof.annotate(chunks=len(chunks))
        return RTs, scales, rng, chunks


def load_runners(args) -> dict:
    """{category: CategoryRunner} of the NOCS categories that have a
    checkpoint under ``args.ckpt_path``."""
    runners = {}
    for cls_name in SYNSET_NAMES[1:]:
        try:
            runners[cls_name] = CategoryRunner(
                cls_name, device=args.device, num_rots=args.num_rots,
                angle_prec=args.angle_prec, adaptive_voting=args.adaptive_voting,
                ckpt_path=args.ckpt_path)
        except FileNotFoundError as e:
            log.warning("skipping %s: %s", cls_name, e)
    return runners


def result_path(out_dir: str, res: dict) -> str:
    return os.path.join(out_dir,
                        "results_" + "_".join(res["image_path"].split("/")[1:]) + ".pkl")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="NOCS REAL275 inference: detection priors → result pkls. A category "
        "runs with the config.yaml snapshot of <ckpt_path>/<cat> and the first weights "
        "found there of params_best, then best: the orbax directory <name>/ that the JAX "
        "package writes, else <name>.npz, else the reference CPPF's pair "
        "point_encoder_epoch<name>.pth + ppf_encoder_epoch<name>.pth (the upstream "
        "release's layout is <ckpt_path>/<cat>/{point,ppf}_encoder_epochbest.pth). A "
        "category without weights is skipped. With <ckpt_path>/laptop_aux (its orbax "
        "params_best/ or params_best.npz) laptops take the segmenter's up axis.")
    ap.add_argument("--seg_dir", default="data/nocs_seg")
    ap.add_argument("--nocs_dir", default="data/nocs")
    ap.add_argument("--out_dir", default="data/nocs_prediction")
    ap.add_argument("--ckpt_path", default="checkpoints",
                    help="one directory a category, <ckpt_path>/<cat>: its config.yaml and "
                         "params_best/ (orbax) or params_best.npz, or the reference's "
                         "{point,ppf}_encoder_epochbest.pth")
    ap.add_argument("--angle_prec", type=float, default=1.5)
    ap.add_argument("--num_rots", type=int, default=72)
    ap.add_argument("--bbox_mask", action="store_true")
    ap.add_argument("--adaptive_voting", action="store_true")
    ap.add_argument("--max_frames", type=int, default=0, help="0 = all")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--serial", action="store_true",
                    help="reference-style per-instance loop (no batching)")
    ap.add_argument("--max_batch", type=int, default=4,
                    help="cap instances per batched pose call")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; never falls back to the CPU)")
    return ap


def main(argv=None):
    """Runs the driver; returns the [Chunk] lists of the frames, in order."""
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    final_results = load_detection_priors(args.seg_dir)
    if args.max_frames:
        final_results = final_results[: args.max_frames]
    runners = load_runners(args)
    segmenter = load_segmenter(args.ckpt_path, args.device) if "laptop" in runners else None
    rng = threefry.key(args.seed)
    frames = []
    for res in final_results:
        path = os.path.join(args.nocs_dir, res["image_path"][5:])
        depth = read_png(path + "_depth.png")
        groups = frame_crops(depth, res, runners, args.bbox_mask)
        laptop = None
        if segmenter is not None:
            # the colour image serves only the segmenter
            img = (read_png(path + "_color.png")[:, :, :3]
                   if isinstance(segmenter, SegmenterRunner) else None)
            laptop = LaptopFrame(segmenter, img, frame_masks(res, args.bbox_mask))
        res["pred_RTs"], res["pred_scales"], rng, chunks = infer_frame(
            groups, len(res["pred_bboxes"]), runners, rng, args.serial, args.max_batch,
            laptop)
        frames.append(chunks)
        out_path = result_path(args.out_dir, res)
        with open(out_path, "wb") as f:
            pickle.dump(res, f)
        log.info("wrote %s (%s)", out_path, ", ".join(
            f"{c.category} x{c.instances}{' batched' if c.batched else ''} "
            f"{c.seconds * 1e3:.1f} ms" for c in chunks))
    return frames


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, force=True)
    main()
