"""Which axes of the category cell part from JAX's, and why: near-ties or
faults.

Runs the port's ``CategoryRunner(cat).estimate`` on the CPU at full width
on every committed view of the 11 categories besides bowl
(``assets/<cat>_views.npz``), each on the draws of its stored JAX run
(``PoseDraws.from_jax_key``), and compares its up axis (and its right axis
where the category regresses one) with the stored JAX estimate.  Where an
axis lands a sphere point or more from JAX's, it runs JAX's runner on the
same view and key and prints, for that axis vote of both packages: the
back-vote survivors, whether the subsampled pairs and their decoded angle
bins are the same, both packages' sphere counts (``rot_vote_sphere_count``,
recorded in both pipelines) at both winners (the sphere directions
nearest each package's axis, up to the aux-bit sign) and how far the two
count vectors part.

The verdict, first cause first:
- "back-vote flip": the survivors differ, the port's axis meets JAX's
  when its back-vote is handed JAX's survivors, and each disagreeing pair
  is explained by rounding: its translation decodes differ and the port's
  Gumbel noise on JAX's logits decodes JAX's bins (the PPF head's float32
  logits differ between the packages; the largest difference on those
  pairs is printed), or its circle sample sits on the threshold (it flips
  within tol·(1 ± 1e-5)).  The axis subsample inverts its uniforms through
  the survivors' CDF, so one pair more or less shifts which pairs vote
  after it, and the sphere counts part by far more than the vote's own
  rounding;
- "subsample rounding": the same survivors, but the axis's pair weights
  (a float CDF) send some subsample draws to a neighbouring pair: each
  such draw lies within 1e-5 of the total weight of a CDF step;
- "decode flip": the same pairs, but some decode another angle bin;
- "near-tie": the same inputs, the count vectors within the pinned bound
  (at most 2 % of the bins apart, each by one: XLA's and torch's float32
  trigonometry, tests/test_torch_voting.py::
  test_rot_vote_sphere_count_counts_equal) and each package's margin of
  its winner over the other's within it (their sum at most 2);
- "same winner": the counts agree on the line; the aux-bit sign (or a
  right axis made orthonormal to another up) sets the rest;
- "follows the up axis": a right axis voted after an up axis that parted;
- "FAULT": anything else.  The script then exits with 1.

Usage (needs JAX; CPU; ~25 min):
    python scripts/category_near_ties.py [--categories mug laptop ...]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CATEGORIES = ("bottle", "can", "camera", "mug", "laptop", "sofa", "chair", "bed", "table",
              "bookshelf", "bathtub")
COUNT_BINS_FRAC = 0.02   # the pinned bound: at most 2 % of the bins differ ...
COUNT_STEP = 1           # ... each by at most one count
EDGE_REL = 1e-5          # a back-vote or subsample decision this close to its edge is rounding


def _angle(a, b):
    return float(np.degrees(np.arccos(np.clip(np.dot(a, b), -1, 1))))


def _winner(sphere, axis):
    return int(np.argmax(np.abs(sphere @ axis)))


def _numpy(t):
    return None if t is None else t.detach().cpu().numpy().copy()


def _record_port(rec):
    """Records each call of the port's pose into ``rec``: the translation
    decode's logits and Gumbel noise, each back-vote (its arguments and
    survivors), each axis subsample (its mask, weights, uniforms, result)
    and each sphere count (angles, pair points, counts).
    ``rec["replace"]`` {back-vote call: mask} hands a call other survivors."""
    import torch

    from cppf_tpu_torch.pipeline import pose

    real = {k: getattr(pose, k) for k in ("rot_vote_sphere_count", "backvote",
                                          "decode_translation", "_axis_subsample")}

    def decode_translation(preds, tr_gumbel, pcfg):
        bins = pcfg.tr_num_bins
        rec["logits"] = _numpy(preds[:, : 2 * bins].reshape(-1, 2, bins))
        rec["gumbel"] = _numpy(tr_gumbel.permute(1, 0, 2))
        return real["decode_translation"](preds, tr_gumbel, pcfg)

    def backvote(*a, **k):
        off, mask = real["backvote"](*a, **k)
        n = len(rec["back"])
        if n in rec["replace"]:
            mask = torch.from_numpy(rec["replace"][n]).to(mask.device)
        rec["back"].append((a, k, _numpy(mask)))
        return off, mask

    def axis_subsample(pair_mask, pair_weights, sub_u):
        sub = real["_axis_subsample"](pair_mask, pair_weights, sub_u)
        rec["sub"].append(tuple(_numpy(t) for t in (pair_mask, pair_weights, sub_u, sub)))
        return sub

    def rot_vote_sphere_count(pc, angles, idxs, *a, **k):
        out = real["rot_vote_sphere_count"](pc, angles, idxs, *a, **k)
        rec["votes"].append(tuple(_numpy(t) for t in (angles, idxs, out)))
        return out

    for name, fn in (("decode_translation", decode_translation), ("backvote", backvote),
                     ("_axis_subsample", axis_subsample),
                     ("rot_vote_sphere_count", rot_vote_sphere_count)):
        setattr(pose, name, fn)


def _record_jax(rec):
    """The same of JAX's pose (the PPF head's predictions, each back-vote's
    decoded translations and survivors, each sphere count), through
    ordered debug callbacks."""
    import jax

    from cppf_tpu.pipeline import pose

    real = {k: getattr(pose, k) for k in ("pair_predictions", "backvote",
                                          "rot_vote_sphere_count")}

    def keep(key):
        return lambda *t: rec[key].append(tuple(np.asarray(x).copy() for x in t))

    def pair_predictions(*a, **k):
        point_idxs, preds = real["pair_predictions"](*a, **k)
        jax.debug.callback(keep("preds"), preds, ordered=True)
        return point_idxs, preds

    def backvote(pc, preds_tr, *a, **k):
        off, mask = real["backvote"](pc, preds_tr, *a, **k)
        jax.debug.callback(keep("back"), preds_tr, mask, ordered=True)
        return off, mask

    def rot_vote_sphere_count(pc, angles, idxs, *a, **k):
        out = real["rot_vote_sphere_count"](pc, angles, idxs, *a, **k)
        jax.debug.callback(keep("votes"), angles, idxs, out, ordered=True)
        return out

    for name, fn in (("pair_predictions", pair_predictions), ("backvote", backvote),
                     ("rot_vote_sphere_count", rot_vote_sphere_count)):
        setattr(pose, name, fn)


def _survivor_flips(rec_t, rec_j, pcfg):
    """The survivors of the last back-vote that the packages disagree on:
    (how many; how many decode other translation bins that the port's
    Gumbel noise on JAX's logits reproduces, and the largest logit
    difference on those pairs; how many sit on the threshold)."""
    import torch

    from cppf_tpu_torch.ops.voting import backvote

    (args, kw, mask_t), (preds_j, mask_j) = rec_t["back"][-1], rec_j["back"][-1]
    pc, preds_tr, idxs, corner, res, dims, center, tol = args
    flipped = np.nonzero(mask_t != mask_j)[0]
    if not len(flipped):
        return 0, 0, 0.0, 0
    bins = pcfg.tr_num_bins
    v0, v1 = pcfg.vote_range
    logits_j = rec_j["preds"][0][0][:, : 2 * bins].reshape(-1, 2, bins)[flipped]
    idx = np.argmax(logits_j + rec_t["gumbel"][flipped], -1)
    remade = np.stack([idx[:, 0].astype(np.float32) / (bins - 1) * 2 * v0 - v0,
                       idx[:, 1].astype(np.float32) / (bins - 1) * v1], -1)
    other = (_numpy(preds_tr)[flipped] != preds_j[flipped]).any(-1)
    by_logits = other & np.isclose(remade, preds_j[flipped], rtol=0, atol=1e-6).all(-1)
    d_logit = (float(np.abs(rec_t["logits"][flipped] - logits_j)[by_logits].max())
               if by_logits.any() else 0.0)
    sel = torch.from_numpy(flipped)
    with torch.no_grad():
        lo, hi = (backvote(pc, preds_tr[sel], idxs[sel], corner, res, dims, center,
                           tol * f, **kw)[1] for f in (1 - EDGE_REL, 1 + EDGE_REL))
    return len(flipped), int(by_logits.sum()), d_logit, int((lo != hi).sum())


def _subsample_rounding(sub_rec, differ):
    """How many of the subsample draws at positions ``differ`` lie within
    ``EDGE_REL`` of the total weight of a step of the float64 CDF."""
    mask, weights, u, _ = sub_rec
    keep = (mask | ~mask.any()).astype(np.float64)
    if weights is not None:
        keep = keep * weights
    cdf = np.cumsum(keep)
    x = u[differ].astype(np.float64) * cdf[-1]
    pos = np.clip(np.searchsorted(cdf, x), 1, len(cdf) - 1)
    gap = np.minimum(np.abs(cdf[pos] - x), np.abs(cdf[pos - 1] - x))
    return int((gap <= EDGE_REL * cdf[-1]).sum())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--categories", nargs="+", default=list(CATEGORIES))
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from cppf_tpu.eval.nocs_inference import CategoryRunner as RunnerJ
    from cppf_tpu_torch.eval.nocs_inference import CategoryRunner
    from cppf_tpu_torch.models.convert import ASSETS

    class JaxArgs:
        num_rots, angle_prec, adaptive_voting, ckpt_name = 72, 1.5, False, None

    rec_t = dict(back=[], sub=[], votes=[], replace={})
    rec_j = dict(preds=[], back=[], votes=[])
    _record_port(rec_t)
    _record_jax(rec_j)
    faults, rows = 0, []
    for cat in args.categories:
        runner = CategoryRunner(cat, device="cpu")
        sphere = runner.sphere.numpy().astype(np.float64)
        gram = sphere @ sphere.T
        np.fill_diagonal(gram, -1.0)
        spacing = float(np.degrees(np.arccos(np.median(gram.max(1)))))  # a sphere point
        axes = ("up", "right") if runner.pcfg.regress_right else ("up",)
        runner_j = None
        with np.load(os.path.join(ASSETS, f"{cat}_views.npz")) as z:
            views = {k: z[k] for k in z.files}
        for i in range(int(views["n_views"])):
            key = tuple(int(v) for v in views[f"jax_key_{i}"])
            for k in ("back", "sub", "votes"):
                rec_t[k].clear()
            with torch.no_grad():
                out, _ = runner.estimate(views[f"pc_{i}"], draws=runner.draws(key))
            port = {"up": out.up.numpy(), "right": out.right.numpy()}
            apart = {ax: _angle(port[ax], views[f"jax_{ax}_{i}"]) for ax in axes}
            parted = [ax for ax in axes if apart[ax] >= 0.5 * spacing]
            print(f"{cat} view {i}: " + ", ".join(f"{ax} {apart[ax]:.3f} deg from JAX's"
                                                  for ax in axes), flush=True)
            if not parted:
                continue
            if runner_j is None:
                runner_j = RunnerJ(cat, os.path.join(ROOT, "checkpoints"), JaxArgs)
            for v in rec_j.values():
                v.clear()
            out_j, _ = runner_j.estimate(jnp.asarray(views[f"jax_key_{i}"], jnp.uint32),
                                         views[f"pc_{i}"])
            jax.effects_barrier()
            votes_t, subs_t = list(rec_t["votes"]), list(rec_t["sub"])
            survivors = (int(out.n_filtered), int(out_j.n_filtered))
            n_flip, n_logit, d_logit, n_edge = _survivor_flips(rec_t, rec_j, runner.pcfg)
            # the port again on the same draws, its last back-vote's survivors
            # replaced by JAX's: do its axes then meet JAX's?
            rec_t["replace"][len(rec_t["back"]) - 1] = rec_j["back"][-1][1]
            rec_t["back"].clear()
            with torch.no_grad():
                again, _ = runner.estimate(views[f"pc_{i}"], draws=runner.draws(key))
            rec_t["replace"].clear()
            with_jax_mask = {ax: _angle(getattr(again, ax).numpy(),
                                        np.asarray(getattr(out_j, ax), np.float64))
                             for ax in axes}
            for ax in parted:
                a = axes.index(ax)
                (ang_t, idx_t, ct), (ang_j, idx_j, cj) = votes_t[a], rec_j["votes"][a]
                ct, cj = ct.astype(np.int64), cj.astype(np.int64)
                same = (idx_t == idx_j).all(-1)
                differ = np.nonzero(~same)[0]
                n_cdf = _subsample_rounding(subs_t[a], differ)
                bins = runner.pcfg.rot_num_bins - 1
                bin_flips = int((np.rint(ang_t * bins / np.pi)
                                 != np.rint(ang_j * bins / np.pi))[same].sum())
                w_t = _winner(sphere, port[ax])
                w_j = _winner(sphere, np.asarray(getattr(out_j, ax), np.float64))
                diff = np.abs(ct - cj)
                n_diff, max_diff = int((diff > 0).sum()), int(diff.max())
                margin_t, margin_j = int(ct[w_t] - ct[w_j]), int(cj[w_j] - cj[w_t])
                bound_ok = (n_diff <= COUNT_BINS_FRAC * len(ct) and max_diff <= COUNT_STEP)
                if ax == "right" and "up" in parted:
                    verdict = "follows the up axis"
                elif n_flip:
                    verdict = ("back-vote flip" if n_logit + n_edge >= n_flip
                               and with_jax_mask[ax] < 0.5 * spacing else "FAULT")
                elif len(differ):
                    verdict = "subsample rounding" if n_cdf == len(differ) else "FAULT"
                elif bin_flips:
                    verdict = "decode flip"
                elif w_t == w_j and bound_ok:
                    verdict = "same winner"
                elif bound_ok and margin_t >= 0 and margin_j >= 0 and (
                        margin_t + margin_j <= 2 * COUNT_STEP):
                    verdict = "near-tie"
                else:
                    verdict = "FAULT"
                faults += verdict == "FAULT"
                rows.append((cat, i, ax, verdict))
                print(f"  {ax}: {apart[ax]:.2f} deg apart; survivors port {survivors[0]}, JAX "
                      f"{survivors[1]} ({n_flip} pairs disagree: {n_logit} decode JAX's "
                      f"translation bins from JAX's logits on the port's noise, the logits "
                      f"{d_logit:.2e} apart there; {n_edge} flip within tol·(1 ± {EDGE_REL}); "
                      f"with JAX's survivors the port's {ax} is {with_jax_mask[ax]:.3f} deg "
                      f"from JAX's); subsampled pairs differ at {len(differ)} of {len(idx_t)} "
                      f"draws ({n_cdf} on a CDF step's edge), {bin_flips} of the rest decode "
                      f"another bin; winners port {w_t}, JAX {w_j}; port counts {ct[w_t]} / "
                      f"{ct[w_j]}, JAX counts {cj[w_t]} / {cj[w_j]} (port's winner / JAX's); "
                      f"margins port {margin_t}, JAX {margin_j}; count vectors differ in "
                      f"{n_diff} of {len(ct)} bins, by at most {max_diff}; {verdict}",
                      flush=True)
    print(f"{len(rows)} axes part from JAX's: " + "; ".join(
        f"{c} view {i} {ax}: {v}" for c, i, ax, v in rows), flush=True)
    print(f"faults: {faults}", flush=True)
    sys.exit(1 if faults else 0)


if __name__ == "__main__":
    main()
