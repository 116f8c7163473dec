"""Training losses (counterpart of cppf_tpu/train/losses.py).

- KL divergence with ``batchmean`` reduction over the pairs of one sample
  on the soft-binned translation (2 components) and the up/right angle
  distributions: mean over pairs of Σ_bins t·(log t − log q), 0·log 0 = 0;
- BCE with logits on the two aux orientation bits;
- MSE on the 3-d log-scale residual, the target broadcast over pairs.

Pair-sharded training (``parallel/train_step.py``) hands each term its
denominators (``PairDenominators``: the pair count and the weight sums of
every rank's pairs): a rank's term is then its own numerator over them, and
the terms of the ranks sum to the term of the whole sample.  Without them
each term is its own mean, as JAX's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class PairDenominators(NamedTuple):
    """A sample's denominators over every rank's pairs (0-d tensors, no
    gradient): the pair count, and the sums of ``up_rot_weight`` and of
    the two columns of ``aux_weight`` (0 where the batch has none)."""
    rows: torch.Tensor
    up_rot: torch.Tensor
    aux_up: torch.Tensor
    aux_right: torch.Tensor


def _weight_sum(weight, den):
    return torch.sum(weight) if den is None else den


def _pair_mean(x: torch.Tensor, rows) -> torch.Tensor:
    """The sum of ``x`` [P, ...] over the count of the mean of every rank's
    rows: its elements a row times ``rows``."""
    return torch.sum(x) / (rows * (x.numel() // max(x.shape[0], 1)))


def kldiv_batchmean(log_q: torch.Tensor, target: torch.Tensor,
                    weight: torch.Tensor | None = None, rows=None,
                    weight_sum=None) -> torch.Tensor:
    """KL(target ‖ q) a row, rows the batch: summed over all and divided by
    the rows (``rows``: every rank's), or with ``weight`` [rows] their
    weighted mean (the weights summing out, ``weight_sum``: every rank's;
    floor 1e-6)."""
    t = target
    pos = t > 0
    pointwise = torch.where(pos, t * (torch.log(torch.where(pos, t, 1.0)) - log_q), 0.0)
    if weight is None:
        return torch.sum(pointwise) / (t.shape[0] if rows is None else rows)
    row = torch.sum(pointwise, -1)
    return torch.sum(weight * row) / torch.clamp(_weight_sum(weight, weight_sum), min=1e-6)


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor,
                    weight: torch.Tensor | None = None, rows=None,
                    weight_sum=None) -> torch.Tensor:
    """BCE with logits, the mean, or with ``weight`` the weighted mean;
    ``rows`` and ``weight_sum`` as in :func:`kldiv_batchmean`."""
    loss = (torch.clamp(logits, min=0) - logits * target
            + torch.log1p(torch.exp(-torch.abs(logits))))
    if weight is None:
        return torch.mean(loss) if rows is None else _pair_mean(loss, rows)
    return torch.sum(weight * loss) / torch.clamp(_weight_sum(weight, weight_sum), min=1e-6)


def mse(pred: torch.Tensor, target: torch.Tensor, rows=None) -> torch.Tensor:
    if rows is None:
        return torch.mean((pred - target) ** 2)
    return _pair_mean((pred - target) ** 2, rows)


def pair_denominators(point_idxs, aux_weight=None, up_rot_weight=None) -> torch.Tensor:
    """[B, 4] (pair count, Σ up_rot_weight, Σ aux_weight[:, 0], Σ
    aux_weight[:, 1]) of each sample of this rank's pairs: summed over the
    pair ranks, the ``PairDenominators`` of each sample."""
    b, p = point_idxs.shape[:2]
    zero = torch.zeros(b, dtype=torch.float32, device=point_idxs.device)
    cols = [torch.full((b,), float(p), device=point_idxs.device),
            zero if up_rot_weight is None else up_rot_weight.sum(1),
            zero if aux_weight is None else aux_weight[:, :, 0].sum(1),
            zero if aux_weight is None else aux_weight[:, :, 1].sum(1)]
    return torch.stack(cols, 1).detach()


def ppf_losses(preds, tr_prob, rot_prob, aux, scale_target, tr_num_bins: int,
               rot_num_bins: int, regress_right: bool, aux_weight=None, up_rot_weight=None,
               right_aux_boost: float = 1.0, denoms: Optional[PairDenominators] = None):
    """Every term of one sample from the head's output.

    preds [P, out_dim] (translation bins [:2B], up bins [2B:2B+R], right
    bins [2B+R:2B+2R], up-aux logit at −5, right-aux at −4, log-scale
    residual [−3:]); tr_prob [P, 2, B]; rot_prob [P, 2, R]; aux [P, 2];
    scale_target [3]; aux_weight [P, 2] weights the two BCEs;
    up_rot_weight [P] weights the up KL.  ``right_aux_boost`` scales the
    right-bit BCE in the total only; its component stays the raw BCE.
    ``denoms``: this rank's rows of a pair-sharded sample over every rank's
    denominators.  Returns (total, dict of components with the total under
    "loss")."""
    B, R = tr_num_bins, rot_num_bins
    preds_tr = preds[:, : 2 * B].reshape(-1, 2, B)
    preds_up = preds[:, 2 * B: 2 * B + R]
    preds_right = preds[:, 2 * B + R: 2 * B + 2 * R]
    preds_up_aux = preds[:, -5]
    preds_right_aux = preds[:, -4]
    preds_scale = preds[:, -3:]

    d = denoms if denoms is not None else PairDenominators(None, None, None, None)
    loss_tr = (kldiv_batchmean(torch.log_softmax(preds_tr[:, 0], -1), tr_prob[:, 0], rows=d.rows)
               + kldiv_batchmean(torch.log_softmax(preds_tr[:, 1], -1), tr_prob[:, 1],
                                 rows=d.rows))
    loss_up = kldiv_batchmean(torch.log_softmax(preds_up, -1), rot_prob[:, 0],
                              weight=up_rot_weight, rows=d.rows, weight_sum=d.up_rot)
    w_up = aux_weight[:, 0] if aux_weight is not None else None
    loss_up_aux = bce_with_logits(preds_up_aux, aux[:, 0], w_up, rows=d.rows,
                                  weight_sum=d.aux_up)
    loss_scale = mse(preds_scale, scale_target[None, :], rows=d.rows)

    total = loss_up + loss_tr + loss_up_aux + loss_scale
    comps = {"loss_tr": loss_tr, "loss_up": loss_up, "loss_up_aux": loss_up_aux,
             "loss_scale": loss_scale}
    if regress_right:
        loss_right = kldiv_batchmean(torch.log_softmax(preds_right, -1), rot_prob[:, 1],
                                     rows=d.rows)
        w_right = aux_weight[:, 1] if aux_weight is not None else None
        loss_right_aux = bce_with_logits(preds_right_aux, aux[:, 1], w_right, rows=d.rows,
                                         weight_sum=d.aux_right)
        total = total + loss_right + right_aux_boost * loss_right_aux
        comps["loss_right"] = loss_right
        comps["loss_right_aux"] = loss_right_aux
    comps["loss"] = total
    return total, comps


def ppf_regression_losses(preds, tr_target, rot_target, aux, scale_target, aux_weight=None,
                          denoms: Optional[PairDenominators] = None):
    """Losses of the regression head (``cls_bins`` False, out_dim 9: tr(2),
    rot(2), aux(2), scale(3)): MSE on tr and rot, BCE on the bits, MSE on
    the scale; ``denoms`` as in :func:`ppf_losses`."""
    d = denoms if denoms is not None else PairDenominators(None, None, None, None)
    aux_sum = None if denoms is None else d.aux_up + d.aux_right
    loss_tr = mse(preds[:, :2], tr_target, rows=d.rows)
    loss_rot = mse(preds[:, 2:4], rot_target, rows=d.rows)
    loss_aux = bce_with_logits(preds[:, 4:6], aux, aux_weight, rows=d.rows, weight_sum=aux_sum)
    loss_scale = mse(preds[:, 6:9], scale_target[None, :], rows=d.rows)
    total = loss_tr + loss_rot + loss_aux + loss_scale
    return total, {"loss_tr": loss_tr, "loss_rot": loss_rot, "loss_aux": loss_aux,
                   "loss_scale": loss_scale, "loss": total}
