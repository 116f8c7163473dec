"""Training losses (counterpart of cppf_tpu/train/losses.py).

- KL divergence with ``batchmean`` reduction over the pairs of one sample
  on the soft-binned translation (2 components) and the up/right angle
  distributions: mean over pairs of Σ_bins t·(log t − log q), 0·log 0 = 0;
- BCE with logits on the two aux orientation bits;
- MSE on the 3-d log-scale residual, the target broadcast over pairs.
"""
from __future__ import annotations

import torch


def kldiv_batchmean(log_q: torch.Tensor, target: torch.Tensor,
                    weight: torch.Tensor | None = None) -> torch.Tensor:
    """KL(target ‖ q) a row, rows the batch: summed over all and divided by
    the rows, or with ``weight`` [rows] their weighted mean (the weights
    summing out, floor 1e-6)."""
    t = target
    pos = t > 0
    pointwise = torch.where(pos, t * (torch.log(torch.where(pos, t, 1.0)) - log_q), 0.0)
    if weight is None:
        return torch.sum(pointwise) / t.shape[0]
    row = torch.sum(pointwise, -1)
    return torch.sum(weight * row) / torch.clamp(torch.sum(weight), min=1e-6)


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor,
                    weight: torch.Tensor | None = None) -> torch.Tensor:
    """BCE with logits, the mean, or with ``weight`` the weighted mean."""
    loss = (torch.clamp(logits, min=0) - logits * target
            + torch.log1p(torch.exp(-torch.abs(logits))))
    if weight is None:
        return torch.mean(loss)
    return torch.sum(weight * loss) / torch.clamp(torch.sum(weight), min=1e-6)


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def ppf_losses(preds, tr_prob, rot_prob, aux, scale_target, tr_num_bins: int,
               rot_num_bins: int, regress_right: bool, aux_weight=None, up_rot_weight=None,
               right_aux_boost: float = 1.0):
    """Every term of one sample from the head's output.

    preds [P, out_dim] (translation bins [:2B], up bins [2B:2B+R], right
    bins [2B+R:2B+2R], up-aux logit at −5, right-aux at −4, log-scale
    residual [−3:]); tr_prob [P, 2, B]; rot_prob [P, 2, R]; aux [P, 2];
    scale_target [3]; aux_weight [P, 2] weights the two BCEs;
    up_rot_weight [P] weights the up KL.  ``right_aux_boost`` scales the
    right-bit BCE in the total only; its component stays the raw BCE.
    Returns (total, dict of components with the total under "loss")."""
    B, R = tr_num_bins, rot_num_bins
    preds_tr = preds[:, : 2 * B].reshape(-1, 2, B)
    preds_up = preds[:, 2 * B: 2 * B + R]
    preds_right = preds[:, 2 * B + R: 2 * B + 2 * R]
    preds_up_aux = preds[:, -5]
    preds_right_aux = preds[:, -4]
    preds_scale = preds[:, -3:]

    loss_tr = (kldiv_batchmean(torch.log_softmax(preds_tr[:, 0], -1), tr_prob[:, 0])
               + kldiv_batchmean(torch.log_softmax(preds_tr[:, 1], -1), tr_prob[:, 1]))
    loss_up = kldiv_batchmean(torch.log_softmax(preds_up, -1), rot_prob[:, 0],
                              weight=up_rot_weight)
    w_up = aux_weight[:, 0] if aux_weight is not None else None
    loss_up_aux = bce_with_logits(preds_up_aux, aux[:, 0], w_up)
    loss_scale = mse(preds_scale, scale_target[None, :])

    total = loss_up + loss_tr + loss_up_aux + loss_scale
    comps = {"loss_tr": loss_tr, "loss_up": loss_up, "loss_up_aux": loss_up_aux,
             "loss_scale": loss_scale}
    if regress_right:
        loss_right = kldiv_batchmean(torch.log_softmax(preds_right, -1), rot_prob[:, 1])
        w_right = aux_weight[:, 1] if aux_weight is not None else None
        loss_right_aux = bce_with_logits(preds_right_aux, aux[:, 1], w_right)
        total = total + loss_right + right_aux_boost * loss_right_aux
        comps["loss_right"] = loss_right
        comps["loss_right_aux"] = loss_right_aux
    comps["loss"] = total
    return total, comps


def ppf_regression_losses(preds, tr_target, rot_target, aux, scale_target, aux_weight=None):
    """Losses of the regression head (``cls_bins`` False, out_dim 9: tr(2),
    rot(2), aux(2), scale(3)): MSE on tr and rot, BCE on the bits, MSE on
    the scale."""
    loss_tr = mse(preds[:, :2], tr_target)
    loss_rot = mse(preds[:, 2:4], rot_target)
    loss_aux = bce_with_logits(preds[:, 4:6], aux, aux_weight)
    loss_scale = mse(preds[:, 6:9], scale_target[None, :])
    total = loss_tr + loss_rot + loss_aux + loss_scale
    return total, {"loss_tr": loss_tr, "loss_rot": loss_rot, "loss_aux": loss_aux,
                   "loss_scale": loss_scale, "loss": total}
