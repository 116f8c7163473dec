"""The training step (counterpart of cppf_tpu/train/step.py).

Adam (lr 1e-3, weight decay 1e-4 added to the gradient before the moments,
as ``optax.chain(add_decayed_weights, adam)`` does: L2, not AdamW); KL on
the soft-binned translation and angles, BCE on the aux bits, MSE on the
log-scale.  Gradients flow through the PPF head and the point encoder,
autograd through the plain torch encoders: no kernel of the port has a
backward, and none is on this path.  A batch's samples run one after
another, each with its own neighbours and pairs, and the loss is the mean
of their totals, as the JAX step's ``vmap`` + mean.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from cppf_tpu_torch.config import Config
from cppf_tpu_torch.models.convert import make_encoders, params_to_state_dicts
from cppf_tpu_torch.models.encoders import PointEncoder, PPFEncoder
from cppf_tpu_torch.models.segmenter import InstanceNorm
from cppf_tpu_torch.ops.knn import knn_indices
from cppf_tpu_torch.train.losses import PairDenominators, ppf_losses, ppf_regression_losses

# flax's lecun_normal: a normal truncated at ±2σ, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


class Batch(NamedTuple):
    pc: torch.Tensor            # [B, N, 3]
    normals: torch.Tensor       # [B, N, 3]
    n_valid: torch.Tensor       # [B] int32
    point_idxs: torch.Tensor    # [B, P, 2] int32
    tr_prob: torch.Tensor       # [B, P, 2, nb] (cls_bins) or [B, P, 2] raw
    rot_prob: torch.Tensor      # [B, P, 2, nr] (cls_bins) or [B, P, 2] raw
    aux: torch.Tensor           # [B, P, 2]
    scale_target: torch.Tensor  # [B, 3]
    aux_weight: Optional[torch.Tensor] = None     # [B, P, 2]: the aux BCE's weights
    up_rot_weight: Optional[torch.Tensor] = None  # [B, P]: the up KL's weights

    def to(self, device) -> "Batch":
        return Batch(*(None if t is None else t.to(device) for t in self))


@dataclass(frozen=True)
class TrainStatics:
    tr_num_bins: int
    rot_num_bins: int
    regress_right: bool
    knn: int
    cls_bins: bool = True
    right_aux_boost: float = 1.0

    @classmethod
    def from_config(cls, cfg: Config) -> "TrainStatics":
        return cls(cfg.tr_num_bins, cfg.rot_num_bins, cfg.regress_right, cfg.knn,
                   cfg.cls_bins, cfg.right_aux_boost)


@dataclass
class TrainState:
    """Both encoders, their optimizer, and the count of steps taken."""
    point: PointEncoder
    ppf: PPFEncoder
    opt: torch.optim.Optimizer
    step: int = 0


def make_optimizer(cfg: Config, params) -> torch.optim.Adam:
    """Adam with L2 weight decay added to the gradient (eps 1e-8, no
    amsgrad), as the JAX optimizer."""
    return torch.optim.Adam(params, lr=cfg.opt.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.opt.weight_decay, amsgrad=False)


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default init in place: Dense and Conv kernels lecun-normal (a
    normal of variance 1/fan_in truncated at ±2σ; a conv's fan_in is
    kh·kw·in), biases 0, LayerNorm and InstanceNorm scale 1 and bias 0.
    The layers draw in the order of ``named_modules``."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            std = (1.0 / m.weight[0].numel()) ** 0.5 / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.LayerNorm, InstanceNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


def init_train_state(cfg: Config, device, params: Optional[dict] = None) -> TrainState:
    """Fresh encoders on ``device`` and their optimizer.  The weights are
    drawn with :func:`flax_init_` from a CPU ``torch.Generator`` seeded by
    ``cfg.seed`` (so the same on every device), or, with ``params`` (a JAX
    params tree ``{"point": ..., "ppf": ...}`` of numpy arrays), carried
    across from it."""
    point, ppf = make_encoders(cfg.out_dim)
    if params is None:
        gen = torch.Generator().manual_seed(cfg.seed)
        flax_init_(point, gen)
        flax_init_(ppf, gen)
    else:
        point_sd, ppf_sd = params_to_state_dicts(params)
        point.load_state_dict(point_sd, strict=True)
        ppf.load_state_dict(ppf_sd, strict=True)
    point, ppf = point.to(device).train(), ppf.to(device).train()
    opt = make_optimizer(cfg, [*point.parameters(), *ppf.parameters()])
    return TrainState(point, ppf, opt, 0)


def loss_fn(state: TrainState, batch: Batch, statics: TrainStatics, denoms=None):
    """(mean over the batch of the per-sample totals, dict of each
    component's mean).  A sample: KNN on its points, the point encoder, the
    pair head on its pairs, the losses.  ``denoms`` [B, 4]
    (``losses.pair_denominators`` summed over the pair ranks), when given,
    makes each term this rank's rows' share of the term of the whole
    sample (``ppf_losses``)."""
    totals, comps = [], []
    n = batch.pc.shape[1]
    arange = torch.arange(n, device=batch.pc.device)
    for i in range(batch.pc.shape[0]):
        pc, normals = batch.pc[i], batch.normals[i]
        valid = arange < batch.n_valid[i]
        nbr = knn_indices(pc, statics.knn, valid)
        feat = state.point(pc, normals, nbr, valid)
        preds = state.ppf(pc, normals, feat, batch.point_idxs[i])
        aux_w = None if batch.aux_weight is None else batch.aux_weight[i]
        den = None if denoms is None else PairDenominators(*denoms[i])
        if statics.cls_bins:
            up_w = None if batch.up_rot_weight is None else batch.up_rot_weight[i]
            total, comp = ppf_losses(
                preds, batch.tr_prob[i], batch.rot_prob[i], batch.aux[i],
                batch.scale_target[i], statics.tr_num_bins, statics.rot_num_bins,
                statics.regress_right, aux_weight=aux_w, up_rot_weight=up_w,
                right_aux_boost=statics.right_aux_boost, denoms=den)
        else:
            total, comp = ppf_regression_losses(preds, batch.tr_prob[i], batch.rot_prob[i],
                                                batch.aux[i], batch.scale_target[i],
                                                aux_weight=aux_w, denoms=den)
        totals.append(total)
        comps.append(comp)
    mean = {k: torch.stack([c[k] for c in comps]).mean() for k in comps[0]}
    return torch.stack(totals).mean(), mean


def train_step(state: TrainState, batch: Batch, statics: TrainStatics) -> Dict[str, torch.Tensor]:
    """One Adam step on ``batch`` in place; returns the loss components
    (detached, on the device: reading them waits for the step)."""
    state.opt.zero_grad(set_to_none=True)
    loss, comps = loss_fn(state, batch, statics)
    loss.backward()
    state.opt.step()
    state.step += 1
    return {k: v.detach() for k, v in comps.items()}
