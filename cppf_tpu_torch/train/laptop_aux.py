"""Training of the laptop lid/base segmenter (counterpart of
cppf_tpu/train/laptop_aux.py): the FCN-ResNet50 with InstanceNorm,
cross entropy that ignores the -100 labels, Adam (lr 1e-3, no weight
decay) as optax's, and ``params_best.npz`` after every epoch, which
``models/segmenter.py::SegmenterRunner`` and the NOCS driver serve.

Usage:
    python -m cppf_tpu_torch.train.laptop_aux [max_epoch=20] [batch_size=16] \\
        [out_dir=checkpoints_torch/laptop_aux] [lr=1e-3] [epoch_len=200] \\
        [data_root=./data/laptop] [seed=0] [device=cpu]
"""
from __future__ import annotations

import logging
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cppf_tpu_torch.config import parse_cli_overrides
from cppf_tpu_torch.data.laptop_aux import LaptopAuxDataset
from cppf_tpu_torch.device import pin_float32, resolve_device
from cppf_tpu_torch.models.convert import save_segmenter_npz, segmenter_state_dict
from cppf_tpu_torch.models.segmenter import FCNResNet50
from cppf_tpu_torch.train.step import flax_init_
from cppf_tpu_torch.utils.meters import AverageMeter

log = logging.getLogger("cppf_tpu_torch.laptop_aux")


def ce_ignore_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of ``logits`` [..., classes] over the labels
    that are not negative (the reference's ignore_index -100), divided by
    max(count, 1)."""
    valid = labels >= 0
    logp = F.log_softmax(logits, -1)
    nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)


def make_optimizer(model: nn.Module, lr: float = 1e-3) -> torch.optim.Adam:
    """``optax.adam(lr)``: betas (0.9, 0.999), eps 1e-8, no weight decay."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0)


def seg_train_step(model: FCNResNet50, opt: torch.optim.Optimizer, rgb: torch.Tensor,
                   labels: torch.Tensor, dropout: Optional[torch.Generator] = None):
    """One Adam step on a batch (rgb [B, H, W, 3], labels [B, H, W]); the
    head's dropout masks come from the ``dropout`` generator (none without
    one).  Returns the loss before the step (a device tensor)."""
    opt.zero_grad(set_to_none=True)
    loss = ce_ignore_loss(model(rgb, dropout), labels)
    loss.backward()
    opt.step()
    return loss.detach()


def sample_batch(ds: LaptopAuxDataset, batch_size: int, device):
    """The next ``batch_size`` samples of ``ds``, stacked on ``device``."""
    rgbs, labels = zip(*[ds.sample() for _ in range(batch_size)])
    return (torch.from_numpy(np.stack(rgbs)).to(device),
            torch.from_numpy(np.stack(labels)).to(device))


def train(max_epoch: int = 20, batch_size: int = 16, out_dir: str = "checkpoints_torch/laptop_aux",
          lr: float = 1e-3, epoch_len: int = 200, data_root: str = "./data/laptop",
          seed: int = 0, device=None, params: Optional[dict] = None):
    """Trains from the flax-style init (``train/step.py::flax_init_``)
    drawn from a CPU generator seeded with ``seed`` (or from ``params``, a
    flax tree ``{"params": ...}``), ``epoch_len // batch_size`` steps an epoch, and writes
    ``<out_dir>/params_best.npz`` after every epoch.  The dropout masks
    come from a generator on the device, seeded with ``seed``.  Runs on
    ``cuda`` unless ``device`` says otherwise.  Returns (the model, the
    loss of every step)."""
    device = resolve_device(device)
    pin_float32()
    ds = LaptopAuxDataset(data_root=data_root, seed=seed, epoch_len=epoch_len)
    model = FCNResNet50(num_classes=2)
    if params is None:
        flax_init_(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(segmenter_state_dict(params), strict=True)
    model = model.to(device).train()
    opt = make_optimizer(model, lr)
    dropout = torch.Generator(device=device).manual_seed(seed)
    losses: List[float] = []
    for epoch in range(max_epoch):
        meter = AverageMeter()
        t0 = time.time()
        for _ in range(max(1, epoch_len // batch_size)):
            rgb, labels = sample_batch(ds, batch_size, device)
            losses.append(float(seg_train_step(model, opt, rgb, labels, dropout)))
            meter.update(losses[-1])
        log.info("epoch %d loss %.4f (%.1fs)", epoch, meter.avg, time.time() - t0)
        save_segmenter_npz(os.path.join(out_dir, "params_best.npz"), model)
    return model, losses


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s][%(name)s] %(message)s",
                        force=True)
    overrides = parse_cli_overrides(argv if argv is not None else sys.argv[1:])
    return train(
        max_epoch=int(overrides.get("max_epoch", 20)),
        batch_size=int(overrides.get("batch_size", 16)),
        out_dir=str(overrides.get("out_dir", "checkpoints_torch/laptop_aux")),
        lr=float(overrides.get("lr", 1e-3)),
        epoch_len=int(overrides.get("epoch_len", 200)),
        data_root=str(overrides.get("data_root", "./data/laptop")),
        seed=int(overrides.get("seed", 0)),
        device=overrides.get("device"),
    )


if __name__ == "__main__":
    main()
