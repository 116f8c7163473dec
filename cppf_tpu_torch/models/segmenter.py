"""The laptop lid/base segmenter: an FCN-ResNet50 with InstanceNorm
(counterpart of cppf_tpu/models/segmenter.py).

A dilated ResNet-50 (output stride 8) and the FCN head, bilinearly
upsampled to the input size.  NCHW inside, NHWC at its edge as the JAX
model takes and gives it.  The convolutions are ``torch.nn.functional``'s
(cuDNN on the card): the JAX model is XLA code outside any Pallas kernel.
Module names follow the flax tree (``stem_conv``, ``layer3_0.down_bn``,
``head_out`` ...), so ``models/convert.py`` maps the weights leaf by leaf.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cppf_tpu_torch.device import pin_float32, resolve_device

DROPOUT = 0.1
# torchvision's fcn_resnet50 (replace_stride_with_dilation=[False, True,
# True]): each layer's (width, stride, first block's dilation, the other
# blocks' dilation).  The first block of a dilated layer keeps the layer
# before's dilation, so layer3 opens at 1 and layer4 at 2.
SPECS = ((64, 1, 1, 1), (128, 2, 1, 1), (256, 1, 1, 2), (512, 1, 2, 4))


class InstanceNorm(nn.Module):
    """InstanceNorm over the spatial axes, eps 1e-5, biased variance, with
    an affine ``weight`` (flax ``scale``) and ``bias``.  With
    ``track_stats`` it normalises by the ``mean``/``var`` buffers instead:
    the eval mode of weights converted from the reference's torchvision
    model, whose norms kept running statistics."""

    def __init__(self, channels: int, track_stats: bool = False, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.track_stats = track_stats
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        if track_stats:
            self.register_buffer("mean", torch.zeros(channels))
            self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, H, W]
        if self.track_stats:
            mu, var = self.mean[:, None, None], self.var[:, None, None]
        else:
            mu = x.mean((-2, -1), keepdim=True)
            var = torch.square(x - mu).mean((-2, -1), keepdim=True)
        y = (x - mu) * torch.rsqrt(var + self.eps)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


def _conv(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1,
          bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=dilation * (k // 2),
                     dilation=dilation, bias=bias)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1, dilation: int = 1,
                 track_stats: bool = False):
        super().__init__()
        out = 4 * features
        self.conv1 = _conv(cin, features, 1)
        self.bn1 = InstanceNorm(features, track_stats)
        self.conv2 = _conv(features, features, 3, stride, dilation)
        self.bn2 = InstanceNorm(features, track_stats)
        self.conv3 = _conv(features, out, 1)
        self.bn3 = InstanceNorm(out, track_stats)
        if cin != out or stride != 1:
            self.down_conv = _conv(cin, out, 1, stride)
            self.down_bn = InstanceNorm(out, track_stats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if hasattr(self, "down_conv"):
            x = self.down_bn(self.down_conv(x))
        return F.relu(y + x)


class FCNResNet50(nn.Module):
    """The dilated ResNet-50 and FCN head; ``layers`` blocks a layer."""

    def __init__(self, num_classes: int = 2, layers: Sequence[int] = (3, 4, 6, 3),
                 track_stats: bool = False):
        super().__init__()
        self.stem_conv = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.stem_bn = InstanceNorm(64, track_stats)
        cin = 64
        self.block_names = []
        for li, ((feats, stride, dil0, dil), blocks) in enumerate(zip(SPECS, layers)):
            for b in range(blocks):
                name = f"layer{li + 1}_{b}"
                self.add_module(name, Bottleneck(cin, feats, stride if b == 0 else 1,
                                                 dil0 if b == 0 else dil, track_stats))
                self.block_names.append(name)
                cin = 4 * feats
        self.head_conv = _conv(cin, 512, 3)
        self.head_bn = InstanceNorm(512, track_stats)
        self.head_out = _conv(512, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor, dropout: Optional[torch.Generator] = None):
        """Logits [B, H, W, classes] of images ``x`` [B, H, W, 3].  With a
        ``dropout`` generator the head drops each feature with probability
        0.1 and scales the rest by 1/0.9, as flax's training mode; the mask
        is drawn on the generator's device."""
        h, w = x.shape[-3], x.shape[-2]
        y = F.relu(self.stem_bn(self.stem_conv(x.permute(0, 3, 1, 2))))
        y = F.max_pool2d(y, 3, stride=2, padding=1)  # pads with -inf, as flax
        for name in self.block_names:
            y = getattr(self, name)(y)
        y = F.relu(self.head_bn(self.head_conv(y)))
        if dropout is not None:
            keep = torch.rand(y.shape, generator=dropout, device=dropout.device) >= DROPOUT
            y = torch.where(keep.to(y.device), y / (1 - DROPOUT), 0.0)
        y = self.head_out(y)
        # half-pixel bilinear upsample: jax.image.resize's "bilinear" on an upsample
        y = F.interpolate(y, size=(h, w), mode="bilinear", align_corners=False)
        return y.permute(0, 2, 3, 1)


class SegmenterRunner:
    """A trained segmenter: the orbax checkpoint ``<ckpt_dir>/params_best/``
    that the JAX package writes (read by ``train/orbax.py``; the repo's
    ``checkpoints/laptop_aux``), else ``<ckpt_dir>/params_best.npz`` (the
    flat flax layout of ``models/convert.py``, which the port's trainer
    writes), normalising by running statistics exactly when its ``stem_bn``
    has a ``mean``.  Runs on ``cuda`` unless ``device`` says otherwise."""

    def __init__(self, ckpt_dir: str, device=None, num_classes: int = 2):
        from cppf_tpu_torch.models.convert import segmenter_state_dict
        from cppf_tpu_torch.train.checkpoints import load_params

        self.device = resolve_device(device)
        pin_float32()
        orbax_dir = os.path.join(ckpt_dir, "params_best")
        if not (os.path.isdir(orbax_dir) or os.path.isfile(f"{orbax_dir}.npz")):
            raise FileNotFoundError(
                f"no {orbax_dir}/ (orbax) or {orbax_dir}.npz: train a segmenter with `python "
                f"-m cppf_tpu_torch.train.laptop_aux out_dir={ckpt_dir}`")
        params = load_params(ckpt_dir, "params_best")
        track = "mean" in params["params"]["stem_bn"]
        self.model = FCNResNet50(num_classes, track_stats=track)
        self.model.load_state_dict(segmenter_state_dict(params), strict=True)
        self.model = self.model.to(self.device).eval()

    @torch.no_grad()
    def logits(self, rgb: np.ndarray) -> torch.Tensor:
        """Logits [H, W, classes] of one image [H, W, 3] in [0, 1]."""
        x = torch.as_tensor(np.asarray(rgb, np.float32), device=self.device)
        return self.model(x[None])[0]

    def predict(self, rgb: np.ndarray) -> np.ndarray:
        """Labels [H, W] of one image [H, W, 3] in [0, 1]: 0 base, 1 lid."""
        return self.logits(rgb).argmax(-1).cpu().numpy()
