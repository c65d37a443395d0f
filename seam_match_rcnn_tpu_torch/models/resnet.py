"""ResNet-50 + FPN backbone, NCHW, frozen BatchNorm.

Port of ``seam_match_rcnn_tpu/models/resnet.py`` (torchvision
``resnet_fpn_backbone('resnet50')``) with torchvision's parameter names
(``body.layer1.0.conv1.weight``, ``fpn.inner_blocks.0.0.weight``, ...).
``stem_backend="pallas"`` runs the stem as kernel K1
(``ops/cuda_stem.fused_stem``); ``"xla"`` runs conv1 + FrozenBN + relu +
maxpool as separate torch ops.  Both read the same parameters.

The stem and layer1 are frozen as torchvision's ``trainable_layers=3``
freezes them: their parameters never require a gradient, so no backward
runs below layer2 (the JAX package's ``freeze_backbone_stages`` stop and its
optimizer mask, in one).  K1 has no backward and needs none.

``remat=True`` (``ModelConfig.remat_backbone``, the JAX package's
``nn.remat(Bottleneck)``) runs each bottleneck under
``torch.utils.checkpoint`` when a gradient is being recorded: the block
keeps only its input and recomputes its activations in the backward.  The
stem (K1) stays outside.  The recompute gives the forward's values bit for
bit as long as the convolutions pick the same algorithm both times
(``torch.backends.cudnn.benchmark`` off, PyTorch's default).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.cuda_stem import fused_stem
from .layers import Conv2d, FrozenBatchNorm2d


class Bottleneck(nn.Module):
    """torchvision Bottleneck (stride on the 3x3, ResNet-B)."""

    def __init__(self, inplanes: int, planes: int, stride: int, downsample: bool,
                 dt: torch.dtype):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False, compute_dtype=dt)
        self.bn1 = FrozenBatchNorm2d(planes, compute_dtype=dt)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False,
                            compute_dtype=dt)
        self.bn2 = FrozenBatchNorm2d(planes, compute_dtype=dt)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False, compute_dtype=dt)
        self.bn3 = FrozenBatchNorm2d(planes * 4, compute_dtype=dt)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False, compute_dtype=dt),
                FrozenBatchNorm2d(planes * 4, compute_dtype=dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        idt = x if self.downsample is None else self.downsample(x)
        return F.relu(out + idt)


class ResNet50(nn.Module):
    """Returns C2..C5 (strides 4/8/16/32)."""

    def __init__(self, dt: torch.dtype, stem_backend: str = "xla",
                 block_counts: Sequence[int] = (3, 4, 6, 3), remat: bool = False):
        super().__init__()
        if stem_backend not in ("xla", "pallas"):
            raise ValueError(f"unknown stem_backend {stem_backend!r}: 'xla' or 'pallas'")
        self.dt = dt
        self.stem_backend = stem_backend
        self.remat = remat
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False, compute_dtype=dt)
        self.bn1 = FrozenBatchNorm2d(64, compute_dtype=dt)
        inplanes, planes = 64, 64
        for stage, n in enumerate(block_counts):
            blocks = []
            for b in range(n):
                stride = (1 if stage == 0 else 2) if b == 0 else 1
                blocks.append(Bottleneck(inplanes, planes, stride, b == 0, dt))
                inplanes = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            planes *= 2
        for mod in (self.conv1, self.layer1):
            mod.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if self.stem_backend == "pallas":
            scale, shift = self.bn1.scale_shift()
            x = fused_stem(x, self.conv1.weight, scale, shift, self.dt)
        else:
            x = F.relu(self.bn1(self.conv1(x)))
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        remat = self.remat and torch.is_grad_enabled()
        outs = []
        for i in range(1, 5):
            for block in getattr(self, f"layer{i}"):
                x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
            outs.append(x)
        return tuple(outs)


class FPN(nn.Module):
    """torchvision FeaturePyramidNetwork + LastLevelMaxPool: C2..C5 ->
    (P2, P3, P4, P5, P6); P6 only feeds the RPN."""

    def __init__(self, dt: torch.dtype, in_channels=(256, 512, 1024, 2048),
                 out_channels: int = 256):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            [nn.Sequential(Conv2d(c, out_channels, 1, compute_dtype=dt)) for c in in_channels])
        self.layer_blocks = nn.ModuleList(
            [nn.Sequential(Conv2d(out_channels, out_channels, 3, padding=1, compute_dtype=dt))
             for _ in in_channels])

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        laterals = [blk(f) for blk, f in zip(self.inner_blocks, feats)]
        for i in range(len(laterals) - 2, -1, -1):
            h, w = laterals[i].shape[-2:]
            up = laterals[i + 1].repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
            laterals[i] = laterals[i] + up[..., :h, :w]
        outs = [blk(lat) for blk, lat in zip(self.layer_blocks, laterals)]
        # max_pool(kernel 1, stride 2) is a stride-2 subsample
        return tuple(outs) + (outs[-1][..., ::2, ::2],)


class BackboneWithFPN(nn.Module):
    def __init__(self, dt: torch.dtype, stem_backend: str = "xla", remat: bool = False):
        super().__init__()
        self.body = ResNet50(dt, stem_backend, remat=remat)
        self.fpn = FPN(dt)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.fpn(self.body(x))
