"""ResNet-50 + FPN backbone, NCHW, frozen BatchNorm: a frozen copy of the plain path
of ``seam_match_rcnn_tpu_torch/models/resnet.py`` (torchvision
``resnet_fpn_backbone('resnet50')`` with its parameter names): conv1 + FrozenBN +
relu + maxpool as torch ops, no kernel, no rematerialisation.  The stem and
layer1 never require a gradient (torchvision's ``trainable_layers=3``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
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

    def __init__(self, dt: torch.dtype, block_counts: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.dt = dt
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
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
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
    def __init__(self, dt: torch.dtype):
        super().__init__()
        self.body = ResNet50(dt)
        self.fpn = FPN(dt)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.fpn(self.body(x))
