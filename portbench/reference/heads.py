"""Detection heads: RPN head, box head and predictor, mask head and predictor.

Frozen copy of ``seam_match_rcnn_tpu_torch/models/heads.py`` (what the benchmark's plain
reference uses of it); it imports nothing of the port.

Port of ``seam_match_rcnn_tpu/models/heads.py`` with torchvision's module
names.  Everything is NCHW; RoI tensors are [N, C, S, S].
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, ConvTranspose2d, Linear, cast, elementwise_dtype


class RPNHead(nn.Module):
    """Shared 3x3 conv + 1x1 objectness/box convs, applied per FPN level.
    Returns per level logits [B, A, H, W] and deltas [B, 4A, H, W] (channel
    a*4 + k), in the compute dtype."""

    def __init__(self, num_anchors: int, dt: torch.dtype, channels: int = 256):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, compute_dtype=dt)
        self.cls_logits = Conv2d(channels, num_anchors, 1, compute_dtype=dt)
        self.bbox_pred = Conv2d(channels, num_anchors * 4, 1, compute_dtype=dt)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        logits, regs = [], []
        for f in feats:
            t = F.relu(self.conv(f))
            logits.append(self.cls_logits(t))
            regs.append(self.bbox_pred(t))
        return logits, regs


class TwoMLPHead(nn.Module):
    """Box head: flatten [N, C, 7, 7] -> fc6 -> fc7 (1024 each).

    fc6's weight keeps torchvision's CHW flatten order.  The pooled features
    arrive channels-last from the RoIAlign kernel, so the product is taken
    in HWC order with fc6's weight permuted to match (25 MB) instead of
    transposing the [N, C, 7, 7] features (1.1 GB at 44,000 rois)."""

    def __init__(self, in_channels: int, resolution: int, dt: torch.dtype,
                 representation_size: int = 1024):
        super().__init__()
        self.dt = dt
        self.fc6 = Linear(in_channels * resolution * resolution, representation_size,
                          compute_dtype=dt)
        self.fc7 = Linear(representation_size, representation_size, compute_dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, s, _ = x.shape
        x_hwc = x.permute(0, 2, 3, 1).reshape(n, -1)
        w = self.fc6.weight.view(-1, c, s, s).permute(0, 2, 3, 1).reshape(-1, c * s * s)
        x = F.relu(F.linear(cast(x_hwc, self.dt), cast(w, self.dt),
                            self.fc6.bias.to(elementwise_dtype(self.dt))))
        return F.relu(self.fc7(x))


class FastRCNNPredictor(nn.Module):
    def __init__(self, in_features: int, num_classes: int, dt: torch.dtype):
        super().__init__()
        self.cls_score = Linear(in_features, num_classes, compute_dtype=dt)
        self.bbox_pred = Linear(in_features, num_classes * 4, compute_dtype=dt)

    def forward(self, x: torch.Tensor):
        return self.cls_score(x), self.bbox_pred(x)


class MaskHead(nn.Module):
    """torchvision MaskRCNNHeads: 4 x (conv3x3 256 + relu) on [N, 256, 14, 14]."""

    def __init__(self, dt: torch.dtype, channels: int = 256):
        super().__init__()
        for i in range(1, 5):
            setattr(self, f"mask_fcn{i}", Conv2d(channels, channels, 3, padding=1,
                                                 compute_dtype=dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 5):
            x = F.relu(getattr(self, f"mask_fcn{i}")(x))
        return x


class MaskPredictor(nn.Module):
    """torchvision MaskRCNNPredictor: conv-transpose 2x2/2 + relu, then 1x1
    per-class logits -> [N, num_classes, 28, 28] in the compute dtype."""

    def __init__(self, num_classes: int, dt: torch.dtype, channels: int = 256):
        super().__init__()
        self.conv5_mask = ConvTranspose2d(channels, channels, 2, stride=2, compute_dtype=dt)
        self.mask_fcn_logits = Conv2d(channels, num_classes, 1, compute_dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mask_fcn_logits(F.relu(self.conv5_mask(x)))
