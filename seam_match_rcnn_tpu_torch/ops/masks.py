"""Mask pasting: 28x28 instance masks -> full-image masks.

Port of ``seam_match_rcnn_tpu/ops/masks.py`` (torchvision's
``paste_masks_in_image`` as ``GeneralizedRCNN.postprocess`` applies it):
each mask is zero-padded by one cell, its box scaled by (M+2)/M, and every
output pixel samples the padded mask bilinearly (``align_corners=False``) at
its box-relative coordinate, masked to the box's interior.  The JAX
function's gather formulation, in torch ops on the tensors' device; an XLA
function there, not a Pallas kernel, so it has no hand kernel here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _axis_params(g: torch.Tensor, size: int):
    """align_corners=False grid-sample mapping of normalized coordinates g
    into a padded axis of ``size`` cells: (lo, hi, weight of hi, inside).
    The coordinate is rounded once after its multiply-add, as XLA fuses it
    when it compiles the JAX function (exact in f64, then rounded to f32)."""
    c = ((g + 1.0).to(torch.float64) * (size * 0.5) - 0.5).to(torch.float32)
    lo = torch.floor(c)
    lerp = c - lo
    lo = lo.to(torch.int64)
    lo0 = lo.clamp(0, size - 1)
    lo1 = (lo + 1).clamp(0, size - 1)
    inside = (c > -1.0) & (c < size)
    return lo0, lo1, lerp, inside


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, out_h: int, out_w: int
                ) -> torch.Tensor:
    """masks [N, M, M] probabilities, boxes [N, 4] xyxy in image coordinates
    -> [N, out_h, out_w] f32 probabilities, 0 outside each (scaled) box."""
    n, m, _ = masks.shape
    masks = masks.to(torch.float32)
    boxes = boxes.to(device=masks.device, dtype=torch.float32)
    padded = F.pad(masks, (1, 1, 1, 1))
    size = m + 2
    scale = (m + 2.0) / m
    cx = (boxes[:, 0] + boxes[:, 2]) * 0.5
    cy = (boxes[:, 1] + boxes[:, 3]) * 0.5
    bw = ((boxes[:, 2] - boxes[:, 0]) * scale).clamp(min=1e-6)
    bh = ((boxes[:, 3] - boxes[:, 1]) * scale).clamp(min=1e-6)

    ys = torch.arange(out_h, dtype=torch.float32, device=masks.device) + 0.5
    xs = torch.arange(out_w, dtype=torch.float32, device=masks.device) + 0.5
    gy = (ys[None, :] - cy[:, None]) / (bh[:, None] * 0.5)   # [N, H]
    gx = (xs[None, :] - cx[:, None]) / (bw[:, None] * 0.5)   # [N, W]
    y0, y1, wy, iny = _axis_params(gy, size)
    x0, x1, wx, inx = _axis_params(gx, size)

    def rows(y):   # padded[i][y[i]] -> [N, H, size]
        return padded.gather(1, y[:, :, None].expand(n, out_h, size))

    def cols(r, x):   # r[i][:, x[i]] -> [N, H, W]
        return r.gather(2, x[:, None, :].expand(n, out_h, out_w))

    r0, r1 = rows(y0), rows(y1)
    wx_, wy_ = wx[:, None, :], wy[:, :, None]
    top = cols(r0, x0) * (1 - wx_) + cols(r0, x1) * wx_
    bot = cols(r1, x0) * (1 - wx_) + cols(r1, x1) * wx_
    out = top * (1 - wy_) + bot * wy_
    return out * (iny[:, :, None] & inx[:, None, :])
