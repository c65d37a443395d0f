"""Box primitives: IoU, decode, clipping, small-box filtering.

Frozen copy of ``seam_match_rcnn_tpu_torch/ops/boxes.py`` (what the benchmark's plain
reference uses of it); it imports nothing of the port.

Port of ``seam_match_rcnn_tpu/ops/boxes.py`` (torchvision ``box_iou`` and
``BoxCoder.decode_single`` semantics).  Every function works on any leading
batch shape; padded boxes are handled with masks, not by filtering.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

# torchvision BoxCoder clamps dw/dh at log(1000/16) before exp.
BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU of [..., N, 4] against [..., M, 4] xyxy boxes -> [..., N, M]."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def clip_boxes_to_image(boxes: torch.Tensor, size_hw: torch.Tensor) -> torch.Tensor:
    """Clip [..., 4] boxes to (h, w); ``size_hw`` is [..., 2] broadcasting
    against ``boxes[..., 0]`` (per-image valid size inside a canvas)."""
    h = size_hw[..., 0].to(boxes.dtype)
    w = size_hw[..., 1].to(boxes.dtype)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def small_box_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """True for boxes with both sides >= min_size (the *keep* mask)."""
    ws = boxes[..., 2] - boxes[..., 0]
    hs = boxes[..., 3] - boxes[..., 1]
    return (ws >= min_size) & (hs >= min_size)


def decode_boxes(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights: Tuple[float, float, float, float]) -> torch.Tensor:
    """torchvision ``BoxCoder.decode_single``; ``boxes`` broadcasts against
    ``deltas[..., 0]`` (pass [R, 1, 4] for per-class deltas [R, C, 4])."""
    wx, wy, ww, wh = weights
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=BBOX_XFORM_CLIP)
    dh = (deltas[..., 3] / wh).clamp(max=BBOX_XFORM_CLIP)

    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
                        pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h], dim=-1)


def encode_boxes(reference_boxes: torch.Tensor, proposals: torch.Tensor,
                 weights: Tuple[float, float, float, float]) -> torch.Tensor:
    """torchvision ``BoxCoder.encode_single``: regression targets [..., 4] of
    ``reference_boxes`` relative to ``proposals``."""
    wx, wy, ww, wh = weights
    ex_w = proposals[..., 2] - proposals[..., 0]
    ex_h = proposals[..., 3] - proposals[..., 1]
    ex_cx = proposals[..., 0] + 0.5 * ex_w
    ex_cy = proposals[..., 1] + 0.5 * ex_h
    gt_w = reference_boxes[..., 2] - reference_boxes[..., 0]
    gt_h = reference_boxes[..., 3] - reference_boxes[..., 1]
    gt_cx = reference_boxes[..., 0] + 0.5 * gt_w
    gt_cy = reference_boxes[..., 1] + 0.5 * gt_h
    # guard padded or degenerate boxes against a division or log of 0
    ex_w, ex_h = ex_w.clamp(min=1e-8), ex_h.clamp(min=1e-8)
    gt_w, gt_h = gt_w.clamp(min=1e-8), gt_h.clamp(min=1e-8)
    tx = wx * (gt_cx - ex_cx) / ex_w
    ty = wy * (gt_cy - ex_cy) / ex_h
    tw = ww * torch.log(gt_w / ex_w)
    th = wh * torch.log(gt_h / ex_h)
    return torch.stack([tx, ty, tw, th], dim=-1)
