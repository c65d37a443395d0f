"""Detection postprocessing with fixed-size, masked outputs.

Frozen copy of ``seam_match_rcnn_tpu_torch/models/detection.py`` (what the benchmark's
plain reference uses of it); it imports nothing of the port.

Port of ``seam_match_rcnn_tpu/models/detection.py``: softmax, per-class
decode and clip, score > ``score_thresh``, small-box removal, score-sorted
truncation to ``nms_pre`` candidates, class-offset NMS, ``detections_per_img``
outputs, and the whole-image fallback box (score 1.0 for the image model,
0.1 for the video model) when nothing survives.  Batched over images.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import RoIHeadsConfig
from . import boxes as box_ops
from .nms import batched_nms_padded
from .rpn import topk_stable


class Detections(NamedTuple):
    boxes: torch.Tensor   # [B, D, 4] canvas coords
    scores: torch.Tensor  # [B, D]
    labels: torch.Tensor  # [B, D] int64 (1-based classes; 0 only for padding/fallback)
    valid: torch.Tensor   # [B, D] bool


def postprocess_detections(class_logits: torch.Tensor, box_deltas: torch.Tensor,
                           proposals: torch.Tensor, proposal_valid: torch.Tensor,
                           image_sizes: torch.Tensor, cfg: RoIHeadsConfig,
                           fallback_score: float = 1.0, nms_pre: int = 2048) -> Detections:
    """class_logits [B, R, C]; box_deltas [B, R, 4C]; proposals [B, R, 4];
    proposal_valid [B, R]; image_sizes [B, 2] valid (h, w)."""
    b, r, nc = class_logits.shape
    d = cfg.detections_per_img
    sizes = image_sizes.to(class_logits.dtype)
    scores = torch.softmax(class_logits, dim=-1)
    boxes = box_ops.decode_boxes(box_deltas.reshape(b, r, nc, 4), proposals[:, :, None, :],
                                 cfg.bbox_reg_weights)
    boxes = box_ops.clip_boxes_to_image(boxes, sizes[:, None, None, :])

    # drop the background column, flatten classes into candidates
    fg_boxes = boxes[:, :, 1:].reshape(b, -1, 4)
    fg_scores = scores[:, :, 1:].reshape(b, -1)
    fg_labels = torch.arange(1, nc, device=class_logits.device).repeat(r)
    keep = fg_scores > cfg.score_thresh
    keep &= box_ops.small_box_mask(fg_boxes, 1e-2)
    keep &= proposal_valid.repeat_interleave(nc - 1, dim=1)

    k = min(nms_pre, fg_scores.shape[1])
    top_scores, top_idx = topk_stable(
        torch.where(keep, fg_scores, torch.full_like(fg_scores, -1.0)), k)
    cand_boxes = torch.take_along_dim(fg_boxes, top_idx[..., None], dim=1)
    cand_labels = fg_labels[top_idx]
    idx, mask = batched_nms_padded(cand_boxes, top_scores, cand_labels, cfg.nms_thresh, d,
                                   valid=top_scores > 0)
    safe = idx.clamp(min=0)
    out_boxes = torch.take_along_dim(cand_boxes, safe[..., None], dim=1)
    out_scores = torch.where(mask, torch.take_along_dim(top_scores, safe, dim=1),
                             torch.zeros_like(mask, dtype=top_scores.dtype))
    out_labels = torch.where(mask, torch.take_along_dim(cand_labels, safe, dim=1),
                             torch.zeros_like(safe))

    # whole-image fallback where nothing survives
    none = ~mask.any(dim=1)
    first = torch.zeros_like(mask)
    first[:, 0] = True
    zero = torch.zeros_like(sizes[:, 0])
    fb_boxes = torch.zeros_like(out_boxes)
    fb_boxes[:, 0] = torch.stack([zero, zero, sizes[:, 1], sizes[:, 0]], dim=-1)
    out_boxes = torch.where(none[:, None, None], fb_boxes, out_boxes)
    out_scores = torch.where(none[:, None], first.to(out_scores.dtype) * fallback_score,
                             out_scores)
    out_labels = torch.where(none[:, None], torch.zeros_like(out_labels), out_labels)
    out_mask = torch.where(none[:, None], first, mask)
    return Detections(out_boxes, out_scores, out_labels, out_mask)
