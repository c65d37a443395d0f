"""Detection losses: Fast R-CNN, Mask R-CNN and RPN.

Port of ``seam_match_rcnn_tpu/losses/detection.py`` (torchvision
``fastrcnn_loss``, ``maskrcnn_loss`` and the RPN's ``compute_loss``), with
masked reductions so padded samples contribute zero and torchvision's
denominators.  The ``*_parts`` functions return unnormalized sums: the
normalizers span the whole training batch, so orientation buckets sum their
parts before dividing (``MatchRCNN.det_losses_from_parts``).  Mask logits
are NCHW, [P, C, 28, 28].
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops import boxes as box_ops
from ..ops.roi_align import multilevel_roi_align
from ..ops.targets import balanced_sample, match_proposals


def smooth_l1(x: torch.Tensor, beta: float = 1.0 / 9.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example cross entropy over the last axis; labels int (pass 0 for
    invalid entries and mask outside)."""
    picked = torch.take_along_dim(logits, labels[..., None].to(torch.int64), dim=-1)[..., 0]
    return torch.logsumexp(logits, dim=-1) - picked


def _bce_with_logits(logit: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    # torch.maximum, not clamp: at a logit of exactly 0 (an all-zero RoI
    # after the ReLUs) its gradient splits 1/2 : 1/2 like jnp.maximum, which
    # makes d/dlogit = sigmoid(0) - y, the true derivative
    zero = torch.zeros_like(logit)
    return torch.maximum(logit, zero) - logit * y + torch.log1p(torch.exp(-logit.abs()))


def fastrcnn_loss_parts(class_logits: torch.Tensor, box_deltas: torch.Tensor,
                        labels: torch.Tensor, regression_targets: torch.Tensor,
                        valid: torch.Tensor):
    """class_logits [N, C]; box_deltas [N, 4C]; labels [N] (0 background);
    regression_targets [N, 4] against the matched GT; valid [N].  Returns
    (cls_sum, box_sum, n_valid)."""
    n, c = class_logits.shape
    safe = torch.where(valid, labels, torch.zeros_like(labels)).to(torch.int64)
    ce = softmax_ce(class_logits, safe)
    cls_sum = torch.where(valid, ce, torch.zeros_like(ce)).sum()
    pos = valid & (labels > 0)
    picked = torch.take_along_dim(box_deltas.reshape(n, c, 4),
                                  safe[:, None, None].expand(n, 1, 4), dim=1)[:, 0]
    l1 = smooth_l1(picked - regression_targets).sum(dim=-1)
    box_sum = torch.where(pos, l1, torch.zeros_like(l1)).sum()
    return cls_sum, box_sum, valid.sum()


def maskrcnn_loss_parts(mask_logits: torch.Tensor, mask_targets: torch.Tensor,
                        labels: torch.Tensor, valid: torch.Tensor):
    """BCE-with-logits on the 28x28 mask of each sample's class: mask_logits
    [P, C, 28, 28], mask_targets [P, 28, 28] in [0, 1], labels [P], valid
    [P].  Returns (bce_sum, n_valid); the loss is bce_sum over n_valid x
    28 x 28 of the whole batch."""
    safe = labels.clamp(min=0).to(torch.int64)
    per_label = torch.take_along_dim(mask_logits, safe[:, None, None, None], dim=1)[:, 0]
    bce = _bce_with_logits(per_label, mask_targets)
    return torch.where(valid[:, None, None], bce, torch.zeros_like(bce)).sum(), valid.sum()


def mask_targets_from_crops(gt_mask_crops: torch.Tensor, gt_boxes: torch.Tensor,
                            proposals: torch.Tensor, matched_idx: torch.Tensor,
                            out_size: int = 28) -> torch.Tensor:
    """Project GT masks onto proposal boxes (torchvision
    ``project_masks_on_boxes`` through fixed-size GT crops): each GT's mask
    is given as an [S, S] crop of its own box, and the proposal is mapped into
    that crop's frame and RoIAligned there (sampling ratio 1).

    gt_mask_crops [B, G, S, S] f32 in [0, 1]; gt_boxes [B, G, 4]; proposals
    [B, P, 4]; matched_idx [B, P].  Returns [B, P, out, out]."""
    b, p = proposals.shape[:2]
    s = gt_mask_crops.shape[-1]
    g = torch.take_along_dim(gt_boxes, matched_idx[..., None], dim=1)
    gw = (g[..., 2] - g[..., 0]).clamp(min=1e-6)
    gh = (g[..., 3] - g[..., 1]).clamp(min=1e-6)
    x1 = (proposals[..., 0] - g[..., 0]) * (s / gw)
    y1 = (proposals[..., 1] - g[..., 1]) * (s / gh)
    x2 = (proposals[..., 2] - g[..., 0]) * (s / gw)
    y2 = (proposals[..., 3] - g[..., 1]) * (s / gh)
    rois = torch.stack([x1, y1, x2, y2], dim=-1).reshape(b * p, 1, 4)
    crops = torch.take_along_dim(gt_mask_crops, matched_idx[..., None, None], dim=1)
    out = multilevel_roi_align([crops.reshape(b * p, 1, s, s)], rois, out_size,
                               sampling_ratio=1, spatial_scales=(1.0,))
    return out.reshape(b, p, out_size, out_size)


def rpn_loss(objectness: torch.Tensor, box_deltas: torch.Tensor, anchors: torch.Tensor,
             gt_boxes: torch.Tensor, gt_valid: torch.Tensor, r: torch.Tensor,
             batch_size_per_image: int, positive_fraction: float, fg_iou: float,
             bg_iou: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image RPN losses of a batch: objectness [B, N], box_deltas [B, N,
    4], anchors [N, 4], gt_boxes [B, G, 4], gt_valid [B, G], r [B, N]
    sampler draws.  Returns (loss_obj [B], loss_box [B]), each over that
    image's sampled anchors."""
    matches = match_proposals(box_ops.box_iou(gt_boxes, anchors), gt_valid, fg_iou, bg_iou,
                              allow_low_quality=True)
    labels = torch.where(matches >= 0, torch.ones_like(matches),
                         torch.where(matches == -1, torch.zeros_like(matches),
                                     torch.full_like(matches, -1)))
    sample = balanced_sample(labels, r, batch_size_per_image, positive_fraction)
    sel = sample.idx
    denom = sample.valid.sum(dim=-1).clamp(min=1)
    # only the sampled rows are encoded
    matched = torch.take_along_dim(matches.clamp(min=0), sel, dim=-1)
    matched_gt = torch.take_along_dim(gt_boxes, matched[..., None], dim=1)
    targets = box_ops.encode_boxes(matched_gt, anchors[sel], (1.0, 1.0, 1.0, 1.0))
    l1 = smooth_l1(torch.take_along_dim(box_deltas, sel[..., None], dim=1) - targets).sum(-1)
    loss_box = torch.where(sample.is_pos, l1, torch.zeros_like(l1)).sum(dim=-1) / denom
    bce = _bce_with_logits(torch.take_along_dim(objectness, sel, dim=-1),
                           sample.is_pos.to(torch.float32))
    loss_obj = torch.where(sample.valid, bce, torch.zeros_like(bce)).sum(dim=-1) / denom
    return loss_obj, loss_box
