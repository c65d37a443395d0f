"""Proposal-to-GT matching and balanced foreground/background sampling.

Frozen copy of ``seam_match_rcnn_tpu_torch/ops/targets.py`` (what the benchmark's plain
reference uses of it); it imports nothing of the port.

Port of ``seam_match_rcnn_tpu/ops/targets.py`` (torchvision ``Matcher`` and
``BalancedPositiveNegativeSampler``) with fixed shapes and validity masks,
batched over a leading image axis.  The sampler's uniform draws are an
argument: the trainer draws them from its ``torch.Generator``, and the
tests hand both packages the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .boxes import box_iou

BELOW_LOW_THRESHOLD = -1
BETWEEN_THRESHOLDS = -2


def match_proposals(quality: torch.Tensor, gt_valid: torch.Tensor, high_threshold: float,
                    low_threshold: float, allow_low_quality: bool = False) -> torch.Tensor:
    """torchvision ``Matcher``: quality [..., G, N] (IoU of padded GTs
    against proposals), gt_valid [..., G] -> matches [..., N]: the GT index,
    or BELOW_LOW_THRESHOLD / BETWEEN_THRESHOLDS.

    ``allow_low_quality`` (the RPN): proposals tying a GT's best quality
    keep their raw match, except for a GT whose best quality is 0 (the JAX
    package's documented divergence from torchvision)."""
    quality = torch.where(gt_valid[..., :, None], quality, torch.full_like(quality, -1.0))
    matched_vals, matches = quality.max(dim=-2)
    matches = matches.to(torch.int64)
    out = torch.where(matched_vals < low_threshold,
                      torch.full_like(matches, BELOW_LOW_THRESHOLD), matches)
    between = (matched_vals >= low_threshold) & (matched_vals < high_threshold)
    out = torch.where(between, torch.full_like(out, BETWEEN_THRESHOLDS), out)
    if allow_low_quality:
        best_per_gt = quality.amax(dim=-1, keepdim=True)
        is_best = (quality == best_per_gt) & gt_valid[..., :, None] & (best_per_gt > 0)
        out = torch.where(is_best.any(dim=-2), matches, out)
    return out


class SampleResult(NamedTuple):
    idx: torch.Tensor     # [..., K] int64 indices into the proposals
    is_pos: torch.Tensor  # [..., K] bool
    valid: torch.Tensor   # [..., K] bool: the slot holds a real sample


def balanced_sample(labels: torch.Tensor, r: torch.Tensor, batch_size: int,
                    positive_fraction: float) -> SampleResult:
    """torchvision ``BalancedPositiveNegativeSampler`` with ``batch_size``
    slots per row.  labels [..., N]: >= 1 positive, 0 negative, -1 ignored;
    r [..., N] uniform draws in [0, 1) that rank the candidates.  Positives
    come first in the slots, then negatives."""
    pos_mask = labels >= 1
    neg_mask = labels == 0
    max_pos = int(batch_size * positive_fraction)
    n_pos = pos_mask.sum(dim=-1, keepdim=True).clamp(max=max_pos)
    n_neg = torch.minimum(neg_mask.sum(dim=-1, keepdim=True), batch_size - n_pos)

    two = torch.full_like(r, 2.0)
    rank = lambda m: torch.argsort(  # noqa: E731
        torch.argsort(torch.where(m, r, two), dim=-1, stable=True), dim=-1, stable=True)
    sel_pos = pos_mask & (rank(pos_mask) < n_pos)
    sel_neg = neg_mask & (rank(neg_mask) < n_neg)
    key = torch.where(sel_pos, 3.0 + r, torch.where(sel_neg, 1.0 + r, r - 10.0))
    # the batch_size largest keys, ties in index order as lax.top_k
    idx = torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :batch_size]
    take = lambda m: torch.take_along_dim(m, idx, dim=-1)  # noqa: E731
    return SampleResult(idx=idx, is_pos=take(sel_pos), valid=take(sel_pos | sel_neg))


def assign_and_sample(proposals: torch.Tensor, proposal_valid: torch.Tensor,
                      gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                      gt_valid: torch.Tensor, r: torch.Tensor, batch_size: int,
                      positive_fraction: float, fg_iou: float, bg_iou: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, SampleResult]:
    """RoI-head training targets for a batch: proposals [B, N, 4] (GTs
    already appended), gt [B, G, ...], r [B, N] -> (matched GT index [B, N],
    labels [B, N]: 0 background, -1 ignored, else the matched GT's class,
    and the sample).  Invalid proposals get label -1 and are never sampled."""
    matches = match_proposals(box_iou(gt_boxes, proposals), gt_valid, fg_iou, bg_iou)
    clamped = matches.clamp(min=0)
    labels = torch.take_along_dim(gt_labels.to(torch.int64), clamped, dim=-1)
    labels = torch.where(matches == BELOW_LOW_THRESHOLD, torch.zeros_like(labels), labels)
    labels = torch.where(matches == BETWEEN_THRESHOLDS, torch.full_like(labels, -1), labels)
    labels = torch.where(proposal_valid, labels, torch.full_like(labels, -1))
    return clamped, labels, balanced_sample(labels, r, batch_size, positive_fraction)
