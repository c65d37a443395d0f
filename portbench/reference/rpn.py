"""Region proposal selection.

Frozen copy of ``seam_match_rcnn_tpu_torch/models/rpn.py`` (what the benchmark's plain
reference uses of it); it imports nothing of the port.

Port of ``seam_match_rcnn_tpu/models/rpn.py`` (torchvision
``RegionProposalNetwork`` at test time): per-level top-k -> decode -> clip ->
validity masks -> per-level NMS -> one global top-k padded to
``post_nms_top_n``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .config import RPNConfig
from . import boxes as box_ops
from .nms import nms_kept_mask


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ties in index order, as ``lax.top_k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def flatten_rpn_outputs(objectness: Sequence[torch.Tensor],
                        regressions: Sequence[torch.Tensor]
                        ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """NCHW head outputs [B, A, H, W] / [B, 4A, H, W] -> [B, H*W*A] /
    [B, H*W*A, 4] in (y, x, anchor) order, the order of ``grid_anchors``."""
    logits, deltas = [], []
    for o, r in zip(objectness, regressions):
        b = o.shape[0]
        logits.append(o.permute(0, 2, 3, 1).reshape(b, -1))
        deltas.append(r.permute(0, 2, 3, 1).reshape(b, -1, 4))
    return logits, deltas


def _per_level_nms(boxes, scores, valid, seg_sizes, thresh):
    """NMS inside each contiguous level segment (levels never suppress each
    other), all images and levels in one padded batch -> kept [B, K]."""
    b = boxes.shape[0]
    kmax = max(seg_sizes)
    segs_b, segs_s, segs_v = [], [], []
    off = 0
    for k in seg_sizes:
        pad = kmax - k
        segs_b.append(F.pad(boxes[:, off:off + k], (0, 0, 0, pad)))
        segs_s.append(F.pad(scores[:, off:off + k], (0, pad)))
        segs_v.append(F.pad(valid[:, off:off + k], (0, pad)))
        off += k
    n_lv = len(seg_sizes)
    kept = nms_kept_mask(torch.stack(segs_b, 1).reshape(b * n_lv, kmax, 4),
                         torch.stack(segs_s, 1).reshape(b * n_lv, kmax), thresh,
                         valid=torch.stack(segs_v, 1).reshape(b * n_lv, kmax))
    kept = kept.reshape(b, n_lv, kmax)
    return torch.cat([kept[:, i, :k] for i, k in enumerate(seg_sizes)], dim=1)


def select_proposals(logits: Sequence[torch.Tensor], deltas: Sequence[torch.Tensor],
                     anchors: Sequence[torch.Tensor], image_sizes: torch.Tensor,
                     cfg: RPNConfig, training: bool = False):
    """logits [B, N_l] and deltas [B, N_l, 4] per level (f32), anchors
    [N_l, 4] per level, image_sizes [B, 2] valid (h, w).  Returns proposals
    [B, R, 4], scores [B, R], valid [B, R] with R = post_nms_top_n."""
    pre_n = cfg.pre_nms_top_n(training)
    post_n = cfg.post_nms_top_n(training)
    cand_boxes, cand_scores = [], []
    for lg, dl, anc in zip(logits, deltas, anchors):
        k = min(pre_n, lg.shape[1])
        top_scores, top_idx = topk_stable(lg, k)
        top_deltas = torch.take_along_dim(dl, top_idx[..., None], dim=1)
        cand_boxes.append(box_ops.decode_boxes(top_deltas, anc[top_idx], (1.0, 1.0, 1.0, 1.0)))
        cand_scores.append(top_scores)
    seg_sizes = [c.shape[1] for c in cand_boxes]
    boxes = torch.cat(cand_boxes, dim=1)
    scores = torch.cat(cand_scores, dim=1)

    boxes = box_ops.clip_boxes_to_image(boxes, image_sizes[:, None, :])
    keep = box_ops.small_box_mask(boxes, cfg.min_size)
    # torchvision thresholds the sigmoid probability; ranking stays on logits
    keep &= torch.sigmoid(scores) > cfg.score_thresh
    kept = _per_level_nms(boxes, scores, keep, seg_sizes, cfg.nms_thresh)

    ranked = torch.where(kept, scores, torch.full_like(scores, float("-inf")))
    k = min(post_n, ranked.shape[1])  # tiny canvases: K < post_n
    top_sc, top_idx = topk_stable(ranked, k)
    if k < post_n:
        top_sc = F.pad(top_sc, (0, post_n - k), value=float("-inf"))
        top_idx = F.pad(top_idx, (0, post_n - k))
    mask = top_sc > float("-inf")
    props = torch.take_along_dim(boxes, top_idx[..., None], dim=1)
    return props, torch.take_along_dim(scores, top_idx, dim=1), mask
