"""Match losses of phase 1 and phase 2.

Frozen copy of ``seam_match_rcnn_tpu_torch/losses/match.py`` (what the benchmark's plain
reference uses of it); it imports nothing of the port.

Port of ``seam_match_rcnn_tpu/losses/match.py``: cross entropy over a
street x shop pair grid, over its valid pairs.
  * ``match_loss_supervised`` (the reference's ``MatchLossPreTrained``):
    match slots keyed by (pair_id, style), style != 0, with the reference's
    damping (a loss above 1 is halved);
  * ``weak_match_labels`` + ``match_loss_weak`` (``MatchLossWeak``): per
    street image, its box of highest logit against its product's shop is
    the positive, if that logit exceeds the match threshold;
  * ``aggregation_loss`` (the aggregator's CE, class weights 1.0 and 0.3);
  * ``match_loss_df2`` (``MatchLossDF2``): positives where product ids agree.
The segment max and min of the JAX weak labels are ``scatter_reduce`` over
one more group than there are images; masked rows go to that spare group.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .losses_detection import softmax_ce


def masked_pair_ce(logits: torch.Tensor, gts: torch.Tensor, pair_valid: torch.Tensor,
                   class_weights: Tuple[float, float] = (1.0, 1.0)) -> torch.Tensor:
    """Cross entropy over an [N, M, 2] pair grid; the weighted mean divides
    by the summed weights of the targets, as torch's weighted CE does."""
    ce = softmax_ce(logits, gts)
    w = torch.where(gts == 1, torch.full_like(ce, class_weights[1]),
                    torch.full_like(ce, class_weights[0]))
    w = torch.where(pair_valid, w, torch.zeros_like(w))
    return (ce * w).sum() / w.sum().clamp(min=1e-8)


def _damp(loss: torch.Tensor) -> torch.Tensor:
    """The reference's damping: loss > 1 => loss / 2."""
    return torch.where(loss > 1.0, loss / 2.0, loss)


def match_loss_supervised(logits: torch.Tensor, street_pairs: torch.Tensor,
                          street_styles: torch.Tensor, shop_pairs: torch.Tensor,
                          shop_styles: torch.Tensor, street_valid: torch.Tensor,
                          shop_valid: torch.Tensor,
                          require_nonzero_style: bool = True) -> torch.Tensor:
    """logits [N, M, 2]; street_* [N]; shop_* [M].  A pair is positive when
    pair id and style agree (and both styles are non-zero)."""
    same = (street_pairs[:, None] == shop_pairs[None, :]) & (
        street_styles[:, None] == shop_styles[None, :])
    if require_nonzero_style:
        same &= (street_styles[:, None] != 0) & (shop_styles[None, :] != 0)
    valid = street_valid[:, None] & shop_valid[None, :]
    return _damp(masked_pair_ce(logits, same.to(torch.int64), valid))
