"""Match losses of phase 1 and phase 2.

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

from .detection import softmax_ce


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


def group_argmax(score: torch.Tensor, grp: torch.Tensor, ok: torch.Tensor, num_groups: int):
    """Per group of rows, its row of highest ``score`` among the ``ok`` rows,
    the first on ties (as torch ``argmax``): (first [G + 1] row index, n
    where the group has no ok row; seg_max [G + 1], -inf there).  Rows not
    ok go to the spare group G.  score [N] f32, grp [N] in [0, G), ok [N]."""
    n = score.shape[0]
    score = torch.where(ok, score, torch.full_like(score, -torch.inf))
    g = torch.where(ok, grp, torch.full_like(grp, num_groups)).to(torch.int64)
    seg_max = torch.full((num_groups + 1,), -torch.inf, dtype=score.dtype,
                         device=score.device).scatter_reduce(0, g, score, "amax",
                                                             include_self=False)
    rows = torch.arange(n, device=score.device)
    cand = torch.where(ok & (score == seg_max[g]), rows, torch.full_like(rows, n))
    first = torch.full((num_groups + 1,), n, dtype=rows.dtype,
                       device=score.device).scatter_reduce(0, g, cand, "amin",
                                                           include_self=False)
    return first, seg_max


def weak_match_labels(logits: torch.Tensor, street_img: torch.Tensor,
                      street_shop_col: torch.Tensor, street_valid: torch.Tensor,
                      num_images: int, match_threshold: float = -10.0) -> torch.Tensor:
    """MatchLossWeak's labels: within each street image, the box whose
    logit against its product's shop column is highest is positive, if
    that logit exceeds ``match_threshold``.

    logits [N, M, 2]; street_img [N] image of each row in [0, num_images);
    street_shop_col [N] the shop column of the row's product (-1 none).
    Returns gts [N, M] int64."""
    n, m = logits.shape[:2]
    col = street_shop_col.clamp(min=0).to(torch.int64)
    score = torch.take_along_dim(logits[..., 1], col[:, None], dim=1)[:, 0]
    ok = street_valid & (street_shop_col >= 0)
    first, _ = group_argmax(score, street_img, ok, num_images)
    rows = torch.arange(n, device=logits.device)
    grp = torch.where(ok, street_img.to(torch.int64), torch.full_like(rows, num_images))
    winner = ok & (rows == first[grp]) & (score > match_threshold)
    gts = torch.zeros((n, m), dtype=torch.int64, device=logits.device)
    gts[rows, col] = winner.to(torch.int64)
    return gts


def match_loss_weak(logits: torch.Tensor, gts: torch.Tensor, street_valid: torch.Tensor,
                    shop_valid: torch.Tensor) -> torch.Tensor:
    valid = street_valid[:, None] & shop_valid[None, :]
    return masked_pair_ce(logits, gts, valid)


def aggregation_loss(agg_logits: torch.Tensor, gts: torch.Tensor, seq_valid: torch.Tensor,
                     shop_valid: torch.Tensor) -> torch.Tensor:
    """The aggregator's CE with class weights (1.0, 0.3)."""
    valid = seq_valid[:, None] & shop_valid[None, :]
    return masked_pair_ce(agg_logits, gts, valid, class_weights=(1.0, 0.3))


def match_loss_df2(logits: torch.Tensor, street_prods: torch.Tensor, shop_prods: torch.Tensor,
                   street_valid: torch.Tensor, shop_valid: torch.Tensor) -> torch.Tensor:
    """MatchLossDF2: a pair is positive where the product ids agree."""
    gts = (street_prods[:, None] == shop_prods[None, :]).to(torch.int64)
    valid = street_valid[:, None] & shop_valid[None, :]
    return masked_pair_ce(logits, gts, valid)
