"""Phase-2 SEAM training: a frozen detector's RoI features feed the heads.

Port of ``seam_match_rcnn_tpu/train/seam.py``.  Per product batch the epoch
loops (``train/engine.py``) run ① the frozen detector without grad, ② the
host-side box selection (``select_rows_host``, a numpy copy of the JAX
package's, and ``engine._best_iou_rows_mdf2``), ③ one head step:

  * ``make_seam_head_step`` (MovingFashion): MatchLossWeak over the match
    predictor's street x shop logits, plus the epoch-gated aggregation loss
    of the temporal aggregator over each product's weak winners;
  * ``make_mdf2_head_step`` (MultiDF2): the aggregation loss alone, over
    host-given sequences; the match predictor stays frozen.

The JAX ``HeadState`` (params, BatchNorm statistics, optimizer state, step)
is here the model's own ``match_predictor`` and ``temporal_aggregator``
modules, trained in place, and a ``train/optim.SGD`` over their parameters;
``merge_head_state``, which writes a trained ``HeadState`` back into the
JAX variable tree, has no counterpart, since nothing is copied out.

As the JAX step, which builds ``MatchPredictor()`` and
``TemporalAggregator()`` with their defaults, a step runs both trunks' convs
in f32 whatever ``MatchHeadConfig.trunk_dtype`` is, and the NLB through the
torch ops (``nlb_backend="xla"``): kernel K3 has no backward.  The weak
selection reads detached logits.  Scatters that JAX writes with
``mode="drop"`` (an invalid group's index k_rows) go to a spare row k_rows
of a padded target, which is then cut off, so row 0 is never set by an
invalid group.

With a mesh, both steps take the global row set over its ``data`` axis, as
the JAX step on data-sharded rows does (tests/test_seam_step.py:150-196):
each rank holds its own rows (``row_img``/``row_det`` into its own
``roi_src``, and the row-indexed ``valid``, ``types``, ``prod``,
``img_slot``) and the product tables of the global batch (``shop_row``,
``seq_gather``, indices into the global rows, rank r's rows following rank
r-1's); ``global_products`` turns rank-local product batches into that
form.  The step gathers every rank's rows and RoI features without grad
(the detector is frozen), applies the skip rule of engine.py:153 to the
gathered rows, so that every rank skips or none does, and runs the update
once over the whole row set on every rank: the heads' compute is
replicated, and the optimizer averages the (equal) gradients over the
ranks, which keeps them bit-equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..losses.match import aggregation_loss, group_argmax, masked_pair_ce
from ..models.match_head import MatchPredictor, TemporalAggregator
from ..parallel.collectives import all_gather
from ..parallel.mesh import axis_group
from .optim import SGD


@dataclasses.dataclass
class SelectedRows:
    """Host-side box selection output (engine.py:130-153), padded to K rows.

    Rows reference detections by (image, detection) index; the actual RoI
    features stay on device and are gathered inside the jitted head step.
    """

    row_img: np.ndarray       # [K] image index of each row
    row_det: np.ndarray       # [K] detection index within the image
    valid: np.ndarray         # [K]
    types: np.ndarray         # [K] 0 street / 1 shop
    prod: np.ndarray          # [K] product index in [0, P)
    img_slot: np.ndarray      # [K] street (product, frame) slot in [0, P*T)
    shop_row: np.ndarray      # [P] row of each product's shop box (-1 none)
    n_products: int
    frames_per_product: int


def select_rows_host(
    outputs: List[Dict[str, np.ndarray]],
    tags: List[int],
    prod_of_image: List[int],
    score_thresh: float,
    n_products: int,
    frames_per_product: int,
    max_rows: int,
) -> Optional[SelectedRows]:
    """engine.py:130-153: per image keep boxes with score >= thresh; a shop
    image keeps only its largest-area box; products whose shop has no box
    are dropped entirely.  Rows are packed into K=max_rows padded slots.

    outputs: per-image dicts with 'scores' [D], 'boxes' [D,4], 'valid' [D]
    (from the jitted inference; roi features stay on device).
    tags: 1 shop / 0 street per image; prod_of_image: product idx per image.
    """
    excluded = set()
    frame_counter: Dict[int, int] = {}
    rows = []  # (img, det, type, prod, img_slot)
    for i, (o, tag, p) in enumerate(zip(outputs, tags, prod_of_image)):
        if p in excluded:
            continue
        keep = np.nonzero((o["scores"] >= score_thresh) & o["valid"])[0]
        if keep.size < 1:
            if tag == 1:
                excluded.add(p)
            continue
        if tag == 1:
            b = o["boxes"][keep]
            areas = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
            keep = keep[[int(np.argmax(areas))]]
            slot = -1
        else:
            f = frame_counter.get(p, 0)
            frame_counter[p] = f + 1
            if f >= frames_per_product:
                continue
            slot = p * frames_per_product + f
        for j in keep:
            rows.append((i, int(j), tag, p, slot))

    # drop rows of retro-excluded products (street images seen before shop)
    rows = [r for r in rows if r[3] not in excluded]
    # truncate BEFORE the skip check: if every shop row falls past
    # max_rows, the step must be skipped (engine.py:153), not run with
    # all-masked losses (which would still advance the optimizer)
    rows = rows[:max_rows]
    types = np.asarray([r[2] for r in rows], np.int32)
    if len(rows) < 2 or not (types == 0).any() or not (types == 1).any():
        return None  # engine.py:153 skips the step

    k = max_rows
    row_img = np.zeros((k,), np.int32)
    row_det = np.zeros((k,), np.int32)
    valid = np.zeros((k,), bool)
    types_p = np.zeros((k,), np.int32)
    prod = np.zeros((k,), np.int32)
    img_slot = np.zeros((k,), np.int32)
    shop_row = np.full((n_products,), -1, np.int32)
    for r, (img, det, tag, p, slot) in enumerate(rows):
        row_img[r] = img
        row_det[r] = det
        valid[r] = True
        types_p[r] = tag
        prod[r] = p
        img_slot[r] = max(slot, 0)
        if tag == 1 and shop_row[p] < 0:
            shop_row[p] = r
    return SelectedRows(
        row_img=row_img, row_det=row_det, valid=valid, types=types_p,
        prod=prod, img_slot=img_slot, shop_row=shop_row,
        n_products=n_products, frames_per_product=frames_per_product,
    )


def takes_step(types) -> bool:
    """engine.py:153's rule over the valid rows' types (0 street, 1 shop):
    a step needs 2 rows, a street one and a shop one."""
    return len(types) >= 2 and bool((types == 0).any()) and bool((types == 1).any())


def global_products(batch: Dict[str, np.ndarray], rank: int, world: int, n_products: int,
                    frames_per_product: int, gather) -> Dict[str, np.ndarray]:
    """A rank-local product batch (``select_rows_host``'s or the MultiDF2
    selection's arrays; products 0..P-1 and rows 0..K-1 of this rank) ->
    the mesh steps' form: products and street slots offset by rank x P and
    rank x P x T, and the product tables (``shop_row``, ``seq_gather``,
    ``seq_mask``) of every rank, concatenated, with their rows offset by
    rank x K.  ``gather`` maps an int64 array to every rank's, stacked."""
    k, p, t = len(batch["row_img"]), n_products, frames_per_product
    out = dict(batch)
    for key, step in (("prod", p), ("img_slot", p * t)):
        if key in out:
            out[key] = out[key] + rank * step
    shop = np.where(batch["shop_row"] >= 0, batch["shop_row"] + rank * k, -1)
    tables = [shop[:, None]]
    if "seq_gather" in batch:
        tables += [batch["seq_gather"] + rank * k, batch["seq_mask"]]
    packed = gather(np.concatenate(tables, 1).astype(np.int64)).reshape(world * p, -1)
    out["shop_row"] = packed[:, 0].astype(np.int32)
    if "seq_gather" in batch:
        out["seq_gather"] = packed[:, 1:1 + t].astype(np.int32)
        out["seq_mask"] = packed[:, 1 + t:].astype(bool)
    return out


# the per-rank entries of a mesh step's batch: its rows' and whether its
# own selection passed the skip rule
_RANK_KEYS = ("valid", "types", "prod", "img_slot", "has_rows")


def _global_rows(roi: torch.Tensor, batch: Dict[str, torch.Tensor], group):
    """Every rank's RoI rows and per-rank entries, in rank order."""
    roi = all_gather(roi, group).flatten(0, 1)
    out = dict(batch)
    for key in _RANK_KEYS:
        if key in batch:
            out[key] = all_gather(batch[key], group).flatten(0, 1)
    return roi, out


def _group_winners(score: torch.Tensor, grp: torch.Tensor, ok: torch.Tensor, num_groups: int):
    """Per group, its argmax row among the ok rows (the first on ties) and
    whether it has one: (winner [G], 0 where none; winner_valid [G];
    seg_max [G])."""
    first, seg_max = group_argmax(score, grp, ok, num_groups)
    winner, seg_max = first[:num_groups], seg_max[:num_groups]
    winner_valid = (winner < score.shape[0]) & torch.isfinite(seg_max)
    return torch.where(winner_valid, winner, torch.zeros_like(winner)), winner_valid, seg_max


def _rows_set(k_rows: int, idx: torch.Tensor) -> torch.Tensor:
    """[k_rows] bool, True at ``idx``; an index of k_rows (an invalid group)
    lands in a spare row that is cut off (JAX's ``mode="drop"``)."""
    out = torch.zeros((k_rows + 1,), dtype=torch.bool, device=idx.device)
    out[idx.to(torch.int64)] = True
    return out[:k_rows]


def build_weak_structures(logits: torch.Tensor, valid: torch.Tensor, types: torch.Tensor,
                          prod: torch.Tensor, img_slot: torch.Tensor, shop_row: torch.Tensor,
                          t_max: int, n_frames: int, match_threshold: float
                          ) -> Dict[str, torch.Tensor]:
    """The weak-supervision structures of MatchLossWeak and the aggregation
    loss: per street (product, frame) slot, its row of highest logit against
    the product's shop is the weak positive if above ``match_threshold``;
    per product the positive frames form its sequence, valid with >=
    ``n_frames`` of them and a shop box.

    logits [K, P, 2] (detached); valid, types, prod, img_slot [K]; shop_row
    [P].  Returns gts [K, P] int64, win_of_row [K], seq_gather and seq_mask
    [P, t_max], seq_ok [P], and ta_bn_valid [K]: the rows the aggregator's
    BatchNorm sees (the winners and the shops of valid products)."""
    k_rows, p_count = logits.shape[0], shop_row.shape[0]
    prod = prod.to(torch.int64)
    shop_ok = shop_row >= 0
    shop_idx = shop_row.clamp(min=0).to(torch.int64)

    street_ok = valid & (types == 0) & shop_ok[prod]
    score = torch.take_along_dim(logits[..., 1], prod[:, None], dim=1)[:, 0]
    winner, winner_valid, seg_max = _group_winners(score, img_slot, street_ok, p_count * t_max)
    winner_pos = winner_valid & (seg_max > match_threshold)

    win_of_row = _rows_set(k_rows, torch.where(winner_pos, winner,
                                               torch.full_like(winner, k_rows)))
    gts = torch.zeros((k_rows, p_count), dtype=torch.int64, device=logits.device)
    gts[torch.arange(k_rows, device=logits.device), prod] = win_of_row.to(torch.int64)

    seq_gather = winner.reshape(p_count, t_max)
    seq_mask = winner_pos.reshape(p_count, t_max)
    seq_ok = (seq_mask.sum(dim=1) >= n_frames) & shop_ok
    ta_bn_valid = win_of_row | _rows_set(
        k_rows, torch.where(seq_ok & shop_ok, shop_idx, torch.full_like(shop_idx, k_rows)))
    return {"gts": gts, "win_of_row": win_of_row, "seq_gather": seq_gather,
            "seq_mask": seq_mask, "seq_ok": seq_ok, "ta_bn_valid": ta_bn_valid}


def _gather_rois(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The selected rows' RoI features [K, 256, 14, 14] f32, gathered from
    the batch's ``roi_src`` [N_images, D, 256, 14, 14]."""
    return batch["roi_src"][batch["row_img"].to(torch.int64),
                            batch["row_det"].to(torch.int64)].to(torch.float32)


def _aggregate_and_score(ta: TemporalAggregator, roi: torch.Tensor, bn_valid: torch.Tensor,
                         seq_gather: torch.Tensor, seq_mask: torch.Tensor,
                         shop_idx: torch.Tensor) -> torch.Tensor:
    """The aggregator's [P, P, 2] logits: its descriptors (BatchNorm over
    ``bn_valid``), each product's masked sequence aggregated through the
    torch ops, scored against the product shops' descriptors."""
    desc = ta.descriptors(roi, valid=bn_valid, train=True, dtype=torch.float32)
    seqs = desc[seq_gather.to(torch.int64)] * seq_mask[..., None].to(desc.dtype)
    agg = ta.aggregate(seqs, seq_mask, nlb_backend="xla")
    return ta.score_pairs(agg, desc[shop_idx])


def make_seam_head_step(match_predictor: MatchPredictor,
                        temporal_aggregator: TemporalAggregator, optimizer: SGD,
                        frames_per_product: int, n_frames: int = 3,
                        match_threshold: float = -10.0, mesh=None):
    """The MovingFashion head step (engine.py:120-198): MatchLossWeak plus
    ``aggr_weight`` x the aggregation loss, one update of ``optimizer``
    (over both heads' parameters).

    ``step(batch)`` takes tensors on the heads' device: roi_src [N, D, 256,
    14, 14], row_img, row_det, valid, types, prod, img_slot [K], shop_row
    [P] (a ``SelectedRows``) and the scalar aggr_weight, and returns the
    detached match_loss, aggregation_loss and their weighted sum, loss.  At
    aggr_weight 0 (epoch 0) the aggregator still runs: its BatchNorm
    statistics move, and its gradients are zeros, on which weight decay
    acts, as in the JAX step.  With ``mesh`` the step is the global row
    set's (see the module's docstring) and returns None where the gathered
    rows fail the skip rule."""
    mp, ta = match_predictor, temporal_aggregator
    group = _distribute(optimizer, mesh)

    def step(batch: Dict[str, torch.Tensor]) -> Optional[Dict[str, torch.Tensor]]:
        optimizer.zero_grad()
        roi = _gather_rois(batch)
        if group is not None:
            roi, batch = _global_rows(roi, batch, group)
            if not takes_step(batch["types"][batch["valid"]]):
                return None
        valid, types, shop_row = batch["valid"], batch["types"], batch["shop_row"]
        shop_ok = shop_row >= 0
        shop_idx = shop_row.clamp(min=0).to(torch.int64)

        desc = mp.descriptors(roi, valid=valid, train=True, dtype=torch.float32)
        logits = mp.score_pairs(desc, desc[shop_idx])  # [K, P, 2]
        ws = build_weak_structures(logits.detach(), valid, types, batch["prod"],
                                   batch["img_slot"], shop_row, frames_per_product, n_frames,
                                   match_threshold)
        street = valid & (types == 0)
        shop = (valid & (types == 1))[shop_idx] & shop_ok
        match_loss = masked_pair_ce(logits, ws["gts"], street[:, None] & shop[None, :])

        agg_logits = _aggregate_and_score(ta, roi, ws["ta_bn_valid"], ws["seq_gather"],
                                          ws["seq_mask"], shop_idx)
        p = shop_row.shape[0]
        agg_l = aggregation_loss(agg_logits, torch.eye(p, dtype=torch.int64, device=roi.device),
                                 ws["seq_ok"], ws["seq_ok"])
        total = match_loss + batch["aggr_weight"] * agg_l
        total.backward()
        optimizer.step()
        return {"match_loss": match_loss.detach(), "aggregation_loss": agg_l.detach(),
                "loss": total.detach()}

    step.optimizer, step.group = optimizer, group
    return step


def _distribute(optimizer: SGD, mesh):
    """The data group of ``mesh`` (None without one), over which
    ``optimizer`` then averages the gradients: every rank computes the
    whole of them from the same gathered rows."""
    group = axis_group(mesh, "data")
    if group is not None:
        optimizer.distribute(group, mean=optimizer.params)
    return group


def make_mdf2_head_step(temporal_aggregator: TemporalAggregator, optimizer: SGD, mesh=None):
    """The MultiDF2 head step (engine.py:202-340): the aggregation loss
    (AggregationMatchLossDF2) over host-given sequences, one update of
    ``optimizer``, which must hold the aggregator's parameters only: the
    match predictor is neither run nor updated nor decayed, and its
    BatchNorm statistics stay.

    ``step(batch)``: roi_src, row_img, row_det as for the MovingFashion
    step, seq_gather and seq_mask [P, T] (rows grouped per product),
    shop_row [P].  A product's sequence counts with >= 3 street views
    (match_head.py:406).  Returns the detached aggregation_loss and loss.
    With ``mesh`` the step is the global row set's, and the batch also
    holds ``has_rows`` [1], whether this rank's own selection (which is
    None below 2 rows, engine.py:295) gave rows; a rank without gives
    none, so the gathered rows number 2 or more exactly where some rank has
    them, and the step returns None where none has."""
    ta = temporal_aggregator
    own = {id(q) for q in ta.parameters()}
    if any(id(q) not in own for q in optimizer.params):
        raise ValueError("make_mdf2_head_step: the optimizer must hold the temporal "
                         "aggregator's parameters only (the match predictor is frozen)")
    group = _distribute(optimizer, mesh)

    def step(batch: Dict[str, torch.Tensor]) -> Optional[Dict[str, torch.Tensor]]:
        optimizer.zero_grad()
        roi = _gather_rois(batch)
        if group is not None:
            roi, batch = _global_rows(roi, batch, group)
            if not bool(batch["has_rows"].any()):
                return None
        shop_row, seq_gather, seq_mask = batch["shop_row"], batch["seq_gather"], batch["seq_mask"]
        shop_ok = shop_row >= 0
        shop_idx = shop_row.clamp(min=0).to(torch.int64)
        seq_ok = seq_mask.sum(dim=1) >= 3

        k_rows = roi.shape[0]
        spare = torch.full_like(seq_gather, k_rows)
        used = _rows_set(k_rows, torch.where(seq_mask, seq_gather, spare).reshape(-1)) \
            | _rows_set(k_rows, torch.where(shop_ok, shop_idx, torch.full_like(shop_idx, k_rows)))
        agg_logits = _aggregate_and_score(ta, roi, used, seq_gather, seq_mask, shop_idx)
        p = seq_gather.shape[0]
        loss = aggregation_loss(agg_logits, torch.eye(p, dtype=torch.int64, device=roi.device),
                                seq_ok, shop_ok)
        loss.backward()
        optimizer.step()
        return {"aggregation_loss": loss.detach(), "loss": loss.detach()}

    step.optimizer, step.group = optimizer, group
    return step


def compare_head_updates(before, want, got, stats=None, rtol: float = 5e-3,
                         stats_tol=(1e-4, 1e-5)):
    """How far one side's head update is from another's, by the rule the
    phase-2 step checks hold the port to (the phase-1 step tests' rule).

    ``before``, ``want`` and ``got`` are flat ``{name: tensor or array}``:
    the heads before the update, and after it on the reference side and on
    the side under test.  ``stats`` names the BatchNorm statistics (default:
    the names holding ``running_``); they need not be in ``before`` and are
    held as ``allclose(got, want, rtol, atol=stats_tol)``.
    ``num_batches_tracked`` is ignored.  Every other name is a parameter,
    held as ||got - want|| <= rtol ||want - before|| + 1e-6 ||the whole
    wanted update||; the second term admits only rounding on a parameter
    whose update is 0.  Returns (the names outside their limit, with their
    error, the worst parameter's error over its size)."""
    def f64(x):
        return (x.detach().cpu().double().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x, np.float64))

    names = [k for k in want if not k.endswith("num_batches_tracked")]
    stats = {k for k in names if "running_" in k} if stats is None else set(stats)
    bad = [f"{k}: missing" for k in names if k not in got]
    bad += [f"{k}: not expected" for k in got
            if k not in want and not k.endswith("num_batches_tracked")]
    upd = {}
    for k in names:
        if k not in got:
            continue
        if k in stats:
            if not np.allclose(f64(got[k]), f64(want[k]), rtol=stats_tol[0], atol=stats_tol[1]):
                bad.append(f"{k}: statistic off by {np.abs(f64(got[k]) - f64(want[k])).max():.3g}")
        else:
            b = f64(before[k])
            upd[k] = (f64(got[k]) - b, f64(want[k]) - b)
    floor = 1e-6 * float(np.sqrt(sum(np.sum(dw ** 2) for _, dw in upd.values())))
    worst = 0.0
    for k, (dg, dw) in upd.items():
        err, size = float(np.linalg.norm(dg - dw)), float(np.linalg.norm(dw))
        if err > rtol * size + floor:
            bad.append(f"{k}: update off by {err:.3g}, its size {size:.3g}")
        if size > floor:
            worst = max(worst, err / size)
    return bad, worst
