"""The epoch loops of phase 1 and phase 2.

Port of ``seam_match_rcnn_tpu/train/engine.py``.

``train_one_epoch_matchrcnn`` (phase 1): each batch of (images, targets,
ids) is resized on the device and split into canvas buckets by orientation,
its GT is padded to ``g_max`` per image, and ``Phase1Trainer.step`` makes
one update for the whole batch.  As in the JAX engine it also takes the
accumulation triple of ``steps.make_phase1_grad_apply`` (one update a
batch from the buckets' weighted gradients) and a plain per-bucket step
callable (an update a bucket, the legacy form).

``train_one_epoch_movingfashion`` and ``train_one_epoch_multidf2`` (phase
2, SEAM): each product batch runs the frozen detector through an
``InferenceRunner`` that keeps the RoI features on the device (under
``torch.no_grad``, not ``inference_mode``: the head step's backward saves
tensors gathered from them), selects rows on the host, and takes one head
step (``train/seam.py``).  A batch without a usable selection counts but
takes no step, so that a resume's skipped batches stay aligned.

A non-finite loss raises (the reference exits).

Under a process group (``Phase1Trainer(mesh=...)``, the head steps'
``mesh``) each rank iterates its own shard of the data, and the loops step
in lockstep (``parallel.collectives.lockstep``): every rank takes as many
steps as the shortest shard allows, so none waits in a collective the
others never reach.  A phase-2 rank whose own selection is skipped gives no
rows, its products are made global (``seam.global_products``), and the
step decides the skip over the gathered rows, the same on every rank.  The
logged losses are the global batch's, equal on every rank, at the global
step (the optimizer's count), and ``save_fn`` fires on every rank at the
same step (``ckpt/io`` writes from rank 0).

GT boxes are scaled with their image (torchvision's
``GeneralizedRCNNTransform`` does the same): each image's boxes are
multiplied by its own per-axis resize ratio.  The JAX engine copies them
unscaled (F-ref-2 in ROADMAP.md), which pairs resized images with boxes in
the original image's pixels whenever the resize scale is not 1.  Mask crops
are relative to their box and need no scaling.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..models.transform import batch_images
from ..parallel.collectives import all_gather, lockstep
from ..parallel.mesh import reduce_scalars
from ..utils.logging import MetricLogger, ScalarWriter
from ..utils.profiling import annotate
from .seam import global_products, select_rows_host


class NonFiniteLossError(RuntimeError):
    pass


def _check_finite(losses: Dict[str, float], context: str):
    total = sum(float(v) for v in losses.values())
    if not math.isfinite(total):
        raise NonFiniteLossError(f"Loss is {total} at {context}: {losses}")


def pad_targets(targets: List[Dict[str, np.ndarray]], g_max: int,
                crop_size: int) -> Dict[str, np.ndarray]:
    """Pad per-image GT dicts to a [B, G_max, ...] batch with validity."""
    b = len(targets)
    out = {
        "boxes": np.zeros((b, g_max, 4), np.float32),
        "labels": np.zeros((b, g_max), np.int64),
        "valid": np.zeros((b, g_max), bool),
        "pair_ids": np.zeros((b, g_max), np.int64),
        "styles": np.zeros((b, g_max), np.int64),
        "source": np.zeros((b,), np.int64),
        "mask_crops": np.zeros((b, g_max, crop_size, crop_size), np.uint8),
    }
    for i, t in enumerate(targets):
        g = min(len(t["boxes"]), g_max)
        out["boxes"][i, :g] = t["boxes"][:g]
        out["labels"][i, :g] = t["labels"][:g]
        out["valid"][i, :g] = True
        out["pair_ids"][i, :g] = t["pair_ids"][:g]
        out["styles"][i, :g] = t["styles"][:g]
        out["source"][i] = int(t["sources"][0]) if len(t["sources"]) else 0
        out["mask_crops"][i, :g] = t["mask_crops"][:g]
    return out


def bucket_batches(model, images: List[np.ndarray], targets: List[Dict], g_max: int,
                   device) -> List[Dict]:
    """One batch dict per canvas bucket, on ``device``, with each image's GT
    boxes scaled by its (x, y) resize ratios."""
    with annotate("seam.ingest"):
        out = []
        for bucket in batch_images(images, model.cfg.transform, device):
            ratios = bucket.sizes.astype(np.float64) / bucket.orig_sizes  # (ry, rx) per image
            scaled = []
            for i, (ry, rx) in zip(bucket.indices, ratios):
                t = dict(targets[i])
                t["boxes"] = (np.asarray(t["boxes"], np.float64).reshape(-1, 4)
                              * np.asarray([rx, ry, rx, ry])).astype(np.float32)
                scaled.append(t)
            # empty targets still carry (0, S, S) crops, so the crop size is known
            gt = pad_targets(scaled, g_max, scaled[0]["mask_crops"].shape[-1])
            out.append({"images": bucket.pixels,
                        "sizes": torch.as_tensor(bucket.sizes, device=device),
                        "gt": {k: torch.as_tensor(v, device=device) for k, v in gt.items()}})
        return out


def _bucket_step(step_fn, batches: List[Dict], generator: torch.Generator):
    """One batch through the triple or the per-bucket callable -> the
    batch's losses: the triple's are the buckets' summed by weight (the JAX
    engine's), the callable's the last bucket's."""
    lf: Dict[str, float] = {}
    n_total = sum(b["images"].shape[0] for b in batches)
    if isinstance(step_fn, tuple):
        grad_fn, accum_fn, apply_fn = step_fn
        acc = None
        for batch in batches:
            w = batch["images"].shape[0] / n_total
            grads, losses = grad_fn(batch, w, generator)
            acc = grads if acc is None else accum_fn(acc, grads)
            for k, v in losses.items():
                lf[k] = lf.get(k, 0.0) + w * float(v)
        apply_fn(acc)
        return lf
    for batch in batches:
        lf = {k: float(v) for k, v in step_fn(batch, generator).items()}
    return lf


def train_one_epoch_matchrcnn(model, trainer, data: Iterable[Tuple[List[np.ndarray],
                                                                   List[Dict], List[int]]],
                              epoch: int, generator: torch.Generator, print_freq: int = 100,
                              writer: Optional[ScalarWriter] = None, g_max: int = 24,
                              steps_per_epoch: Optional[int] = None, start_step: int = 0,
                              save_every_steps: int = 0, save_fn=None) -> Dict[str, float]:
    """Phase-1 loop over ``data``, which yields (images, targets, ids)
    batches: HWC images in [0, 1] (or uint8) and per-image target dicts
    (boxes in the image's pixels, labels, pair_ids, styles, sources,
    mask_crops).  ``trainer`` is one of the JAX engine's three step forms:
    a ``Phase1Trainer`` (one update a batch with the fused batch's
    semantics), the (grad_fn, accum_fn, apply_fn) triple of
    ``steps.make_phase1_grad_apply`` (each bucket weighted by its share of
    the images, one update a batch, the losses summed by the same weights),
    or a callable ``step(bucket_batch, generator) -> losses`` taking an
    update a bucket (exact only for single-orientation batches).  The
    samplers draw from ``generator``.  Returns the last step's losses.

    Mid-epoch checkpoints (no reference equivalent): ``save_fn(step_in_epoch)``
    runs after every ``save_every_steps`` batches, after the update; the
    caller's closure saves the model, the optimizer and ``generator``'s
    state, and resuming from them with the remaining batches reproduces the
    uninterrupted run.  ``start_step`` offsets the step counter when the
    caller has already skipped that many batches."""
    device = next(model.parameters()).device
    logger = MetricLogger()
    lf: Dict[str, float] = {}
    linked = hasattr(trainer, "step")
    optimizer = getattr(trainer[2] if isinstance(trainer, tuple) else trainer, "optimizer", None)
    for count, (images, targets, ids) in enumerate(
            lockstep(logger.log_every(data, print_freq, f"Epoch: [{epoch}]",
                                      total=steps_per_epoch), getattr(trainer, "group", None)),
            start=start_step):
        batches = bucket_batches(model, images, targets, g_max, device)
        if linked:
            lf = reduce_scalars(trainer.step(batches, generator))
        else:
            lf = _bucket_step(trainer, batches, generator)
        _check_finite(lf, f"epoch {epoch} step {count} ids {ids}")
        logger.update(**lf)
        if writer is not None and count % print_freq == 0:
            for k, v in lf.items():
                writer.add_scalar(k, v, global_step=optimizer.count if optimizer else count)
        if save_fn is not None and save_every_steps > 0 and (count + 1) % save_every_steps == 0:
            save_fn(count)
    return lf


def _mf_batch_to_images(items: List[Dict]) -> Tuple[List[np.ndarray], List[int], List[int]]:
    """A product batch -> images, tags (1 shop, 0 street) and each image's
    product as a dense index 0..P-1 in order of first appearance."""
    images = [it["image"] for it in items]
    tags = [int(it["tag"]) for it in items]
    prods = [int(it["i"]) for it in items]
    uniq = {p: n for n, p in enumerate(dict.fromkeys(prods))}
    return images, tags, [uniq[p] for p in prods]


def _phase2_epoch(runner, data: Iterable[List[Dict]], epoch: int, select, head_step,
                  print_freq: int, writer: Optional[ScalarWriter], start_step: int,
                  save_every_steps: int, save_fn, empty, n_products: int,
                  frames_per_product: int) -> Dict[str, float]:
    """The loop both phase-2 epochs share: ``select(outs, items, tags,
    prods)`` -> a dict of host arrays for the step, or None to skip.  Under
    a mesh (``head_step.group``) a rank whose own selection is None gives
    ``empty()``, the same arrays with no rows, and its ``has_rows`` says
    which; the step then decides the skip over the gathered rows."""
    group = getattr(head_step, "group", None)
    logger = MetricLogger()
    lf: Dict[str, float] = {}
    count = start_step
    for items in lockstep(logger.log_every(data, print_freq, f"Epoch: [{epoch}]"), group):
        images, tags, prods = _mf_batch_to_images(items)
        with torch.no_grad():
            outs, dev = runner.run(images, device_keys=("roi_features",))
        roi = dev["roi_features"]
        sel = select(outs, items, tags, prods)
        if group is not None:
            local = dict(sel if sel is not None else empty(),
                         has_rows=np.asarray([sel is not None]))
            rank, world = torch.distributed.get_rank(group), torch.distributed.get_world_size(group)
            sel = global_products(local, rank, world, n_products, frames_per_product,
                                  lambda a: all_gather(torch.as_tensor(a, device=roi.device),
                                                       group).cpu().numpy())
        losses = None
        if sel is not None:
            batch = {k: torch.as_tensor(v, device=roi.device) for k, v in sel.items()}
            batch["roi_src"] = roi
            losses = head_step(batch)
        if losses is None:
            # count consumed batches without a step, so that a mid-epoch
            # resume's skipped batches stay aligned with the sampler
            count += 1
            continue
        lf = reduce_scalars(losses)
        _check_finite(lf, f"epoch {epoch} step {count}")
        logger.update(**lf)
        if writer is not None and count % print_freq == 0:
            for k, v in lf.items():
                writer.add_scalar(k, v, global_step=head_step.optimizer.count)
        if save_fn is not None and save_every_steps > 0 and (count + 1) % save_every_steps == 0:
            save_fn(count)
        count += 1
    return lf


def train_one_epoch_movingfashion(runner, head_step, data: Iterable[List[Dict]], epoch: int,
                                  n_products: int, frames_per_product: int,
                                  score_thresh: float = 0.7, max_rows: int = 256,
                                  print_freq: int = 20, writer: Optional[ScalarWriter] = None,
                                  start_step: int = 0, save_every_steps: int = 0,
                                  save_fn=None) -> Dict[str, float]:
    """Phase-2 SEAM loop over MovingFashion product batches (engine.py:76-199).

    ``data`` yields lists of items {"image": HWC [0, 1] or uint8, "tag": 1
    shop / 0 street, "i": product id}.  ``runner`` is an ``InferenceRunner``
    over the frozen detector with ``with_roi_features=True`` (the JAX CLI
    also turns off the match and aggregator descriptors); ``head_step`` is
    ``seam.make_seam_head_step``'s.  The aggregation loss weighs
    min(epoch, 1) (engine.py:162).  ``save_fn(step_in_epoch)`` fires after
    every ``save_every_steps`` batches (no reference equivalent); the
    heads and the optimizer are the caller's, trained in place.  Returns
    the last step's losses."""
    aggr_weight = np.float32(min(float(epoch), 1.0))

    def select(outs, items, tags, prods):
        sel = select_rows_host(outs, tags, prods, score_thresh, n_products,
                               frames_per_product, max_rows)
        if sel is None:
            return None
        out = {k: getattr(sel, k) for k in ("row_img", "row_det", "valid", "types", "prod",
                                            "img_slot", "shop_row")}
        out["aggr_weight"] = aggr_weight
        return out

    def empty():
        out = {k: np.zeros((max_rows,), np.int32) for k in ("row_img", "row_det", "types",
                                                             "prod", "img_slot")}
        return dict(out, valid=np.zeros((max_rows,), bool), aggr_weight=aggr_weight,
                    shop_row=np.full((n_products,), -1, np.int32))

    return _phase2_epoch(runner, data, epoch, select, head_step, print_freq, writer,
                         start_step, save_every_steps, save_fn, empty, n_products,
                         frames_per_product)


def _best_iou_rows_mdf2(
    outs: List[Dict[str, np.ndarray]],
    items: List[Dict],
    prods: List[int],
    score_thresh: float,
    n_products: int,
    frames_per_product: int,
    max_rows: int,
):
    """MultiDF2 host selection (engine.py:258-295): within each image the
    detection best overlapping the product's GT box represents the product;
    shop images keep only that box; products whose shop has no detection are
    excluded."""
    from ..ops.rle import box_iou_xywh

    rows = []  # (img, det, tag, prod)
    excluded = set()
    seq_rows: Dict[int, List[int]] = {p: [] for p in range(n_products)}
    shop_row = np.full((n_products,), -1, np.int32)

    for i, (o, it, p) in enumerate(zip(outs, items, prods)):
        if p in excluded:
            continue
        keep = np.nonzero((o["scores"] >= score_thresh) & o["valid"])[0]
        if keep.size < 1:
            if it["tag"] == 1:
                excluded.add(p)
            continue
        style, pair_id = [int(x) for x in it["key"].split("_")]
        gmask = (np.asarray(it["styles"]) == style) & (np.asarray(it["pair_ids"]) == pair_id)
        if not gmask.any():
            continue
        gt_box = np.asarray(it["boxes"])[gmask][:1]
        pb = o["boxes"][keep]
        pb_xywh = np.concatenate([pb[:, :2], pb[:, 2:] - pb[:, :2]], 1)
        gt_xywh = np.concatenate([gt_box[:, :2], gt_box[:, 2:] - gt_box[:, :2]], 1)
        best = keep[int(np.argmax(box_iou_xywh(gt_xywh, pb_xywh)[0]))]
        r = len(rows)
        if r >= max_rows:
            break
        rows.append((i, int(best), it["tag"], p))
        if it["tag"] == 1:
            if shop_row[p] < 0:
                shop_row[p] = r
        else:
            seq_rows[p].append(r)

    # Drop rows of excluded products and REMAP the recorded row indices
    # (seq_rows / shop_row hold pre-filter positions).  With the in-repo
    # sampler a product's shop precedes its street frames, so exclusion
    # always happens before any of its rows are appended and the filter is
    # a no-op — but the function must not depend on batch item order.
    remap: Dict[int, int] = {}
    kept = []
    for old, x in enumerate(rows):
        if x[3] not in excluded:
            remap[old] = len(kept)
            kept.append(x)
    rows = kept
    if len(rows) < 2:
        return None
    k = max_rows
    row_img = np.zeros((k,), np.int32)
    row_det = np.zeros((k,), np.int32)
    for r, (img, det, _, _) in enumerate(rows):
        row_img[r] = img
        row_det[r] = det
    t = frames_per_product
    seq_gather = np.zeros((n_products, t), np.int32)
    seq_mask = np.zeros((n_products, t), bool)
    for p, rws in seq_rows.items():
        if p in excluded:
            continue
        for j, r in enumerate(rws[:t]):
            seq_gather[p, j] = remap[r]
            seq_mask[p, j] = True
    for p in range(n_products):
        if shop_row[p] >= 0 and p not in excluded:
            shop_row[p] = remap[int(shop_row[p])]
    for p in excluded:
        shop_row[p] = -1
        seq_mask[p] = False
    return {
        "row_img": row_img,
        "row_det": row_det,
        "shop_row": shop_row,
        "seq_gather": seq_gather,
        "seq_mask": seq_mask,
    }


def train_one_epoch_multidf2(runner, head_step, data: Iterable[List[Dict]], epoch: int,
                             n_products: int, frames_per_product: int,
                             score_thresh: float = 0.7, max_rows: int = 256,
                             print_freq: int = 20, writer: Optional[ScalarWriter] = None,
                             start_step: int = 0, save_every_steps: int = 0,
                             save_fn=None) -> Dict[str, float]:
    """Phase-2 loop over MultiDF2 product batches (engine.py:202-340): as
    ``train_one_epoch_movingfashion``, with items that also carry the
    image's GT ``key``, ``styles``, ``pair_ids`` and ``boxes``, the rows of
    ``_best_iou_rows_mdf2`` and ``seam.make_mdf2_head_step``'s step."""
    def select(outs, items, tags, prods):
        return _best_iou_rows_mdf2(outs, items, prods, score_thresh, n_products,
                                   frames_per_product, max_rows)

    def empty():
        return {"row_img": np.zeros((max_rows,), np.int32),
                "row_det": np.zeros((max_rows,), np.int32),
                "shop_row": np.full((n_products,), -1, np.int32),
                "seq_gather": np.zeros((n_products, frames_per_product), np.int32),
                "seq_mask": np.zeros((n_products, frames_per_product), bool)}

    return _phase2_epoch(runner, data, epoch, select, head_step, print_freq, writer,
                         start_step, save_every_steps, save_fn, empty, n_products,
                         frames_per_product)
