"""The phase-1 epoch loop.

Port of ``seam_match_rcnn_tpu/train/engine.py``'s
``train_one_epoch_matchrcnn``: each batch of (images, targets, ids) is
resized on the device and split into canvas buckets by orientation, its GT
is padded to ``g_max`` per image, and ``Phase1Trainer.step`` makes one
update for the whole batch.  A non-finite loss raises (the reference exits).

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
from ..utils.logging import MetricLogger, ScalarWriter


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


def train_one_epoch_matchrcnn(model, trainer, data: Iterable[Tuple[List[np.ndarray],
                                                                   List[Dict], List[int]]],
                              epoch: int, generator: torch.Generator, print_freq: int = 100,
                              writer: Optional[ScalarWriter] = None, g_max: int = 24,
                              steps_per_epoch: Optional[int] = None) -> Dict[str, float]:
    """Phase-1 loop over ``data``, which yields (images, targets, ids)
    batches: HWC images in [0, 1] (or uint8) and per-image target dicts
    (boxes in the image's pixels, labels, pair_ids, styles, sources,
    mask_crops).  ``trainer`` is a ``Phase1Trainer``; its samplers draw from
    ``generator``.  Returns the last step's losses."""
    device = next(model.parameters()).device
    logger = MetricLogger()
    lf: Dict[str, float] = {}
    for count, (images, targets, ids) in enumerate(
            logger.log_every(data, print_freq, f"Epoch: [{epoch}]", total=steps_per_epoch)):
        losses = trainer.step(bucket_batches(model, images, targets, g_max, device), generator)
        lf = {k: float(v) for k, v in losses.items()}
        _check_finite(lf, f"epoch {epoch} step {count} ids {ids}")
        logger.update(**lf)
        if writer is not None and count % print_freq == 0:
            for k, v in lf.items():
                writer.add_scalar(k, v, global_step=trainer.optimizer.count)
    return lf
