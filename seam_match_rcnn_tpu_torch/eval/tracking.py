"""Greedy eval-time tracking (host side).

Re-implementation of the tracklet construction in the MovingFashion eval
(reference evaluate_movingfashion.py:165-214).  The algorithm is
inherently sequential/greedy (SURVEY.md §7.3), so it stays on host; the
self-similarity matrix it consumes is computed on device.

Semantics: repeatedly seed a tracklet with the highest-detection-score
unclaimed box; greedily extend it with the best match-head self-similarity
box from a not-yet-covered frame while the similarity exceeds the tracking
threshold; the tracklet whose boxes best overlap the annotated GT tracklet
(summed per-box max IoU) is selected for scoring — the reference's oracle
selection.

The port's own copy of ``seam_match_rcnn_tpu/eval/tracking.py``: the port imports nothing
of the JAX package.  tests/test_torch_port_copies.py holds the two equal.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def _iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pure-numpy pairwise IoU [Na, Nb] — this module stays host-only; a
    jnp round-trip per product in the eval loop paid device dispatch +
    ~1 MB/s transfers for microseconds of arithmetic."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def build_tracklets(
    self_sim: np.ndarray,
    det_scores: np.ndarray,
    img_of_box: np.ndarray,
    tracking_threshold: float,
) -> List[List[int]]:
    """self_sim: [N, N] match probabilities between the product's street
    boxes; det_scores: [N] detection scores; img_of_box: [N] frame index of
    each box.  Returns tracklets as lists of box indices (into 0..N)."""
    n = self_sim.shape[0]
    unique_imgs = np.unique(img_of_box)
    taken = np.zeros(n, dtype=bool)
    tracklets: List[List[int]] = []
    while not taken.all():
        free = np.nonzero(~taken)[0]
        start = free[np.argmax(det_scores[free])]
        track = [int(start)]
        track_imgs = {int(img_of_box[start])}
        frames_to_check = [i for i in unique_imgs if i not in track_imgs]
        while frames_to_check:
            cand = np.asarray(
                [i for i in range(n)
                 if not taken[i] and i not in track and img_of_box[i] in frames_to_check]
            )
            if cand.size == 0:
                break
            sub = self_sim[np.asarray(track)][:, cand]
            r, c = np.unravel_index(int(np.argmax(sub)), sub.shape)
            if sub[r, c] > tracking_threshold:
                j = int(cand[c])
                track.append(j)
                track_imgs.add(int(img_of_box[j]))
                frames_to_check = [i for i in frames_to_check if i not in track_imgs]
            else:
                break
        for i in track:
            taken[i] = True
        tracklets.append(track)
    return tracklets


def select_tracklet(
    tracklets: Sequence[Sequence[int]],
    boxes: np.ndarray,
    img_of_box: np.ndarray,
    gt_tracklet_per_img: np.ndarray,
) -> int:
    """Oracle tracklet pick (evaluate_movingfashion.py:202-213): summed
    per-box max IoU vs the annotated GT tracklet boxes of each frame.

    The guarded-union IoU scores an unannotated frame's [-1,-1,-1,-1]
    placeholder as 0; the reference's torchvision box_iou yields 0/0 = NaN
    there, making its np.argmax pick the first NaN track arbitrarily —
    documented divergence from a reference bug, not copied."""
    ious = []
    for track in tracklets:
        pred = boxes[np.asarray(track)]
        gt = np.stack([gt_tracklet_per_img[img_of_box[i]] for i in track])
        iou = _iou_xyxy(np.asarray(pred, np.float64),
                        np.asarray(gt, np.float64))
        ious.append(float(np.sum(np.max(iou, axis=-1))))
    return int(np.argmax(np.asarray(ious)))
