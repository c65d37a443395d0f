"""Run-length-encoded masks and polygon rasterization (host side, numpy).

Port of the numpy path of ``seam_match_rcnn_tpu/ops/rle.py`` (pycocotools'
column-major RLE semantics); the JAX package's optional native codec is
part of that package and has no counterpart here.  The polygon helpers
import cv2 when they are called, so that the package imports without it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

RLE = Dict[str, object]  # {"size": [h, w], "counts": list[int] | bytes}


def encode(mask: np.ndarray) -> RLE:
    """Binary [H, W] mask -> uncompressed RLE (column-major runs)."""
    h, w = mask.shape
    # binarize FIRST: a 0/255 uint8 mask must not break run detection or
    # the leading-zero rule below
    flat = np.asfortranarray(mask != 0).astype(np.uint8).reshape(-1, order="F")
    # runs of equal values, starting with count of zeros
    diffs = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], diffs, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def decode(rle: RLE) -> np.ndarray:
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _leb_decode(counts)
    if sum(counts) != h * w:
        raise ValueError(f"invalid RLE counts: sum {sum(counts)} != {h}*{w}")
    flat = np.zeros(h * w, dtype=np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F")


def area(rle: RLE) -> int:
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _leb_decode(counts)
    return int(sum(counts[1::2]))


def to_bbox(rle: RLE) -> np.ndarray:
    """RLE -> [x, y, w, h] tight box."""
    m = decode(rle)
    ys, xs = np.nonzero(m)
    if ys.size == 0:
        return np.zeros(4, np.float32)
    return np.asarray(
        [xs.min(), ys.min(), xs.max() - xs.min() + 1, ys.max() - ys.min() + 1],
        np.float32,
    )


def mask_iou(masks1: Sequence[RLE], masks2: Sequence[RLE]) -> np.ndarray:
    out = np.zeros((len(masks1), len(masks2)), np.float64)
    d1 = [decode(m).astype(bool) for m in masks1]
    d2 = [decode(m).astype(bool) for m in masks2]
    for i, a in enumerate(d1):
        for j, b in enumerate(d2):
            inter = np.logical_and(a, b).sum()
            union = np.logical_or(a, b).sum()
            out[i, j] = inter / union if union else 0.0
    return out


def box_iou_xywh(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """pycocotools-compatible box IoU on xywh boxes -> [N1, N2]."""
    b1 = np.ascontiguousarray(boxes1, np.float64)
    b2 = np.ascontiguousarray(boxes2, np.float64)
    x11, y11 = b1[:, 0], b1[:, 1]
    x12, y12 = b1[:, 0] + b1[:, 2], b1[:, 1] + b1[:, 3]
    x21, y21 = b2[:, 0], b2[:, 1]
    x22, y22 = b2[:, 0] + b2[:, 2], b2[:, 1] + b2[:, 3]
    iw = np.clip(np.minimum(x12[:, None], x22) - np.maximum(x11[:, None], x21), 0, None)
    ih = np.clip(np.minimum(y12[:, None], y22) - np.maximum(y11[:, None], y21), 0, None)
    inter = iw * ih
    a1 = b1[:, 2] * b1[:, 3]
    a2 = b2[:, 2] * b2[:, 3]
    union = a1[:, None] + a2 - inter
    return np.where(union > 0, inter / union, 0.0)


def polygons_to_mask(
    polygons: Sequence[Sequence[float]], height: int, width: int
) -> np.ndarray:
    """COCO polygon segmentation -> binary [H, W] mask."""
    import cv2

    mask = np.zeros((height, width), np.uint8)
    for poly in polygons:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
    return mask


def polygons_to_crop(
    polygons: Sequence[Sequence[float]],
    box_xyxy: Sequence[float],
    size: int,
) -> np.ndarray:
    """Rasterize a polygon segmentation directly into a fixed [size, size]
    crop of ``box_xyxy`` (the GT mask representation of the training step)."""
    import cv2

    x1, y1, x2, y2 = box_xyxy
    w = max(x2 - x1, 1e-6)
    h = max(y2 - y1, 1e-6)
    mask = np.zeros((size, size), np.uint8)
    for poly in polygons:
        pts = np.asarray(poly, np.float64).reshape(-1, 2).copy()
        pts[:, 0] = (pts[:, 0] - x1) * (size / w)
        pts[:, 1] = (pts[:, 1] - y1) * (size / h)
        cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
    return mask


def mask_to_crop(mask: np.ndarray, box_xyxy: Sequence[float], size: int) -> np.ndarray:
    """Binary full-image mask -> fixed-size crop of the box.  The crop is
    box-relative: a box past the image border keeps its out-of-image region
    as zeros at the correct position."""
    x1, y1, x2, y2 = [int(round(v)) for v in box_xyxy]
    x2 = max(x2, x1 + 1)
    y2 = max(y2, y1 + 1)
    hh, ww = mask.shape
    sub = np.zeros((y2 - y1, x2 - x1), np.uint8)
    iy1, iy2 = max(y1, 0), min(y2, hh)
    ix1, ix2 = max(x1, 0), min(x2, ww)
    if iy2 > iy1 and ix2 > ix1:
        sub[iy1 - y1 : iy2 - y1, ix1 - x1 : ix2 - x1] = (
            mask[iy1:iy2, ix1:ix2] != 0)
    if not sub.any():
        return np.zeros((size, size), np.uint8)
    import cv2

    return cv2.resize(sub, (size, size), interpolation=cv2.INTER_NEAREST)


def _leb_decode(s: Union[bytes, str]) -> List[int]:
    """COCO compressed-RLE (LEB128-style) string decoding."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
        if x & (1 << (5 * k - 1)):
            x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts
