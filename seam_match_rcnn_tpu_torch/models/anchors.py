"""Anchor generation (torchvision ``AnchorGenerator`` semantics).

The reference configures one size per FPN level with ratios (0.5, 1, 2)
(reference models/matchrcnn.py:15).  Anchors are static for a fixed
canvas, so they are computed once per (canvas, feature-shapes) pair and
baked into the jitted program as constants.

The port's own copy of ``seam_match_rcnn_tpu/models/anchors.py``: the port imports nothing
of the JAX package.  tests/test_torch_port_copies.py holds the two equal.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np


@functools.lru_cache(maxsize=None)
def base_anchors(size: float, ratios: Tuple[float, ...]) -> np.ndarray:
    """[A, 4] zero-centered xyxy anchors, rounded like torchvision."""
    ratios_np = np.asarray(ratios, dtype=np.float32)
    h_ratios = np.sqrt(ratios_np)
    w_ratios = 1.0 / h_ratios
    ws = w_ratios * size
    hs = h_ratios * size
    base = np.stack([-ws, -hs, ws, hs], axis=1) / 2.0
    return np.round(base).astype(np.float32)


@functools.lru_cache(maxsize=None)
def grid_anchors(
    canvas_hw: Tuple[int, int],
    feature_shapes: Tuple[Tuple[int, int], ...],
    sizes: Tuple[float, ...],
    ratios: Tuple[float, ...],
) -> Tuple[np.ndarray, ...]:
    """Per-level anchors [H_l * W_l * A, 4] in canvas coordinates.

    Strides follow torchvision: ``canvas // feature_size`` per axis.
    Ordering per level is (y, x, anchor) to match the flattened [H, W, A]
    layout of the RPN head outputs.
    """
    out = []
    for (fh, fw), size in zip(feature_shapes, sizes):
        stride_y = canvas_hw[0] // fh
        stride_x = canvas_hw[1] // fw
        base = base_anchors(size, ratios)  # [A, 4]
        shift_x = np.arange(fw, dtype=np.float32) * stride_x
        shift_y = np.arange(fh, dtype=np.float32) * stride_y
        sx, sy = np.meshgrid(shift_x, shift_y)  # [H, W]
        shifts = np.stack([sx, sy, sx, sy], axis=-1)  # [H, W, 4]
        anchors = shifts[:, :, None, :] + base[None, None, :, :]  # [H, W, A, 4]
        out.append(anchors.reshape(-1, 4))
    return tuple(out)
