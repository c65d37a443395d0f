"""Image ingest: resize, canvas placement, normalization.

Port of ``seam_match_rcnn_tpu/models/transform.py`` (torchvision
``GeneralizedRCNNTransform`` semantics, min side 800 / max side 1333).  The
resize runs on the device with ``F.interpolate(bilinear,
align_corners=False, antialias=False)``, the counterpart of the JAX
``_device_ingest``.  Images land in one of two fixed canvases by
orientation, landscape (800, 1344) or portrait (1344, 800); the padding is
filled with the ImageNet mean so that normalization maps it to exactly 0, as
torchvision's zero padding after normalization.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import TransformConfig


@dataclasses.dataclass
class ImageBatch:
    """One orientation bucket, ready for the model."""

    pixels: torch.Tensor    # [B, 3, Hc, Wc] f32 in [0, 1], on the device
    sizes: np.ndarray       # [B, 2] int32 valid (h, w) in the canvas
    orig_sizes: np.ndarray  # [B, 2] int32 original (h, w)
    indices: List[int]      # positions in the caller's image list


def resize_scale(h: int, w: int, cfg: TransformConfig) -> float:
    scale = cfg.min_size / min(h, w)
    if scale * max(h, w) > cfg.max_size:
        scale = cfg.max_size / max(h, w)
    return scale


def device_ingest(frames: torch.Tensor, cfg: TransformConfig) -> torch.Tensor:
    """Resize + canvas placement of SAME-SIZE frames [B, H, W, 3] (uint8, or
    float in [0, 1]) on their device -> canvas pixels [B, 3, Hc, Wc] f32."""
    b, h, w = frames.shape[:3]
    x = frames.to(torch.float32)
    if frames.dtype == torch.uint8:
        x = x / 255.0
    x = x.permute(0, 3, 1, 2)
    scale = resize_scale(h, w, cfg)
    new_h, new_w = int(h * scale), int(w * scale)
    if (new_h, new_w) != (h, w):
        x = F.interpolate(x, size=(new_h, new_w), mode="bilinear", align_corners=False,
                          antialias=False)
    canvas = cfg.landscape_canvas if new_w >= new_h else cfg.portrait_canvas
    mean = torch.tensor(cfg.image_mean, dtype=torch.float32, device=frames.device)
    full = mean[None, :, None, None].repeat(b, 1, canvas[0], canvas[1])
    full[:, :, :new_h, :new_w] = x
    return full


def batch_images(images: Sequence[np.ndarray], cfg: TransformConfig,
                 device: torch.device) -> List[ImageBatch]:
    """Upload each HWC image ([0, 1] float or uint8, RGB) raw, resize it on
    the device and bucket it by canvas orientation."""
    buckets = {}
    for i, img in enumerate(images):
        h, w = img.shape[:2]
        scale = resize_scale(h, w, cfg)
        nh, nw = int(h * scale), int(w * scale)
        pix = device_ingest(torch.as_tensor(np.asarray(img)).to(device)[None], cfg)
        canvas = cfg.landscape_canvas if nw >= nh else cfg.portrait_canvas
        buckets.setdefault(canvas, []).append((i, pix, (nh, nw), (h, w)))
    out = []
    for items in buckets.values():
        out.append(ImageBatch(
            pixels=torch.cat([it[1] for it in items]),
            sizes=np.asarray([it[2] for it in items], np.int32),
            orig_sizes=np.asarray([it[3] for it in items], np.int32),
            indices=[it[0] for it in items]))
    return out


def normalize(pixels: torch.Tensor, cfg: TransformConfig) -> torch.Tensor:
    """ImageNet normalization of [B, 3, H, W] pixels."""
    mean = torch.tensor(cfg.image_mean, dtype=pixels.dtype, device=pixels.device)
    std = torch.tensor(cfg.image_std, dtype=pixels.dtype, device=pixels.device)
    return (pixels - mean[:, None, None]) / std[:, None, None]


def resize_boxes_back(boxes: np.ndarray, from_hw: Tuple[int, int],
                      to_hw: Tuple[int, int]) -> np.ndarray:
    """torchvision ``resize_boxes``: canvas-space boxes -> original image
    coordinates, with independent per-axis ratios."""
    ry = to_hw[0] / from_hw[0]
    rx = to_hw[1] / from_hw[1]
    return boxes * np.asarray([rx, ry, rx, ry], dtype=boxes.dtype)
