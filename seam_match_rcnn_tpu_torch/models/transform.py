"""Image ingest: resize, canvas placement, normalization.

Port of ``seam_match_rcnn_tpu/models/transform.py`` (torchvision
``GeneralizedRCNNTransform`` semantics, min side 800 / max side 1333).  Two
ingests: on the device (``batch_images``, ``device_batch_images``) the resize
is ``F.interpolate(bilinear, align_corners=False, antialias=False)``, the
counterpart of the JAX ``_device_ingest``; on the host
(``host_batch_images``) it is the JAX ``batch_images``' cv2 INTER_LINEAR
resize in f32, with one upload a canvas bucket.  The two agree only to
rounding.  Images land in one of two fixed canvases by
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


def resize_image(img: np.ndarray, cfg: TransformConfig) -> np.ndarray:
    """The host resize of one HWC float image in [0, 1] (cv2 INTER_LINEAR
    in f32, torch's ``interpolate(scale_factor=s,
    recompute_scale_factor=True)`` size)."""
    h, w = img.shape[:2]
    scale = resize_scale(h, w, cfg)
    new_h, new_w = int(h * scale), int(w * scale)
    if (new_h, new_w) == (h, w):
        return img.astype(np.float32)
    import cv2

    return cv2.resize(img.astype(np.float32), (new_w, new_h), interpolation=cv2.INTER_LINEAR)


def host_batch_images(images: Sequence[np.ndarray], cfg: TransformConfig,
                      device: torch.device) -> List[ImageBatch]:
    """The JAX ``batch_images``: resize each HWC float [0, 1] RGB image on
    the host, place it in its orientation canvas padded with the ImageNet
    mean, and upload each canvas bucket once."""
    buckets = {}
    for i, img in enumerate(images):
        r = resize_image(img, cfg)
        h, w = r.shape[:2]
        canvas = cfg.landscape_canvas if w >= h else cfg.portrait_canvas
        buckets.setdefault(canvas, []).append((i, r))
    out = []
    for canvas, items in buckets.items():
        pixels = np.empty((len(items), canvas[0], canvas[1], 3), dtype=np.float32)
        pixels[:] = np.asarray(cfg.image_mean, np.float32)
        for j, (_, r) in enumerate(items):
            pixels[j, :r.shape[0], :r.shape[1]] = r
        out.append(ImageBatch(
            pixels=torch.from_numpy(pixels).to(device).permute(0, 3, 1, 2).contiguous(),
            sizes=np.asarray([r.shape[:2] for _, r in items], np.int32),
            orig_sizes=np.asarray([images[i].shape[:2] for i, _ in items], np.int32),
            indices=[i for i, _ in items]))
    return out


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


def device_batch_images(images: Sequence[np.ndarray], cfg: TransformConfig,
                        device: torch.device) -> List[ImageBatch]:
    """The inference runner's batching, as the JAX package's
    ``device_batch_images``: one batch per identical source geometry (h, w),
    in order of first appearance, uploaded raw and resized on the device in
    one call.  Which images share a forward matters where a backend's
    numbers span the batch (the int8 pyramid's scales)."""
    groups = {}
    for i, img in enumerate(images):
        groups.setdefault(tuple(img.shape[:2]), []).append(i)
    out = []
    for (h, w), idxs in groups.items():
        raw = torch.as_tensor(np.stack([np.asarray(images[i]) for i in idxs])).to(device)
        scale = resize_scale(h, w, cfg)
        nh, nw = int(h * scale), int(w * scale)
        out.append(ImageBatch(pixels=device_ingest(raw, cfg),
                              sizes=np.tile(np.asarray([[nh, nw]], np.int32), (len(idxs), 1)),
                              orig_sizes=np.tile(np.asarray([[h, w]], np.int32),
                                                 (len(idxs), 1)),
                              indices=idxs))
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
