"""Image ingest of the reference: a frozen copy of the device ingest of
``seam_match_rcnn_tpu_torch/models/transform.py`` (torchvision's
``GeneralizedRCNNTransform``: resize so the min side is 800 unless the max side
would pass 1333, bilinear without antialias, an orientation canvas padded with
the ImageNet mean) and of ``train/engine.py``'s ``pad_targets`` and GT scaling,
for one image at a time."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize_scale(h: int, w: int, cfg) -> float:
    scale = cfg.min_size / min(h, w)
    if scale * max(h, w) > cfg.max_size:
        scale = cfg.max_size / max(h, w)
    return scale


def ingest(image: np.ndarray, cfg, device) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """One HWC uint8 (or [0, 1] float) image -> canvas pixels [1, 3, Hc, Wc]
    f32 in [0, 1] and the resized (h, w)."""
    frames = torch.as_tensor(np.asarray(image)).to(device)[None]
    h, w = frames.shape[1:3]
    x = frames.to(torch.float32)
    if frames.dtype == torch.uint8:
        x = x / 255.0
    x = x.permute(0, 3, 1, 2)
    scale = resize_scale(h, w, cfg)
    nh, nw = int(h * scale), int(w * scale)
    if (nh, nw) != (h, w):
        x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False,
                          antialias=False)
    canvas = cfg.landscape_canvas if nw >= nh else cfg.portrait_canvas
    mean = torch.tensor(cfg.image_mean, dtype=torch.float32, device=device)
    full = mean[None, :, None, None].repeat(1, 1, canvas[0], canvas[1])
    full[:, :, :nh, :nw] = x
    return full, (nh, nw)


def normalize(pixels: torch.Tensor, cfg) -> torch.Tensor:
    mean = torch.tensor(cfg.image_mean, dtype=pixels.dtype, device=pixels.device)
    std = torch.tensor(cfg.image_std, dtype=pixels.dtype, device=pixels.device)
    return (pixels - mean[:, None, None]) / std[:, None, None]


def to_canvas_boxes(boxes: np.ndarray, resized: Tuple[int, int],
                    orig: Tuple[int, int]) -> np.ndarray:
    """Boxes in the original image's pixels -> canvas pixels (per-axis ratios)."""
    ry, rx = resized[0] / orig[0], resized[1] / orig[1]
    return (np.asarray(boxes, np.float64).reshape(-1, 4)
            * np.asarray([rx, ry, rx, ry])).astype(np.float32)


def pad_target(t: Dict[str, np.ndarray], g_max: int) -> Dict[str, np.ndarray]:
    """One image's GT padded to ``g_max`` rows with validity."""
    crop = t["mask_crops"].shape[-1]
    g = min(len(t["boxes"]), g_max)
    out = {"boxes": np.zeros((g_max, 4), np.float32), "labels": np.zeros(g_max, np.int64),
           "valid": np.zeros(g_max, bool), "pair_ids": np.zeros(g_max, np.int64),
           "styles": np.zeros(g_max, np.int64),
           "source": np.int64(int(t["sources"][0]) if len(t["sources"]) else 0),
           "mask_crops": np.zeros((g_max, crop, crop), np.uint8)}
    out["boxes"][:g] = t["boxes"][:g]
    out["labels"][:g] = t["labels"][:g]
    out["valid"][:g] = True
    out["pair_ids"][:g] = t["pair_ids"][:g]
    out["styles"][:g] = t["styles"][:g]
    out["mask_crops"][:g] = t["mask_crops"][:g]
    return out
