"""Joint image/target transforms (host, numpy).

A copy of ``seam_match_rcnn_tpu/data/transforms.py``: the reference's
Compose / ToTensor / RandomHorizontalFlip (stuffs/transform.py), which flips
boxes and masks together, producing numpy HWC float arrays in [0, 1].  The
flip draws from the global ``random`` module, as the JAX version does.
"""

from __future__ import annotations

import random
from typing import Dict

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, image, target):
        for t in self.transforms:
            image, target = t(image, target)
        return image, target


class ToArray:
    """PIL / uint8 array -> float32 HWC in [0, 1] (torchvision ToTensor)."""

    def __call__(self, image, target):
        arr = np.asarray(image)
        if arr.ndim == 2:
            arr = arr[:, :, None].repeat(3, axis=2)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        # copy=False: the uint8 path above already produced a fresh float32
        # buffer — don't duplicate the whole image again per sample
        return arr.astype(np.float32, copy=False), target


class RandomHorizontalFlip:
    def __init__(self, prob: float = 0.5):
        self.prob = prob

    def __call__(self, image: np.ndarray, target: Dict):
        if random.random() < self.prob:
            w = image.shape[1]
            image = image[:, ::-1].copy()
            if target is not None:
                if "boxes" in target and len(target["boxes"]):
                    b = np.asarray(target["boxes"]).copy()
                    b[:, [0, 2]] = w - b[:, [2, 0]]
                    target["boxes"] = b
                if "masks" in target and target["masks"] is not None:
                    target["masks"] = np.ascontiguousarray(
                        np.asarray(target["masks"])[..., ::-1]
                    )
                if "mask_crops" in target and target["mask_crops"] is not None:
                    target["mask_crops"] = np.ascontiguousarray(
                        np.asarray(target["mask_crops"])[..., ::-1]
                    )
                if "keypoints" in target and target["keypoints"] is not None \
                        and len(target["keypoints"]):
                    # Reference flips keypoints through torchvision's COCO
                    # *person* flip (stuffs/transform.py:40-42), whose 17-slot
                    # left/right swap is meaningless for DF2's 294 garment
                    # slots — and dead in practice (keypoint heads are None,
                    # SURVEY §2.2).  Here: mirror x of visible slots, keep
                    # slot identity (no swap), zero slots stay zero.
                    k = np.asarray(target["keypoints"], np.float32).copy()
                    vis = k[..., 2] > 0
                    k[..., 0] = np.where(vis, w - k[..., 0], k[..., 0])
                    target["keypoints"] = k
                if "tracklet" in target and target["tracklet"] is not None:
                    t = np.asarray(target["tracklet"], np.float32).copy()
                    if (t >= 0).all():
                        t[[0, 2]] = w - t[[2, 0]]
                    target["tracklet"] = t
        return image, target
