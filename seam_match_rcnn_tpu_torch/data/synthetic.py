"""Synthetic fixture datasets for tests and smoke runs.

Port of ``seam_match_rcnn_tpu/data/synthetic.py``: tiny DeepFashion2-style
and MovingFashion-style datasets, coloured rectangles on seeded noise
standing in for garments, so that the end-to-end paths run without data.
The images are made in numpy (the noise is a saturating uint8 add, equal
bit for bit to the JAX package's ``cv2.add``); cv2 is imported only to
write the ``.jpg`` and ``.mp4`` files.
"""

from __future__ import annotations

import json
import os
import random
from typing import Tuple

import numpy as np


def _garment_image(size, box, color, bg=32, nprng=None):
    img = np.full((size[0], size[1], 3), bg, np.uint8)
    x1, y1, x2, y2 = [int(v) for v in box]
    img[y1:y2, x1:x2] = color
    # seeded noise: fixtures must be bit-identical between runs
    nprng = nprng if nprng is not None else np.random.RandomState(0)
    noise = nprng.randint(0, 20, img.shape).astype(np.uint8)
    return np.minimum(img.astype(np.uint16) + noise, 255).astype(np.uint8)


def make_synthetic_df2(
    out_dir: str, n_products: int = 4, views_per_side: int = 2,
    image_size: Tuple[int, int] = (160, 200), seed: int = 0,
    colors=None,
) -> Tuple[str, str]:
    """DeepFashion2 raw layout: image/ + annos/ per-image JSONs.
    Returns (image_dir, annos_dir)."""
    import cv2

    rng = random.Random(seed)
    nprng = np.random.RandomState(seed)
    img_dir = os.path.join(out_dir, "image")
    ann_dir = os.path.join(out_dir, "annos")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    idx = 0
    for p in range(n_products):
        # optional fixed palette: share product identities between fixtures
        color = (list(colors[p]) if colors is not None
                 else [rng.randrange(64, 255) for _ in range(3)])
        cat = rng.randrange(1, 14)
        for source in ("user", "shop"):
            for _ in range(views_per_side):
                idx += 1
                h, w = image_size
                bw, bh = rng.randrange(40, 80), rng.randrange(50, 90)
                x1 = rng.randrange(0, w - bw)
                y1 = rng.randrange(0, h - bh)
                box = [x1, y1, x1 + bw, y1 + bh]
                img = _garment_image(image_size, box, color, nprng=nprng)
                name = f"{idx:06d}"
                cv2.imwrite(os.path.join(img_dir, name + ".jpg"), img[:, :, ::-1])
                ann = {
                    "source": source,
                    "pair_id": p + 1,
                    "item1": {
                        "category_id": cat,
                        "style": 1,
                        "bounding_box": box,
                        "segmentation": [[box[0], box[1], box[2], box[1],
                                          box[2], box[3], box[0], box[3]]],
                        "landmarks": [],
                    },
                }
                with open(os.path.join(ann_dir, name + ".json"), "w") as f:
                    json.dump(ann, f)
    return img_dir, ann_dir


def make_synthetic_movingfashion(
    out_dir: str, n_products: int = 3, n_frames: int = 12,
    frame_size: Tuple[int, int] = (160, 200), seed: int = 0,
    colors=None,
) -> str:
    """MovingFashion layout: imgs/, videos/ (mp4), and a JSON of the
    MovingFashion schema with tracklets.  Returns the JSON path."""
    import cv2

    rng = random.Random(seed)
    nprng = np.random.RandomState(seed)
    os.makedirs(os.path.join(out_dir, "imgs"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "videos"), exist_ok=True)
    data = {}
    h, w = frame_size
    for p in range(n_products):
        pid = f"prod{p:03d}"
        color = (list(colors[p]) if colors is not None
                 else [rng.randrange(64, 255) for _ in range(3)])
        bw, bh = rng.randrange(40, 70), rng.randrange(50, 80)
        shop_box = [20, 20, 20 + bw, 20 + bh]
        shop = _garment_image(frame_size, shop_box, color, nprng=nprng)
        img_rel = f"imgs/{pid}.jpg"
        cv2.imwrite(os.path.join(out_dir, img_rel), shop[:, :, ::-1])

        vid_rel = f"videos/{pid}.mp4"
        writer = cv2.VideoWriter(
            os.path.join(out_dir, vid_rel),
            cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (w, h),
        )
        tracklet = {}
        for t in range(n_frames):
            x1 = 10 + int((w - bw - 30) * t / max(n_frames - 1, 1))
            y1 = 15 + (t % 3) * 4
            box = [x1, y1, x1 + bw, y1 + bh]
            frame = _garment_image(frame_size, box, color, nprng=nprng)
            writer.write(frame[:, :, ::-1])
            tracklet[str(t)] = box
        writer.release()
        data[pid] = {
            "img_path": img_rel,
            "video_paths": [vid_rel],
            "source": 1 if p % 2 == 0 else 0,
            "tracklets": [tracklet],
        }
    path = os.path.join(out_dir, "data.json")
    with open(path, "w") as f:
        json.dump(data, f)
    return path
