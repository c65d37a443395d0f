"""MovingFashion dataset: product-grouped shop image + video frames.

Port of ``seam_match_rcnn_tpu/data/movingfashion.py``.  JSON schema per
product: {product_id: {img_path, video_paths[], source, tracklets[]}}.
Video frames are fetched by temporal fraction (frame index = int(n_frames *
frac), cv2 random-access seek); with ``noise`` a frame gets gaussian noise
(sigma 0.25 w.p. 0.25 else 0.05) and is downscaled by half.  Every random
draw comes from the dataset's ``random.Random``, so one seed replays the
same frames bit for bit, and ``product_batches`` can skip batches without
decoding (``consume_frame_draws``).  cv2 is imported by the functions that
decode, so that the package imports without it.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


class MovingFashionDataset:
    def __init__(
        self,
        jsonpath: str,
        root: str = "",
        noise: bool = True,
        blacklist: Optional[set] = None,
        whitelist: Optional[set] = None,
        rng: Optional[random.Random] = None,
    ):
        with open(jsonpath, "r") as f:
            self.data = json.load(f)
        keys = self.data.keys()
        if blacklist is not None:
            keys = [k for k in keys if k not in blacklist]
        elif whitelist is not None:
            keys = [k for k in keys if k in whitelist]
        self.product_ids = sorted(keys)
        self.root = root
        self.noise = noise
        self.rng = rng or random.Random()

    def __len__(self):
        return len(self.product_ids)

    def shop_image(self, i: int) -> Dict:
        import cv2

        entry = self.data[self.product_ids[i]]
        path = os.path.join(self.root, entry["img_path"])
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:  # missing/corrupt file: name it instead of a
            raise FileNotFoundError(  # 'NoneType not subscriptable' mid-run
                f"shop image unreadable: {path}")
        img = img[:, :, ::-1]  # BGR->RGB
        return {
            "image": np.asarray(img, np.float32) / 255.0,
            "tag": 1,
            "i": i,
            "source": entry.get("source", 1),
            "tracklet": None,
            "key": self.product_ids[i],
        }

    def video_frame(
        self, i: int, frac: float, video_i: Optional[int] = None
    ) -> Dict:
        """Decode the frame at temporal fraction ``frac`` of a product video;
        returns the annotated tracklet box when present."""
        import cv2

        entry = self.data[self.product_ids[i]]
        paths = entry["video_paths"]
        # all rng draws happen UP FRONT, unconditionally, so
        # consume_frame_draws() can keep self.rng aligned during a
        # mid-epoch-resume fast-forward without decoding anything
        vi = self.rng.randrange(len(paths)) if video_i is None else video_i
        if self.noise:
            sigma = 0.25 if self.rng.random() > 0.75 else 0.05
            gen = np.random.default_rng(self.rng.getrandbits(64))
        cap = cv2.VideoCapture(os.path.join(self.root, paths[vi]))
        n_frames = cap.get(cv2.CAP_PROP_FRAME_COUNT)
        index2 = int(n_frames * frac)
        cap.set(cv2.CAP_PROP_POS_FRAMES, index2)
        ok, frame = cap.read()
        cap.release()

        tracklet = np.asarray([-1.0, -1.0, -1.0, -1.0], np.float32)
        tr = entry.get("tracklets")
        if tr is not None and vi < len(tr) and str(index2) in tr[vi]:
            tracklet = np.asarray(tr[vi][str(index2)], np.float32)

        if not ok:
            img = np.zeros((100, 100, 3), np.float32)
        else:
            img = frame[:, :, ::-1].astype(np.float32) / 255.0
            if self.noise:
                # noise field from the per-dataset rng (the reference uses
                # the GLOBAL np.random, MFDataset.py:86 — unreproducible;
                # not copied): same seed -> same frames bit-exactly
                img = np.clip(
                    img + gen.standard_normal(img.shape) * sigma, 0.0, 1.0)
                h, w = img.shape[:2]
                img = cv2.resize(img, (w // 2, h // 2), interpolation=cv2.INTER_LINEAR)
                # reference noise path: float->uint8 round-trip (MFDataset.py:88-89)
                img = np.round(img * 255.0).astype(np.uint8).astype(np.float32) / 255.0

        return {
            "image": img.astype(np.float32),
            "tag": 0,
            "i": i,
            "video_i": vi,
            "frame_index": index2,
            "source": entry.get("source", 1),
            "tracklet": tracklet,
            "key": self.product_ids[i],
        }

    def consume_frame_draws(self, i: int, video_i: Optional[int] = None):
        """Consume exactly the rng draws ``video_frame(i, ...)`` would make,
        without decoding — the mid-epoch-resume fast-forward
        (``product_batches`` skip_batches) uses this so the surviving
        batches replay bit-identically (video choice, noise sigma AND the
        noise field's generator seed all ride on ``self.rng``)."""
        entry = self.data[self.product_ids[i]]
        if video_i is None:
            self.rng.randrange(len(entry["video_paths"]))
        if self.noise:
            self.rng.random()
            self.rng.getrandbits(64)


def product_batches(
    dataset: MovingFashionDataset,
    n_products: int,
    frames_per_product: int,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
    uniform_sampling: bool = False,
    fixed_frames: Optional[Sequence[float]] = None,
    fixed_video_i: Optional[int] = None,
    num_shards: int = 1,
    shard: int = 0,
    limit: Optional[int] = None,
    drop_last: bool = False,
    skip_batches: int = 0,
) -> Iterator[List[Dict]]:
    """MFBatchSampler semantics (MFDataset.py:151-186): per product emit the
    shop image + frames at sorted random (or uniform/fixed) temporal
    fractions; batches group ``n_products`` products.  drop_last=True keeps
    batch shapes static for the jitted training step (the reference trains
    with drop_last=True too, MFDataset.py:127)."""
    rng = random.Random(seed + epoch)
    order = list(range(len(dataset)))
    if shuffle:
        rng.shuffle(order)
    order = order[shard::num_shards]
    if limit is not None:
        order = order[:limit]

    batch: List[Dict] = []
    per_batch = 0
    skipped = 0
    for i in order:
        if fixed_frames is not None:
            fracs = list(fixed_frames)
        elif uniform_sampling:
            # endpoint 1.0 kept for parity: the reference's uniform branch
            # is linspace(0, 1, F) too (MFDataset.py:173); frac 1.0 seeks
            # one past the last frame and yields the reference's 100x100
            # dummy — reference behavior, not a bug to fix here
            fracs = list(np.linspace(0.0, 1.0, frames_per_product))
        else:
            fracs = sorted(rng.random() for _ in range(frames_per_product))
        if skipped < skip_batches:
            # mid-epoch resume fast-forward: consume BOTH the sampler rng
            # draws (fracs above) and the dataset rng draws (video choice,
            # noise sigma + field seed) so the remaining batches replay
            # bit-identically, but never decode
            for _ in fracs:
                dataset.consume_frame_draws(i, fixed_video_i)
            per_batch += 1
            if per_batch == n_products:
                skipped += 1
                per_batch = 0
            continue
        batch.append(dataset.shop_image(i))
        for f in fracs:
            batch.append(dataset.video_frame(i, f, fixed_video_i))
        per_batch += 1
        if per_batch == n_products:
            yield batch
            batch, per_batch = [], 0
    if batch and not drop_last:
        yield batch
