"""MultiDeepFashion2: DF2 products as pseudo-videos.

Port of ``seam_match_rcnn_tpu/data/multidf2.py`` (the reference's
datasets/MultiDF2Dataset.py): each ``style_pairid`` product key groups
several street photos ("frames") and shop photos; ``filter_onestreet`` drops
products with fewer than two street views.  Batches are product-grouped as
MovingFashion's: one random shop view and frac-indexed street views, with
optional gaussian noise drawn from the dataset's own rng.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional

import numpy as np
from .df2 import DeepFashion2Dataset


class MultiDeepFashion2Dataset:
    def __init__(
        self,
        ann_file: str,
        root: str,
        noise: bool = False,
        filter_onestreet: bool = True,
        mask_crop_size: int = 56,
        rng: Optional[random.Random] = None,
    ):
        self.base = DeepFashion2Dataset(ann_file, root, transforms=None,
                                        mask_crop_size=mask_crop_size)
        self.noise = noise
        self.rng = rng or random.Random()

        keys = sorted(
            k for k in self.base.match_map_street
            if k in self.base.match_map_shop
        )
        if filter_onestreet:
            keys = [k for k in keys if len(self.base.match_map_street[k]) >= 2]
        self.product_keys = keys

    def __len__(self):
        return len(self.product_keys)

    def _load(self, img_id: int, key: str, tag: int) -> Dict:
        idx = self.base.idx_of_id[img_id]
        img, target, _ = self.base[idx]
        if self.noise:
            # reference noise (MultiDF2Dataset.py:157-167): sigma 0.1 with
            # probability 0.25 else 0.0, applied to shop AND street alike,
            # with the float->uint8 round-trip.  The field comes from a
            # generator seeded off the per-dataset rng (the reference uses
            # the GLOBAL np.random — unreproducible; not copied, same as
            # data/movingfashion.py).
            sigma = 0.1 if self.rng.random() > 0.75 else 0.0
            gen = np.random.default_rng(self.rng.getrandbits(64))
            if sigma:
                img = np.clip(
                    img + gen.standard_normal(img.shape) * sigma, 0.0, 1.0)
            img = (np.round(np.asarray(img, np.float64) * 255.0)
                   .astype(np.uint8).astype(np.float32) / 255.0)
        target = dict(target, i=key, tag=tag, key=key)
        target["image"] = np.asarray(img, np.float32)
        return target

    def shop_view(self, p: int) -> Dict:
        key = self.product_keys[p]
        img_id = self.rng.choice(self.base.match_map_shop[key])
        return self._load(img_id, key, tag=1)

    def street_view(self, p: int, frac: float) -> Dict:
        key = self.product_keys[p]
        streets = self.base.match_map_street[key]
        img_id = streets[min(int(len(streets) * frac), len(streets) - 1)]
        return self._load(img_id, key, tag=0)

    def consume_view_draws(self, p: int, tag: int):
        """Consume exactly the rng draws shop_view/street_view would make,
        without loading images — the mid-epoch-resume fast-forward uses
        this so the surviving batches replay bit-identically (same
        contract as MovingFashionDataset.consume_frame_draws)."""
        if tag == 1:
            self.rng.choice(self.base.match_map_shop[self.product_keys[p]])
        if self.noise:
            self.rng.random()
            self.rng.getrandbits(64)


def product_batches(
    dataset: MultiDeepFashion2Dataset,
    n_products: int,
    frames_per_product: int,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
    num_shards: int = 1,
    shard: int = 0,
    limit: Optional[int] = None,
    drop_last: bool = False,
    skip_batches: int = 0,
) -> Iterator[List[Dict]]:
    rng = random.Random(seed + epoch)
    order = list(range(len(dataset)))
    if shuffle:
        rng.shuffle(order)
    order = order[shard::num_shards]
    if limit is not None:
        order = order[:limit]
    batch: List[Dict] = []
    count = 0
    skipped = 0
    for p in order:
        fracs = sorted(rng.random() for _ in range(frames_per_product))
        if skipped < skip_batches:
            # mid-epoch resume fast-forward: consume BOTH the sampler rng
            # draws (fracs above) and the dataset rng draws (shop choice,
            # noise sigma + field seed) so the remaining batches replay
            # bit-identically, but never load images
            dataset.consume_view_draws(p, tag=1)
            for _ in fracs:
                dataset.consume_view_draws(p, tag=0)
            count += 1
            if count == n_products:
                skipped += 1
                count = 0
            continue
        batch.append(dataset.shop_view(p))
        batch += [dataset.street_view(p, f) for f in fracs]
        count += 1
        if count == n_products:
            yield batch
            batch, count = [], 0
    if batch and not drop_last:
        yield batch
