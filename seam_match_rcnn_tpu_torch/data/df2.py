"""DeepFashion2 dataset and street/shop pair sampling.

Port of ``seam_match_rcnn_tpu/data/df2.py`` (the reference's
datasets/DF2Dataset.py): COCO-style DF2 annotations with per-image
``match_desc`` (style -> pair_id) maps; images are indexed into street and
shop sides, per-key match maps are built, and only images with a
cross-domain partner survive.  The pair batch sampler emits (street, shop)
image pairs, epoch-seeded and sharded by index as the reference's
distributed sampler.

Targets are numpy dicts: boxes xyxy, contiguous labels, pair_ids, styles,
sources, and fixed-size per-GT mask crops from the port's ``ops/rle``.  PIL
is imported by ``__getitem__``, which decodes, so that the package imports
without it.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List

import numpy as np
from ..ops import rle
from .coco import CocoIndex

MASK_CROP_SIZE = 56


def _match_key(style: str, pair_id) -> str:
    return f"{style}_{pair_id}"


class DeepFashion2Dataset:
    def __init__(
        self,
        ann_file: str,
        root: str,
        transforms=None,
        mask_crop_size: int = MASK_CROP_SIZE,
        with_full_masks: bool = False,
    ):
        self.coco = CocoIndex(ann_file)
        self.root = root
        self.ids = sorted(self.coco.imgs.keys())
        self._transforms = transforms
        self.mask_crop_size = mask_crop_size
        self.with_full_masks = with_full_masks

        cat_ids = self.coco.getCatIds()
        self.cat_to_contiguous = {c: i + 1 for i, c in enumerate(cat_ids)}

        self.street_inds = [i for i in self.ids if self.coco.imgs[i]["source"] == "user"]
        self.shop_inds = [i for i in self.ids if self.coco.imgs[i]["source"] == "shop"]

        # style_pairid-keyed match maps (DF2Dataset.py:85-112)
        self.match_map_street = self._build_match_map(self.street_inds)
        self.match_map_shop = self._build_match_map(self.shop_inds)

        # keep only images whose key exists on the other side (:114-127)
        accepted = []
        for key, imgs in self.match_map_street.items():
            if key in self.match_map_shop:
                accepted += imgs
        for key, imgs in self.match_map_shop.items():
            if key in self.match_map_street:
                accepted += imgs
        self.accepted_entries = sorted(set(accepted))
        self.idx_of_id = {img_id: n for n, img_id in enumerate(self.ids)}

    def _build_match_map(self, img_ids) -> Dict[str, List[int]]:
        out: Dict[str, List[int]] = {}
        for i in img_ids:
            desc = self.coco.imgs[i].get("match_desc", {})
            for style, pair in desc.items():
                if style == "0":
                    continue
                out.setdefault(_match_key(style, pair), []).append(i)
        return out

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx: int):
        from PIL import Image

        img_id = self.ids[idx]
        info = self.coco.imgs[img_id]
        path = os.path.join(self.root, info["file_name"])
        img = Image.open(path).convert("RGB")
        anns = [a for a in self.coco.loadAnns(img_id)
                if a.get("iscrowd", 0) == 0 and a.get("area", 1) != 0]

        boxes, labels, pair_ids, styles, sources, crops, masks = [], [], [], [], [], [], []
        for a in anns:
            x, y, w, h = a["bbox"]
            box = [x, y, x + w, y + h]
            boxes.append(box)
            labels.append(self.cat_to_contiguous[a["category_id"]])
            pair_ids.append(a.get("pair_id", 0))
            styles.append(a.get("style", 0))
            sources.append(0 if a.get("source", "user") == "user" else 1)
            seg = a.get("segmentation")
            if seg:
                crops.append(rle.polygons_to_crop(seg, box, self.mask_crop_size))
                if self.with_full_masks:
                    masks.append(rle.polygons_to_mask(seg, img.height, img.width))
            else:
                crops.append(np.ones((self.mask_crop_size,) * 2, np.uint8))
                if self.with_full_masks:
                    masks.append(np.ones((img.height, img.width), np.uint8))

        target = {
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int32),
            "pair_ids": np.asarray(pair_ids, np.int32),
            "styles": np.asarray(styles, np.int32),
            "sources": np.asarray(sources, np.int32),
            "mask_crops": np.stack(crops) if crops else
                np.zeros((0, self.mask_crop_size, self.mask_crop_size), np.uint8),
            "image_id": img_id,
        }
        if self.with_full_masks:
            target["masks"] = np.stack(masks) if masks else None
        if self._transforms is not None:
            img, target = self._transforms(img, target)
        else:
            img = np.asarray(img, np.float32) / 255.0
        return img, target, img_id

    # pairing helpers (DF2Dataset.py:403-422)
    def partners_in_shop(self, img_id: int) -> List[int]:
        out = []
        for style, pair in self.coco.imgs[img_id].get("match_desc", {}).items():
            out += self.match_map_shop.get(_match_key(style, pair), [])
        return out

    def partners_in_street(self, img_id: int) -> List[int]:
        out = []
        for style, pair in self.coco.imgs[img_id].get("match_desc", {}).items():
            out += self.match_map_street.get(_match_key(style, pair), [])
        return out


class DF2PairBatchSampler:
    """Street/shop pair batches (DF2MatchingSampler, DF2Dataset.py:316-393):
    for each sampled accepted image, pick a random cross-domain partner and
    emit both, until batch_size images are collected."""

    def __init__(
        self,
        dataset: DeepFashion2Dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_shards: int = 1,
        shard: int = 0,
        drop_last: bool = True,
    ):
        assert batch_size % 2 == 0
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_shards = num_shards
        self.shard = shard
        self.drop_last = drop_last

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def shard_entries(self):
        """This process's slice of the (epoch-seeded, shuffled, padded)
        entry list — slices are disjoint across shards except for the
        pad-to-divisible wraparound (DF2Dataset.py:289-307)."""
        entries = list(self.ds.accepted_entries)
        rng = random.Random(self.seed + self.epoch)
        if self.shuffle:
            rng.shuffle(entries)
        n = -(-len(entries) // self.num_shards)
        padded = entries + entries[: n * self.num_shards - len(entries)]
        return rng, padded[self.shard * n : (self.shard + 1) * n]

    def __iter__(self):
        rng, entries = self.shard_entries()
        batch: List[int] = []
        for img_id in entries:
            if self.ds.coco.imgs[img_id]["source"] == "user":
                partners = self.ds.partners_in_shop(img_id)
                pair = (img_id, rng.choice(partners)) if partners else None
            else:
                partners = self.ds.partners_in_street(img_id)
                pair = (rng.choice(partners), img_id) if partners else None
            if pair is None:
                continue
            street, shop = pair
            batch += [self.ds.idx_of_id[street], self.ds.idx_of_id[shop]]
            if len(batch) >= self.batch_size:
                yield batch[: self.batch_size]
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        """Batch-count estimate (exact when every entry has a partner —
        partnerless entries are skipped at iteration time): full batches,
        plus the trailing partial batch when drop_last=False."""
        n = -(-len(self.ds.accepted_entries) // self.num_shards)
        per = self.batch_size // 2
        return n // per if self.drop_last else -(-n // per)
