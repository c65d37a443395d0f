"""Minimal COCO annotation index.

A copy of ``seam_match_rcnn_tpu/data/coco.py`` (JSON only; the port may not
import the JAX package).  It stands in for ``pycocotools.coco.COCO``, which
the reference's DF2 datasets subclass: ``imgs``, ``getCatIds``, ``cats`` and
the per-image annotation lookup.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List


class CocoIndex:
    def __init__(self, ann_file: str):
        with open(ann_file, "r") as f:
            data = json.load(f)
        self.dataset = data
        self.imgs: Dict[int, Dict[str, Any]] = {im["id"]: im for im in data.get("images", [])}
        self.cats: Dict[int, Dict[str, Any]] = {c["id"]: c for c in data.get("categories", [])}
        self.img_to_anns: Dict[int, List[Dict[str, Any]]] = {i: [] for i in self.imgs}
        for ann in data.get("annotations", []):
            self.img_to_anns.setdefault(ann["image_id"], []).append(ann)

    def getCatIds(self) -> List[int]:
        return sorted(self.cats.keys())

    def getImgIds(self) -> List[int]:
        return sorted(self.imgs.keys())

    def loadAnns(self, img_id: int) -> List[Dict[str, Any]]:
        return self.img_to_anns.get(img_id, [])
