"""DeepFashion2 -> COCO-style JSON converter.

Port of ``seam_match_rcnn_tpu/data/convert.py`` (the reference's
DeepFtoCoco.py): walks the DF2 per-image JSON annotations and emits a single
COCO file with the 13 garment categories, 294-slot keypoints with
per-category ranges, per-annotation ``pair_id``/``style``/``source`` and the
per-image ``match_desc`` style -> pair map.  PIL (for the image sizes) is
imported by ``convert``.
"""

from __future__ import annotations

import json
import os
from glob import glob
from typing import Dict, List, Optional

CATEGORIES = [
    "short_sleeved_shirt", "long_sleeved_shirt", "short_sleeved_outwear",
    "long_sleeved_outwear", "vest", "sling", "shorts", "trousers", "skirt",
    "short_sleeved_dress", "long_sleeved_dress", "vest_dress", "sling_dress",
]

# keypoint slot ranges per category (1-based, inclusive), 294 total
KEYPOINT_RANGES = [
    (1, 25), (26, 58), (59, 89), (90, 128), (129, 143), (144, 158),
    (159, 168), (169, 182), (183, 190), (191, 219), (220, 256),
    (257, 275), (276, 294),
]


def convert(image_dir: str, annos_dir: str, out_path: str,
            limit: Optional[int] = None) -> Dict:
    from PIL import Image

    images: List[Dict] = []
    annotations: List[Dict] = []
    ann_id = 0
    img_files = sorted(glob(os.path.join(image_dir, "*.jpg")))
    if limit is not None:  # `if limit:` would treat an explicit 0 as
        img_files = img_files[:limit]  # "convert everything"
    for img_id, img_path in enumerate(img_files, start=1):
        stem = os.path.splitext(os.path.basename(img_path))[0]
        ann_path = os.path.join(annos_dir, stem + ".json")
        if not os.path.exists(ann_path):
            continue
        with open(ann_path) as f:
            raw = json.load(f)
        with Image.open(img_path) as im:
            width, height = im.size

        match_desc: Dict[str, int] = {}
        source = raw.get("source", "user")
        pair_id = raw.get("pair_id", 0)
        for key, item in raw.items():
            if not key.startswith("item"):
                continue
            cat = item["category_id"]
            lo, hi = KEYPOINT_RANGES[cat - 1]
            # 294 (x, y, v) rows, the category's slot range filled — nested
            # like the reference output (DeepFtoCoco.py:95 points.tolist())
            kps = [[0.0, 0.0, 0.0] for _ in range(294)]
            lms = item.get("landmarks", [])
            for slot, j in enumerate(range(lo - 1, hi)):
                if 3 * slot + 2 < len(lms):
                    kps[j] = list(lms[3 * slot : 3 * slot + 3])
            x1, y1, x2, y2 = item["bounding_box"]
            style = item.get("style", 0)
            ann_id += 1
            annotations.append({
                "id": ann_id,
                "image_id": img_id,
                "category_id": cat,
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "area": max((x2 - x1) * (y2 - y1), 0),
                "segmentation": item.get("segmentation", []),
                "keypoints": kps,
                "num_keypoints": sum(1 for row in kps if row[2] > 0),
                "iscrowd": 0,
                "pair_id": pair_id,
                "style": style,
                "source": source,
            })
            # style-0 entries included like the reference (DeepFtoCoco.py:63);
            # downstream match maps skip key '0' (DF2Dataset.py:92)
            match_desc[str(style)] = pair_id

        images.append({
            "id": img_id,
            "file_name": os.path.basename(img_path),
            "width": width,
            "height": height,
            "source": source,
            "pair_id": pair_id,
            "match_desc": match_desc,
        })

    out = {
        "info": {"description": "DeepFashion2 (converted)"},
        "images": images,
        "annotations": annotations,
        "categories": [
            {"id": i + 1, "name": n, "supercategory": "clothes"}
            for i, n in enumerate(CATEGORIES)
        ],
    }
    with open(out_path, "w") as f:
        json.dump(out, f)
    return out
