"""The one traffic generator: images and ground truth from a traffic mix's
parameters (``traffic/<mix>.json``) and the run's seed.

Garments are drawn as ``seam_match_rcnn_tpu_torch/data/synthetic.py`` draws them
(a copy of its recipe: coloured rectangles over a background of 32, seeded uint8
noise in [0, 20) added with saturation), here on the device in bulk and copied to
the host once, because the port's entries take host images.

The sizes of the work are drawn from the mix's own ``shape_seed``, never from the
run's seed: every seed gets the same set of image sizes, orientations and batch
compositions, in another order and with other pixels, so that runs with
different seeds do the same work."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def rng(seed: int, *stream: int) -> np.random.Generator:
    """An independent stream of the run's seed (any non-negative integer)."""
    return np.random.default_rng([int(seed), *stream])


def _uniform_int(r: np.random.Generator, lo_hi: Sequence[int]) -> int:
    return int(r.integers(lo_hi[0], lo_hi[1] + 1))


def garment_images(specs: List[Tuple[Tuple[int, int], List[Tuple[list, list]]]], seed: int,
                   device) -> List[np.ndarray]:
    """specs: per image its (h, w) and garments [(box x1 y1 x2 y2, rgb)] ->
    HWC uint8 RGB host arrays.  The noise is drawn on ``device`` from the seed."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    out = []
    for (h, w), garments in specs:
        img = torch.full((h, w, 3), 32, dtype=torch.int16, device=device)
        for (x1, y1, x2, y2), color in garments:
            img[y1:y2, x1:x2] = torch.tensor(color, dtype=torch.int16, device=device)
        img += torch.randint(0, 20, (h, w, 3), generator=gen, device=device, dtype=torch.int16)
        out.append(img.clamp_(max=255).to(torch.uint8))
    return [t.cpu().numpy() for t in out]


def _box(r: np.random.Generator, h: int, w: int, lo: float, hi: float) -> list:
    bw = max(8, int(w * r.uniform(lo, hi)))
    bh = max(8, int(h * r.uniform(lo, hi)))
    x1 = int(r.integers(0, w - bw + 1))
    y1 = int(r.integers(0, h - bh + 1))
    return [x1, y1, x1 + bw, y1 + bh]


def _color(r: np.random.Generator) -> list:
    return [int(v) for v in r.integers(64, 255, 3)]


# ---- MovingFashion-shaped products (index mixes) -------------------------------

def product_plan(mix: dict) -> List[dict]:
    """The sizes of every product, from the mix's ``shape_seed``: orientation of
    its frames and its shop image's (h, w)."""
    r = rng(mix["shape_seed"])
    n = mix["calls"] * mix["products_per_call"]
    fh, fw = mix["frame_hw"]
    plan = []
    for _ in range(n):
        portrait = bool(r.random() < mix["portrait_share"])
        shop = (_uniform_int(r, mix["shop_side"]), _uniform_int(r, mix["shop_side"]))
        plan.append({"frame_hw": (fw, fh) if portrait else (fh, fw), "shop_hw": shop})
    return plan


def products(mix: dict, seed: int, device) -> List[List[np.ndarray]]:
    """The mix's calls: each a list of images, per product its shop image then
    its ``frames_per_product`` frames, a garment moving across them.  The seed
    orders the calls and the products in each, and draws every pixel."""
    plan = product_plan(mix)
    per = mix["products_per_call"]
    r = rng(seed, 1)
    calls = []
    for c in r.permutation(mix["calls"]):
        specs = []
        for p in r.permutation(per):
            prod = plan[int(c) * per + int(p)]
            color = _color(r)
            sh, sw = prod["shop_hw"]
            specs.append(((sh, sw), [(_box(r, sh, sw, 0.3, 0.8), color)]))
            fh, fw = prod["frame_hw"]
            a, b = _box(r, fh, fw, 0.2, 0.5), _box(r, fh, fw, 0.2, 0.5)
            t_n = mix["frames_per_product"]
            for t in range(t_n):
                f = t / max(t_n - 1, 1)
                box = [int(round(a[k] + (b[k] - a[k]) * f)) for k in range(4)]
                extra = [(_box(r, fh, fw, 0.1, 0.3), _color(r))
                         for _ in range(_uniform_int(r, mix["distractors_per_frame"]))]
                specs.append(((fh, fw), [(box, color)] + extra))
        calls.append(specs)
    noise_seed = int(rng(seed, 2).integers(0, 2**62))
    return [garment_images(specs, noise_seed + i, device) for i, specs in enumerate(calls)]


# ---- DeepFashion2-shaped phase-1 batches (training mixes) ----------------------

def batch_plan(mix: dict) -> List[List[Tuple[int, int]]]:
    """Every batch's image sizes, from the mix's ``shape_seed``: sides drawn
    from ``side``, each image portrait or landscape with ``portrait_share``."""
    r = rng(mix["shape_seed"])
    plan = []
    for _ in range(mix["batches"]):
        sizes = []
        for _ in range(mix["batch_size"]):
            a, b = sorted((_uniform_int(r, mix["side"]), _uniform_int(r, mix["side"])))
            sizes.append((b, a) if r.random() < mix["portrait_share"] else (a, b))
        plan.append(sizes)
    return plan


def _ellipse(n: int) -> np.ndarray:
    y, x = np.mgrid[0:n, 0:n]
    c = (n - 1) / 2.0
    return ((((x - c) / (n / 2.0)) ** 2 + ((y - c) / (n / 2.0)) ** 2) <= 1.0).astype(np.uint8)


def training_batches(mix: dict, seed: int, device) -> List[Tuple[List[np.ndarray],
                                                                    List[Dict[str, np.ndarray]]]]:
    """The pool of phase-1 batches: (images, targets) as the port's epoch loop
    takes them.  A batch holds ``batch_size // 2`` products, a user and a shop
    image of each; an image holds 1-8 garments, the first the product's (its
    pair id, style 1), the others style 0, with 56x56 mask crops.  The batches
    and their images keep the plan's order whatever the seed: in another order
    the caching allocator's peak moved by 0.6 GiB from seed to seed."""
    plan = batch_plan(mix)
    r = rng(seed, 3)
    crop = _ellipse(mix["mask_crop"])
    pool, specs = [], []
    pair_id = 0
    for sizes in plan:  # in the plan's order: the allocator's peak follows the order
        targets, bspecs = [], []
        for k, (h, w) in enumerate(sizes):
            if k % 2 == 0:
                pair_id += 1
                cat, color = int(r.integers(1, 14)), _color(r)
            n = _uniform_int(r, mix["garments_per_image"])
            boxes = [_box(r, h, w, 0.15, 0.6) for _ in range(n)]
            colors = [color] + [_color(r) for _ in range(n - 1)]
            labels = [cat] + [int(r.integers(1, 14)) for _ in range(n - 1)]
            targets.append({
                "boxes": np.asarray(boxes, np.float32),
                "labels": np.asarray(labels, np.int64),
                "pair_ids": np.full(n, pair_id, np.int64),
                "styles": np.asarray([1] + [0] * (n - 1), np.int64),
                "sources": np.full(n, k % 2, np.int64),  # 0 user (street), 1 shop
                "mask_crops": np.repeat(crop[None], n, 0),
            })
            bspecs.append(((h, w), list(zip(boxes, colors))))
        specs.append(bspecs)
        pool.append(targets)
    noise_seed = int(rng(seed, 4).integers(0, 2**62))
    return [(garment_images(s, noise_seed + i, device), t)
            for i, (s, t) in enumerate(zip(specs, pool))]


def sampler_draws(seed: int, step: int, sizes: Sequence[Tuple[int, int]], device
                  ) -> List[Dict[str, torch.Tensor]]:
    """The two samplers' uniforms of each image of a training step: "rpn"
    [n_anchors] and "roi" [post-NMS proposals + GT slots] (``sizes``, one pair an
    image), one generator an image, so that the rows do not depend on how the
    step buckets its images."""
    out = []
    for i, (n_rpn, n_roi) in enumerate(sizes):
        gen = torch.Generator(device=device).manual_seed(
            int(rng(seed, 5, step, i).integers(0, 2**62)))
        out.append({"rpn": torch.rand(n_rpn, generator=gen, device=device),
                    "roi": torch.rand(n_roi, generator=gen, device=device)})
    return out
