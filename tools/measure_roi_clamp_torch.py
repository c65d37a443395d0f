"""Quantify the window RoIAlign approximation of the PyTorch port, the
counterpart of tools/measure_roi_clamp.py.

Measures the fraction of rois flagged by the port's
``ops/roi_align_patch.footprint_clamp_mask`` (i.e. whose bilinear
footprint overflows the 40x48 window of kernels K6/K7 and clamps) under:

  1. an analytic sweep of the (band-position, aspect-ratio) plane — the
     exact boundary of the approximation;
  2. an anchor-shaped random distribution: aspect ratios {0.5, 1, 2}
     (the reference's RPN anchor set) with log-normal jitter (regression
     deltas), log-uniform scales, at the parity eval geometry (800x1344
     canvas);
  3. (--detector) the serving model's own rois: the detections of
     ``serving_model_config()`` (seeded random weights) on four seeded
     random 256x320 images, as the JAX tool takes them.

Usage: python tools/measure_roi_clamp_torch.py [--detector] [--n 200000] [--device cpu]

Flags and printed lines are the JAX tool's; ``--device`` (default
``cuda``, raising without a card) is the port's.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from seam_match_rcnn_tpu_torch.cli._args import add_device_flag, check_device  # noqa: E402
from seam_match_rcnn_tpu_torch.ops.roi_align_patch import footprint_clamp_mask  # noqa: E402

CANVAS = (800, 1344)
LEVEL_SHAPES = tuple((CANVAS[0] // s, CANVAS[1] // s) for s in (4, 8, 16, 32))


def clamp_mask(rois, device="cuda"):
    return footprint_clamp_mask(
        torch.as_tensor(np.asarray(rois, np.float32), device=device), LEVEL_SHAPES,
        output_size=7).cpu().numpy()


def analytic_boundary(device="cuda"):
    """For band positions s_cells in [14, 28), find the smallest aspect that
    clamps (footprint is output_size-independent: out*bin == roi extent)."""
    print("band position (sqrt-area cells at level) -> min clamping aspect")
    s_vals = (14, 16, 18, 20, 22, 24, 26, 27.9)
    aspects = np.exp(np.linspace(0.0, np.log(16.0), 400))
    rois = []
    for s_cells in s_vals:
        s_px = s_cells * 4.0  # place at P2
        h = s_px * np.sqrt(aspects)
        w = s_px / np.sqrt(aspects)
        rois.append(np.stack(
            [np.full_like(h, 600.0), np.full_like(h, 4.0),
             600.0 + w, 4.0 + h], 1))
    mask = clamp_mask(np.concatenate(rois), device).reshape(len(s_vals), -1)
    for s_cells, row in zip(s_vals, mask):
        a = aspects[row][0] if row.any() else float("inf")
        print(f"  s={s_cells:5.1f} cells: aspect >= {a:.2f} clamps "
              f"(footprint {s_cells * np.sqrt(a):.1f} cells)")


def anchor_distribution(n, jitter_sigma):
    rng = np.random.RandomState(0)
    h_img, w_img = CANVAS
    base_aspects = np.asarray([0.5, 1.0, 2.0])[rng.randint(0, 3, n)]
    a = base_aspects * np.exp(rng.randn(n) * jitter_sigma)
    s = np.exp(rng.uniform(np.log(16.0), np.log(800.0), n))
    bh = s * np.sqrt(a)
    bw = s / np.sqrt(a)
    cy = rng.uniform(0, h_img, n)
    cx = rng.uniform(0, w_img, n)
    x1 = np.clip(cx - bw / 2, 0, w_img - 1)
    y1 = np.clip(cy - bh / 2, 0, h_img - 1)
    x2 = np.clip(cx + bw / 2, x1 + 1, w_img)
    y2 = np.clip(cy + bh / 2, y1 + 1, h_img)
    return np.stack([x1, y1, x2, y2], 1).astype(np.float32)


def detector_rois(device="cuda"):
    """Detections of the serving pipeline (its RPN post-NMS proposals through
    the box branch) on seeded random frames."""
    from seam_match_rcnn_tpu_torch.config import serving_model_config
    from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model

    cfg = serving_model_config()
    model = init_model(cfg, video=True, device=device)
    rng = np.random.RandomState(7)
    images = torch.as_tensor(rng.rand(4, 256, 320, 3).astype(np.float32),
                             device=device).permute(0, 3, 1, 2).contiguous()
    sizes = torch.as_tensor([[256, 320]] * 4, dtype=torch.int32, device=device)
    out = model.inference(images, sizes, with_masks=False, with_match=False,
                          with_roi_features=False)
    boxes = out["boxes"].reshape(-1, 4).cpu().numpy()
    valid = out["valid"].reshape(-1).cpu().numpy()
    return boxes[valid]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200000)
    ap.add_argument("--jitter", type=float, default=0.2)
    ap.add_argument("--detector", action="store_true")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = check_device(args.device)

    analytic_boundary(device)

    for sigma in (0.0, args.jitter, 0.4):
        rois = anchor_distribution(args.n, sigma)
        frac = clamp_mask(rois, device).mean()
        print(f"anchor distribution (jitter sigma={sigma}): "
              f"clamp fraction = {frac:.2e}  ({int(frac * args.n)}/{args.n})")

    if args.detector:
        rois = detector_rois(device)
        frac = clamp_mask(rois, device).mean()
        print(f"detector detections ({len(rois)} boxes): "
              f"clamp fraction = {frac:.2e}")


if __name__ == "__main__":
    main()
