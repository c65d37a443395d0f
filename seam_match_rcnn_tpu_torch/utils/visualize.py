"""Debug visualizers (matplotlib, optional).

Port of ``seam_match_rcnn_tpu/utils/visualize.py``: draw street/shop match
pairs, per-frame tracking boxes, and eval tracklets (the reference's
stuffs/utils.py:15-212).  matplotlib is imported, with the ``Agg``
backend, only when a function plots.  Each array argument may also be a
torch tensor on any device; it is copied to the host as numpy at entry.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _np(x):
    """A torch tensor (any device, any dtype) as a numpy array on the host;
    anything else unchanged."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.cpu().numpy()
    return x


def _np_seq(xs):
    return None if xs is None else [_np(x) for x in xs]

def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _draw_boxes(ax, boxes, color, labels=None):
    import matplotlib.patches as patches

    for i, b in enumerate(np.asarray(boxes).reshape(-1, 4)):
        ax.add_patch(patches.Rectangle(
            (b[0], b[1]), b[2] - b[0], b[3] - b[1],
            linewidth=1.5, edgecolor=color, facecolor="none",
        ))
        if labels is not None:
            ax.text(b[0], b[1] - 2, str(labels[i]), color=color, fontsize=7)


def visualize_matches(
    street_img: np.ndarray, shop_img: np.ndarray,
    street_boxes: np.ndarray, shop_boxes: np.ndarray,
    scores: Optional[np.ndarray] = None, out_path: str = "matches.png",
):
    """Side-by-side street/shop pair with boxes and match scores."""
    street_img, shop_img, street_boxes, shop_boxes, scores = (
        _np(x) for x in (street_img, shop_img, street_boxes, shop_boxes, scores))
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(10, 5))
    axes[0].imshow(np.clip(street_img, 0, 1))
    axes[1].imshow(np.clip(shop_img, 0, 1))
    lbl = None
    if scores is not None:
        s = np.asarray(scores)
        if s.ndim == 2:  # [N_street, N_shop] pairwise matrix: label each
            s = s.max(axis=1)  # street box with its best shop score
        n = np.asarray(street_boxes).reshape(-1, 4).shape[0]
        if s.shape[0] != n:
            raise ValueError(
                f"scores has {s.shape[0]} entries for {n} street boxes")
        lbl = [f"{v:.2f}" for v in s]
    _draw_boxes(axes[0], street_boxes, "lime", lbl)
    _draw_boxes(axes[1], shop_boxes, "red")
    for ax in axes:
        ax.axis("off")
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out_path


def visualize_tracking(
    frames: Sequence[np.ndarray],
    boxes_per_frame: Sequence[np.ndarray],
    tracklet_ids: Optional[Sequence[np.ndarray]] = None,
    out_path: str = "tracking.png",
    max_frames: int = 10,
):
    """Grid of frames with per-tracklet colored boxes."""
    frames, boxes_per_frame, tracklet_ids = (
        _np_seq(x) for x in (frames, boxes_per_frame, tracklet_ids))
    plt = _plt()
    n = min(len(frames), max_frames)
    fig, axes = plt.subplots(1, n, figsize=(3 * n, 3))
    if n == 1:
        axes = [axes]
    colors = ["lime", "red", "cyan", "yellow", "magenta", "orange"]
    for i in range(n):
        axes[i].imshow(np.clip(frames[i], 0, 1))
        bs = np.asarray(boxes_per_frame[i]).reshape(-1, 4)
        ids = (np.asarray(tracklet_ids[i]).ravel()
               if tracklet_ids is not None else np.zeros(len(bs), int))
        for b, t in zip(bs, ids):
            _draw_boxes(axes[i], b[None], colors[int(t) % len(colors)])
        axes[i].axis("off")
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out_path


def visualize_tracking_eval(
    images: Sequence[np.ndarray],
    boxes_per_image: Sequence[np.ndarray],
    cls_per_image: Sequence[np.ndarray],
    out_path: str = "tracking_eval.png",
    rows: int = 1,
):
    """Eval-tracklet grid: every image's boxes colored by class/track id
    (reference ``visualize_tracking_eval``,
    /root/reference/stuffs/utils.py:184-212 — same row/column layout and
    per-class color cycling)."""
    import math

    images, boxes_per_image, cls_per_image = (
        _np_seq(x) for x in (images, boxes_per_image, cls_per_image))
    plt = _plt()
    n = len(images)
    spr = rows
    spc = n if rows == 1 else int(math.ceil(n / rows))
    fig, axes = plt.subplots(spr, spc, figsize=(3 * spc, 3 * spr))
    axes = np.asarray(axes).reshape(-1)
    colors = ["red", "green", "blue", "cyan", "yellow", "magenta",
              "black", "white"] * 10
    for i in range(n):
        axes[i].imshow(np.clip(images[i], 0, 1))
        bs = np.asarray(boxes_per_image[i]).reshape(-1, 4)
        cs = np.asarray(cls_per_image[i]).ravel()
        for b, c in zip(bs, cs):
            _draw_boxes(axes[i], b[None], colors[int(c) % len(colors)])
        axes[i].axis("off")
    for j in range(n, len(axes)):
        axes[j].axis("off")
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out_path
