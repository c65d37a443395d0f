"""Multilevel FPN RoIAlign as plain tensor ops — the exact reference.

Frozen copy of ``seam_match_rcnn_tpu_torch/ops/roi_align.py`` (what the benchmark's
plain reference uses of it); it imports nothing of the port.

Port of ``seam_match_rcnn_tpu/ops/roi_align.py`` with torchvision
``aligned=False`` semantics:

* roi coords scaled by the level's spatial scale, *no* half-pixel offset;
* roi width/height floored at 1.0;
* ``sampling_ratio`` x ``sampling_ratio`` bilinear samples per output bin at
  ``start + (bin + (s + 0.5)/ratio) * bin_size``, averaged;
* samples outside [-1, H] give 0; coords clamped to [0, H-1] with the
  torchvision border rule (y_low >= H-1 => y = y_low = y_high = H-1);
* FPN level per roi: ``floor(4 + log2(sqrt(area)/224) + 1e-6)`` clamped to
  [2, 5] (torchvision ``LevelMapper``), levels P2..P5 at scales 1/4..1/32.

This is kernel K2's plain version; autograd transposes it for the reference's
backward.  All levels of the batch are flattened into one channels-last
table so that a roi's image and level become an index offset and one gather
serves every level; rois are processed in chunks to bound the transient
``[chunk, P, P, C]`` buffers.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

SPATIAL_SCALES = (0.25, 0.125, 0.0625, 0.03125)


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    """a / d with IEEE division: on CUDA, PyTorch turns division by a Python
    scalar into multiplication by its reciprocal, which rounds differently
    (by an ulp) from the kernel's and the JAX reference's division."""
    return a / torch.tensor(d, dtype=a.dtype, device=a.device)


def fpn_level_indices(rois: torch.Tensor, num_levels: int = 4,
                      canonical_scale: float = 224.0, canonical_level: int = 4,
                      k_min: int = 2) -> torch.Tensor:
    """torchvision LevelMapper: [..., 4] xyxy rois -> level index in [0, num_levels)."""
    area = ((rois[..., 2] - rois[..., 0]) * (rois[..., 3] - rois[..., 1])).clamp(min=0.0)
    s = torch.sqrt(area)
    lvl = torch.floor(canonical_level + torch.log2(_div(s, canonical_scale) + 1e-12) + 1e-6)
    lvl = lvl.clamp(k_min, k_min + num_levels - 1)
    return (lvl - k_min).to(torch.int64)


def _bilinear_params(coord: torch.Tensor, size: torch.Tensor):
    """torchvision bilinear_interpolate index/weight rule along one axis."""
    in_range = (coord >= -1.0) & (coord <= size)
    c = coord.clamp(min=0.0)
    low = torch.floor(c).to(torch.int64)
    at_border = low >= size - 1
    low = torch.where(at_border, size - 1, low)
    high = torch.where(at_border, size - 1, low + 1)
    c = torch.where(at_border, low.to(c.dtype), c)
    lerp = c - low.to(c.dtype)
    return low, high, 1.0 - lerp, lerp, in_range


def _sample_axis(start, bin_size, out_size: int, ratio: int):
    """Sample coordinates along one axis: [N, out_size * ratio]."""
    idx = torch.arange(out_size * ratio, device=start.device)
    bins = (idx // ratio).to(torch.float32)
    sub = (idx % ratio).to(torch.float32)
    offs = bins * bin_size[:, None] + _div(sub + 0.5, ratio) * bin_size[:, None]
    return start[:, None] + offs


def _roi_geometry(boxes, lvl, heights, widths, scales, output_size: int, ratio: int):
    """Per-roi sample rule of one chunk: row and column indices and weights
    [n, o * ratio] and the in-range mask [n, o * ratio, o * ratio]."""
    scale, h, w = scales[lvl], heights[lvl], widths[lvl]
    x1 = boxes[:, 0] * scale
    y1 = boxes[:, 1] * scale
    roi_w = (boxes[:, 2] * scale - x1).clamp(min=1.0)
    roi_h = (boxes[:, 3] * scale - y1).clamp(min=1.0)
    ys = _sample_axis(y1, _div(roi_h, output_size), output_size, ratio)
    xs = _sample_axis(x1, _div(roi_w, output_size), output_size, ratio)
    ylo, yhi, wylo, wyhi, yin = _bilinear_params(ys, h[:, None])
    xlo, xhi, wxlo, wxhi, xin = _bilinear_params(xs, w[:, None])
    valid = yin[:, :, None] & xin[:, None, :]
    corners = [(ylo, wylo, xlo, wxlo), (ylo, wylo, xhi, wxhi),
               (yhi, wyhi, xlo, wxlo), (yhi, wyhi, xhi, wxhi)]
    return corners, valid


def _level_tables(level_shapes, spatial_scales, dev):
    heights = torch.tensor([s[0] for s in level_shapes], device=dev)
    widths = torch.tensor([s[1] for s in level_shapes], device=dev)
    sizes = [h * w for h, w in level_shapes]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))], device=dev)
    scales = torch.tensor(spatial_scales, dtype=torch.float32, device=dev)
    return heights, widths, offsets, scales, sum(sizes)


def multilevel_roi_align(features: Sequence[torch.Tensor], rois: torch.Tensor,
                         output_size: int, sampling_ratio: int = 2,
                         spatial_scales: Tuple[float, ...] = SPATIAL_SCALES,
                         roi_chunk: int = 512) -> torch.Tensor:
    """features: per level [B, C, H_l, W_l] (P2..P5); rois: [B, R, 4] xyxy in
    image coordinates.  Returns [B*R, C, out, out] in the features' dtype
    (a channels_last view), rois in their natural order, f32 sums."""
    b, r = rois.shape[:2]
    c = features[0].shape[1]
    dtype = features[0].dtype
    dev = rois.device
    o = output_size
    heights, widths, offsets, scales, total = _level_tables(
        [f.shape[2:] for f in features], spatial_scales, dev)
    # one zero row per image: out-of-range samples gather it harmlessly
    table = torch.cat([f.permute(0, 2, 3, 1).reshape(b, -1, c) for f in features]
                      + [torch.zeros((b, 1, c), dtype=dtype, device=dev)], dim=1)
    table = table.reshape(-1, c)

    flat = rois.reshape(-1, 4).to(torch.float32)
    n = flat.shape[0]
    img = torch.arange(b, device=dev).repeat_interleave(r)
    levels = fpn_level_indices(flat, len(features))
    out = torch.empty((n, o, o, c), dtype=dtype, device=dev)
    for s in range(0, n, roi_chunk):
        lvl = levels[s:s + roi_chunk]
        base = img[s:s + roi_chunk] * (total + 1)
        off, w = base + offsets[lvl], widths[lvl]
        zero_row = base + total
        corners, valid = _roi_geometry(flat[s:s + roi_chunk], lvl, heights, widths, scales,
                                       o, sampling_ratio)
        acc = 0
        for yidx, wy, xidx, wx in corners:
            idx = off[:, None, None] + yidx[:, :, None] * w[:, None, None] + xidx[:, None, :]
            idx = torch.where(valid, idx, zero_row[:, None, None])
            acc = acc + table[idx] * (wy[:, :, None] * wx[:, None, :])[..., None]
        pooled = _div(acc.reshape(-1, o, sampling_ratio, o, sampling_ratio, c).sum(dim=(2, 4)),
                      sampling_ratio * sampling_ratio)
        out[s:s + roi_chunk] = pooled.to(dtype)
    return out.permute(0, 3, 1, 2)
