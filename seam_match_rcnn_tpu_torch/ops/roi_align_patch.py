"""Patch-window RoIAlign as plain tensor ops: the function of kernels K6
(bf16/f32 features) and K7 (int8 features), and their geometry.

Port of the jax-side parts of ``seam_match_rcnn_tpu/ops/pallas_roi_align.py``
(``_prep_scalars``, ``footprint_clamp_mask``, ``_interp_matrix``,
``quantize_features_int8``, ``apply_exact_fixup``) and of the function that
``pallas_roi_align_batched`` computes.  Semantics are torchvision
``aligned=False`` RoIAlign (see ``ops/roi_align.py``) inside a window of
``PATCH`` x ``PATCH_W`` cells of the roi's FPN level: the window starts one
cell above and left of the roi (its x origin rounded down to a multiple of 8
in the coordinates of a pyramid padded by one cell), and samples beyond the
window clamp to its last row or column.  Rois whose sample footprint
overflows the window (``footprint_clamp_mask``) differ from the exact
``multilevel_roi_align``; ``apply_exact_fixup`` recomputes up to a budget of
them with the exact path.

Bilinear sampling and the ``sampling_ratio``-squared average pool form one
pooling operator per roi, ``W_y (x) W_x`` over the window, rounded as the TPU
kernel rounds it: bf16 features take W_y and W_x in bf16 and each Kronecker
entry rounded to bf16; f32 features take the f32 product; int8 features take
``clip(round(127 * wy * wx))`` as int8, an exact integer sum, then
``* ((1/127) * scale[level, c])``.  Sums are f32 (int32 for int8), rounded
to the output dtype once.  Where XLA's compilation of the TPU kernel's
arithmetic (run on the CPU) fuses a multiply-add or folds constants, the
plain version does the same, so that it matches that kernel bit for bit
but for the order of the f32 sums.  The plain version forms that operator densely and
contracts it with the gathered window (``roi_chunk`` rois at a time); the
kernels (``ops/cuda_roi_align.roi_align_patch``) take it for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .roi_align import SPATIAL_SCALES, _div, fpn_level_indices

PATCH = 40     # window rows
PATCH_W = 48   # window columns: 40 + 8 of slack for the 8-aligned x origin


def patch_geometry(rois: torch.Tensor, level_shapes: Sequence[Tuple[int, int]],
                   spatial_scales: Sequence[float], output_size: int):
    """Per-roi window and sample geometry of flat [N, 4] rois (``_prep_scalars``).

    Returns (lvl [N] int64, y0 [N], x0 [N] int64: the image row and column of
    window cell (0, 0), which may be -1; geom [N, 8] f32: sample-grid origin
    (sy, sx) and bin sizes (bin_h, bin_w) in window coordinates, then the
    image's in-range bounds (ymin, ymax, xmin, xmax) in the same frame)."""
    dev = rois.device
    heights = torch.tensor([float(s[0]) for s in level_shapes], device=dev)
    widths = torch.tensor([float(s[1]) for s in level_shapes], device=dev)
    scales = torch.tensor(spatial_scales, dtype=torch.float32, device=dev)
    rois = rois.to(torch.float32)
    lvl = fpn_level_indices(rois, len(level_shapes))
    sc, h, w = scales[lvl], heights[lvl], widths[lvl]
    x1 = rois[:, 0] * sc
    y1 = rois[:, 1] * sc
    roi_w = (rois[:, 2] * sc - x1).clamp(min=1.0)
    roi_h = (rois[:, 3] * sc - y1).clamp(min=1.0)
    # the TPU kernel's geometry is jitted, and XLA turns the division by the
    # constant output size into a product with its f32 reciprocal
    inv = torch.tensor(float(np.float32(1.0) / np.float32(output_size)), device=dev)
    bin_w = roi_w * inv
    bin_h = roi_h * inv
    # window origin one cell above the first sample, inside [-1, size - 1]
    y0 = torch.minimum((torch.floor(y1) - 1.0).clamp(min=-1.0), (h - 1.0).clamp(min=0.0))
    x0 = torch.minimum((torch.floor(x1) - 1.0).clamp(min=-1.0), (w - 1.0).clamp(min=0.0))
    # the TPU kernel's DMA needs an 8-aligned column start in the padded
    # pyramid (one leading cell): round it down, the sample grid absorbs it
    x0 = torch.div((x0 + 1.0).to(torch.int64), 8, rounding_mode="floor") * 8 - 1
    x0f = x0.to(torch.float32)
    geom = torch.stack([y1 - y0, x1 - x0f, bin_h, bin_w,
                        -1.0 - y0, h - y0, -1.0 - x0f, w - x0f], dim=1)
    return lvl, y0.to(torch.int64), x0, geom


def footprint_clamp_mask(rois: torch.Tensor, level_shapes: Sequence[Tuple[int, int]],
                         spatial_scales: Sequence[float] = SPATIAL_SCALES,
                         output_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """[..., 4] rois -> [...] bool: True where the window cannot hold the
    roi's bilinear footprint, i.e. where the patch-window function differs
    from the exact one.  Overflow beyond the image border is not flagged
    (both clamp there alike)."""
    shape = rois.shape[:-1]
    _, _, _, g = patch_geometry(rois.reshape(-1, 4), level_shapes, spatial_scales,
                                output_size)
    # last sub-sample coordinate: start + out * bin - bin * 0.5 / ratio
    cy = g[:, 0] + output_size * g[:, 2] - _div(g[:, 2] * 0.5, sampling_ratio)
    cx = g[:, 1] + output_size * g[:, 3] - _div(g[:, 3] * 0.5, sampling_ratio)
    cy = torch.minimum(cy, g[:, 5] - 1.0)
    cx = torch.minimum(cx, g[:, 7] - 1.0)
    return ((cy > PATCH - 1.0) | (cx > PATCH_W - 1.0)).reshape(shape)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in f32 with one rounding: the f64 product of two f32 values
    is exact, and so is its sum with c for the coordinates here."""
    return (a.to(torch.float64) * b.to(torch.float64) + c.to(torch.float64)).to(torch.float32)


def interp_matrix(start: torch.Tensor, bin_size: torch.Tensor, lo_bound: torch.Tensor,
                  hi_bound: torch.Tensor, out_size: int, ratio: int, width: int
                  ) -> torch.Tensor:
    """Pool-folded bilinear interpolation matrices [N, out_size, width] along
    one window axis (``_interp_matrix``): the mean over each bin's ``ratio``
    samples of their one-hot bilinear rows, with torchvision's border rule
    in window coordinates and the window edge as a second clamp."""
    dev = start.device
    idx = torch.arange(out_size * ratio, device=dev)
    bins = (idx // ratio).to(torch.float32)
    sub = (idx % ratio).to(torch.float32)
    start, bin_size = start[:, None], bin_size[:, None]
    lo_bound, hi_bound = lo_bound[:, None], hi_bound[:, None]
    # XLA contracts ``start + bins * bin_size`` into one fused multiply-add
    coord = _fma(_div(sub + 0.5, ratio), bin_size, _fma(bins, bin_size, start))  # [N, p]
    in_range = (coord >= lo_bound) & (coord <= hi_bound)
    c = torch.maximum(coord, (lo_bound + 1.0).clamp(min=0.0))
    last = (hi_bound - 1.0).clamp(max=width - 1.0)  # image border or window edge
    c = torch.minimum(c, last)
    lo = torch.floor(c)
    at_border = lo >= last
    lo = torch.where(at_border, last, lo)
    hi = torch.where(at_border, last, lo + 1.0)
    lerp = torch.where(at_border, torch.zeros_like(c), c - lo)
    cols = torch.arange(width, device=dev, dtype=torch.float32)
    m = ((cols == lo[..., None]) * (1.0 - lerp)[..., None]
         + (cols == hi[..., None]) * lerp[..., None])
    m = m * in_range[..., None]
    m = m.reshape(m.shape[0], out_size, ratio, width)
    acc = m[:, :, 0]
    for s in range(1, ratio):
        acc = acc + m[:, :, s]
    return acc * (1.0 / ratio)


def quantize_features_int8(features: Sequence[torch.Tensor]):
    """Per-level, per-channel symmetric int8 quantization of a pyramid of
    [B, C, H, W] levels: (int8 levels in the same memory layout, scales [L,
    C] f32) with f ~ q * scale; the scale is the channel's max |f| over the
    batch and the level's cells, / 127."""
    qs, scales = [], []
    for f in features:
        x = f.to(torch.float32)
        s = _div(x.abs().amax(dim=(0, 2, 3)).clamp(min=1e-12), 127.0)
        q = torch.round(x / s[None, :, None, None]).clamp(-127.0, 127.0)
        qs.append(q.to(torch.int8))
        scales.append(s)
    return qs, torch.stack(scales)


def pooling_operator(geom: torch.Tensor, output_size: int, sampling_ratio: int,
                     feature_dtype: torch.dtype) -> torch.Tensor:
    """The rounded Kronecker pooling operator [N, out^2, PATCH * PATCH_W]:
    f32 values (bf16-representable for bf16 features, int8-valued for int8)."""
    o = output_size
    wy = interp_matrix(geom[:, 0], geom[:, 2], geom[:, 4], geom[:, 5], o, sampling_ratio,
                       PATCH)
    wx = interp_matrix(geom[:, 1], geom[:, 3], geom[:, 6], geom[:, 7], o, sampling_ratio,
                       PATCH_W)
    if feature_dtype == torch.bfloat16:
        wy, wx = (a.to(torch.bfloat16).to(torch.float32) for a in (wy, wx))
    wc = wy[:, :, None, :, None] * wx[:, None, :, None, :]  # [N, o, o, PATCH, PATCH_W]
    if feature_dtype == torch.bfloat16:
        wc = wc.to(torch.bfloat16).to(torch.float32)
    elif feature_dtype == torch.int8:
        wc = torch.round(wc * 127.0).clamp(-127.0, 127.0)
    return wc.reshape(wc.shape[0], o * o, PATCH * PATCH_W)


def roi_align_patch(features: Sequence[torch.Tensor], rois: torch.Tensor, output_size: int,
                    sampling_ratio: int = 2,
                    spatial_scales: Tuple[float, ...] = SPATIAL_SCALES,
                    scales: Optional[torch.Tensor] = None,
                    out_dtype: Optional[torch.dtype] = None,
                    roi_chunk: int = 256) -> torch.Tensor:
    """The patch-window multilevel RoIAlign (plain version of K6, and of K7
    with ``scales``).  features: P2..P5 as [B, C, H_l, W_l] in f32, bf16, or
    int8 with ``scales`` [4, C] from ``quantize_features_int8``; rois [B, R,
    4] xyxy in image coordinates.  Returns [B*R, C, out, out] in
    ``out_dtype`` (default: the features' dtype; int8 features need one), a
    channels_last view, rois in natural order."""
    dtype = features[0].dtype
    if (dtype == torch.int8) != (scales is not None):
        raise ValueError("int8 features go with their scales, and only they")
    out_dtype = out_dtype or dtype
    b, r = rois.shape[:2]
    c = features[0].shape[1]
    dev = rois.device
    o = output_size
    level_shapes = [tuple(f.shape[2:]) for f in features]
    # one table of every level, zero-padded by one leading and PATCH(_W)
    # trailing cells per axis, so that every window lies inside its level
    padded = [torch.nn.functional.pad(f.permute(0, 2, 3, 1).to(torch.float32),
                                      (0, 0, 1, PATCH_W, 1, PATCH)) for f in features]
    pshapes = [(h + 1 + PATCH, w + 1 + PATCH_W) for h, w in level_shapes]
    sizes = [h * w for h, w in pshapes]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))], device=dev)
    pwidths = torch.tensor([w for _, w in pshapes], device=dev)
    table = torch.cat([p.reshape(b, -1, c) for p in padded], dim=1).reshape(-1, c)
    total = sum(sizes)

    flat = rois.reshape(-1, 4)
    n = flat.shape[0]
    img = torch.arange(b, device=dev).repeat_interleave(r)
    lvl, y0, x0, geom = patch_geometry(flat, level_shapes, spatial_scales, o)
    py = torch.arange(PATCH, device=dev)
    px = torch.arange(PATCH_W, device=dev)
    out = torch.empty((n, o * o, c), dtype=out_dtype, device=dev)
    for s in range(0, n, roi_chunk):
        e = min(n, s + roi_chunk)
        lv = lvl[s:e]
        base = img[s:e] * total + offsets[lv]
        # padded row y0 + 1 + py, padded column x0 + 1 + px
        idx = (base[:, None, None] + (y0[s:e, None, None] + 1 + py[None, :, None])
               * pwidths[lv][:, None, None] + (x0[s:e, None, None] + 1 + px[None, None, :]))
        window = table[idx.reshape(e - s, -1)]  # [n, PATCH * PATCH_W, C] f32
        wc = pooling_operator(geom[s:e], o, sampling_ratio, dtype)
        pooled = torch.bmm(wc, window)  # exact products; f32 (exact integer) sums
        if scales is not None:  # as XLA folds it: acc * ((1/127) * scale)
            pooled = pooled * (torch.tensor(1.0 / 127.0, device=dev) * scales[lv][:, None, :])
        out[s:e] = pooled.to(out_dtype)
    return out.reshape(n, o, o, c).permute(0, 3, 1, 2)


def apply_exact_fixup(levels: Sequence[torch.Tensor], rois: torch.Tensor, out: torch.Tensor,
                      output_size: int, sampling_ratio: int = 2, budget: int = 32
                      ) -> torch.Tensor:
    """Recompute the first ``budget`` window-clamped rois of each image with
    the exact RoIAlign (``cuda_roi_align.roi_align``: kernel K2 on the card,
    its plain version on the CPU; differentiable) and put them into ``out``
    [B*R, C, o, o], out of place.  The flagged rois are taken in index
    order, as ``lax.top_k`` of the mask takes them; beyond the budget they
    keep the patch-window values.  levels: P2..P5 [B, C, H, W] (channels_last
    for K2)."""
    from .cuda_roi_align import roi_align

    b, r = rois.shape[:2]
    k = min(budget, r)
    if k <= 0:
        return out
    mask = footprint_clamp_mask(rois, [tuple(f.shape[2:]) for f in levels[:4]],
                                output_size=output_size, sampling_ratio=sampling_ratio)
    # descending stable sort = lax.top_k: flagged first, ties in index order
    idx = torch.sort(mask.to(torch.float32), dim=1, descending=True, stable=True).indices[:, :k]
    sel = torch.take_along_dim(mask, idx, dim=1).reshape(-1)
    sub = torch.take_along_dim(rois, idx[..., None], dim=1).contiguous()
    fixed = roi_align(levels[:4], sub, output_size, sampling_ratio).to(out.dtype)
    rows = (torch.arange(b, device=rois.device)[:, None] * r + idx).reshape(-1)
    new = torch.where(sel[:, None, None, None], fixed, out[rows])
    return out.index_put((rows,), new)
