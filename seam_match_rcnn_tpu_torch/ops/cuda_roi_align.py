"""Kernel K2: multilevel RoIAlign forward (``csrc/roi_align.cu``).

Replaces ``seam_match_rcnn_tpu/ops/pallas_roi_align_resident.py``
(``pallas_roi_align_resident``).  The kernel computes the exact semantics of
the plain version, ``ops/roi_align.multilevel_roi_align``, in natural roi
order: no window clamp, no tile sort, no ``order`` output.  See the source
note in ``csrc/roi_align.cu`` for what bounds it and why it wants
channels_last features.  Forward only: the gradient (kernel K5) comes with
training.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import native
from .roi_align import SPATIAL_SCALES, multilevel_roi_align


def roi_align(features: Sequence[torch.Tensor], rois: torch.Tensor, output_size: int,
              sampling_ratio: int = 2,
              spatial_scales: Tuple[float, ...] = SPATIAL_SCALES) -> torch.Tensor:
    """features: P2..P5 as [B, C, H_l, W_l]; rois [B, R, 4] -> [B*R, C, out,
    out] in the features' dtype.  CPU tensors take the plain version; CUDA
    tensors launch the kernel, which needs channels_last features in f32 or
    bf16 and f32 rois."""
    if rois.device.type == "cpu":
        return multilevel_roi_align(features, rois, output_size, sampling_ratio,
                                    spatial_scales)
    name = "roi_align"
    req = native.require
    req(rois.device.type == "cuda", name, f"rois on {rois.device}, not cuda")
    req(len(features) == 4 and len(spatial_scales) == 4, name, "needs the 4 levels P2..P5")
    dtype = features[0].dtype
    req(dtype in (torch.float32, torch.bfloat16), name, f"features dtype {dtype}")
    req(rois.dtype == torch.float32 and rois.dim() == 3 and rois.shape[-1] == 4
        and rois.is_contiguous(), name, "rois must be contiguous f32 [B, R, 4]")
    b, r = rois.shape[:2]
    c = features[0].shape[1]
    for f in features:
        req(f.device == rois.device and f.dtype == dtype and f.dim() == 4
            and f.shape[0] == b and f.shape[1] == c, name,
            "every level must be [B, C, H, W] on the rois' device in one dtype")
        req(f.is_contiguous(memory_format=torch.channels_last), name,
            "features must be channels_last")
    n = b * r
    out = torch.empty((n, output_size, output_size, c), dtype=dtype, device=rois.device)
    if n:
        with torch.cuda.device(rois.device):
            status = native.library().seam_roi_align_forward(
                *[native.ptr(f) for f in features],
                *[f.shape[2] for f in features], *[f.shape[3] for f in features],
                *[float(s) for s in spatial_scales],
                native.ptr(rois), native.ptr(out), n, r, c, output_size, sampling_ratio,
                int(dtype == torch.bfloat16), native.stream(rois.device))
        native.check(status, name)
        roi_align.launches += 1
    return out.permute(0, 3, 1, 2)


roi_align.launches = 0
