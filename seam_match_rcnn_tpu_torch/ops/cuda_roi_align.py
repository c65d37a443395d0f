"""Kernels K2 and K5: multilevel RoIAlign forward (``csrc/roi_align.cu``)
and its adjoint (``csrc/roi_adjoint.cu``), paired in ``RoIAlignFunction``;
kernels K6 and K7: the patch-window RoIAlign over bf16/f32 and int8
features (``csrc/roi_align_patch.cu``).

K2 replaces ``seam_match_rcnn_tpu/ops/pallas_roi_align_resident.py``
(``pallas_roi_align_resident``).  It computes the exact semantics of the
plain version, ``ops/roi_align.multilevel_roi_align``, in natural roi order:
no window clamp, no tile sort, no ``order`` output.  K5 replaces
``seam_match_rcnn_tpu/ops/pallas_roi_adjoint.py``
(``multilevel_roi_align_adjoint_pallas``) and computes the exact adjoint of
K2, ``ops/roi_align.multilevel_roi_align_adjoint``.  The source notes in the
``.cu`` files say what bounds each kernel.  ``RoIAlignFunction`` is the
counterpart of ``pallas_roi_align_resident_trainable`` (forward K2) and of
``pallas_roi_align_trainable`` (forward K6): backward K5, the exact
adjoint, no gradient for the rois (the reference detaches its proposals).
Their ``adjoint`` argument is ``RoIHeadsConfig.roi_adjoint_backend``:
"pallas" (the default) is K5, "xla" the scatter-add adjoint of
``ops/roi_align.multilevel_roi_align_adjoint`` (``index_add_``, stock ops
on the cotangent's device), which the JAX package leaves to XLA.

K6 and K7 replace ``seam_match_rcnn_tpu/ops/pallas_roi_align.py``
(``pallas_roi_align_batched`` over bf16/f32 features, and over the int8
pyramid of ``quantize_features_int8`` with its scales).  They compute the
plain version ``ops/roi_align_patch.roi_align_patch``: the TPU kernel's
40x48-cell window clamp included, rois in natural order.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import native
from . import roi_align_patch as patch
from .roi_align import SPATIAL_SCALES, multilevel_roi_align, multilevel_roi_align_adjoint


ROI_ALIGN_THREADS = 256  # K2/K6/K7's block; one thread per 16 bytes of a cell's channels
ROI_ALIGN_MAX_SAMPLES = 64  # K2's sample coordinates per axis, output_size x ratio
ROI_PATCH_MAX_OUT = 16  # K6/K7's tap tables: output sizes up to 16
ROI_PATCH_MAX_RATIO = 4  # and 2 x ratio taps per bin and axis
ROI_ADJOINT_MAX_RATIO = 4  # K5 holds a bin's sample taps in registers
ADJOINT_BACKENDS = ("pallas", "xla")  # RoIHeadsConfig.roi_adjoint_backend


def roi_align(features: Sequence[torch.Tensor], rois: torch.Tensor, output_size: int,
              sampling_ratio: int = 2,
              spatial_scales: Tuple[float, ...] = SPATIAL_SCALES,
              adjoint: str = "pallas") -> torch.Tensor:
    """features: P2..P5 as [B, C, H_l, W_l]; rois [B, R, 4] -> [B*R, C, out,
    out] in the features' dtype.  CPU tensors take the plain version; CUDA
    tensors launch the kernel, which needs channels_last, 16-byte aligned
    features in f32 or bf16 with C a multiple of 4 (f32) or 8 (bf16), f32
    rois and output_size x sampling_ratio <= 64.  When a level requires a
    gradient, the call goes through ``RoIAlignFunction``, whose backward is
    K5 (``adjoint="pallas"``) or the scatter-add adjoint (``"xla"``)."""
    if torch.is_grad_enabled() and any(f.requires_grad for f in features):
        return RoIAlignFunction.apply(_forward, rois, output_size, sampling_ratio,
                                      tuple(spatial_scales), adjoint, *features)
    return _forward(features, rois, output_size, sampling_ratio, spatial_scales)


def _check_levels(name, features, rois, spatial_scales, dtypes):
    """The input checks of the forward kernels (K2, K6, K7), which read 16
    bytes of a cell's channels at a time with 32-bit indices -> (B, R, C)."""
    req = native.require
    req(rois.device.type == "cuda", name, f"rois on {rois.device}, not cuda")
    req(len(features) == 4 and len(spatial_scales) == 4, name, "needs the 4 levels P2..P5")
    dtype = features[0].dtype
    req(dtype in dtypes, name, f"features dtype {dtype}")
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
    vec = 16 // features[0].element_size()  # channels a thread loads at once
    req(c > 0 and c % vec == 0 and c // vec <= ROI_ALIGN_THREADS, name,
        f"C = {c} must be a positive multiple of {vec}, at most {ROI_ALIGN_THREADS * vec}")
    req(all(f.shape[2] * f.shape[3] * c < 2**31 for f in features), name,
        "a level's H x W x C must be below 2^31 (32-bit indexing)")
    req(all(f.data_ptr() % 16 == 0 for f in features), name,
        "every level must be 16-byte aligned")
    return b, r, c


def _forward(features, rois, output_size, sampling_ratio, spatial_scales):
    if rois.device.type == "cpu":
        return multilevel_roi_align(features, rois, output_size, sampling_ratio,
                                    spatial_scales)
    name = "roi_align"
    req = native.require
    dtype = features[0].dtype
    b, r, c = _check_levels(name, features, rois, spatial_scales, (torch.float32, torch.bfloat16))
    req(output_size >= 1 and sampling_ratio >= 1
        and output_size * sampling_ratio <= ROI_ALIGN_MAX_SAMPLES, name,
        f"output_size x sampling_ratio must be in [1, {ROI_ALIGN_MAX_SAMPLES}]")
    n = b * r
    out = torch.empty((n, output_size, output_size, c), dtype=dtype, device=rois.device)
    if n:
        with native.device(rois.device):
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


def roi_align_patch(features: Sequence[torch.Tensor], rois: torch.Tensor, output_size: int,
                    sampling_ratio: int = 2,
                    spatial_scales: Tuple[float, ...] = SPATIAL_SCALES,
                    adjoint: str = "pallas") -> torch.Tensor:
    """K6, the patch-window RoIAlign.  features: P2..P5 as [B, C, H_l, W_l];
    rois [B, R, 4] -> [B*R, C, out, out] in the features' dtype.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (one
    launch, the window geometry computed in it), which needs channels_last,
    16-byte aligned features in f32 or bf16 with C a multiple of 4 (f32) or
    8 (bf16), f32 rois, output_size <= 16 and sampling_ratio <= 4.  When a level
    requires a gradient, the call goes through ``RoIAlignFunction``, whose
    backward is K5 or, with ``adjoint="xla"``, the scatter-add adjoint (the
    exact adjoint either way, as the JAX package's trainable wrapper pairs
    this forward with it)."""
    if torch.is_grad_enabled() and any(f.requires_grad for f in features):
        return RoIAlignFunction.apply(_patch_forward, rois, output_size, sampling_ratio,
                                      tuple(spatial_scales), adjoint, *features)
    return _patch_forward(features, rois, output_size, sampling_ratio, spatial_scales)


roi_align_patch.launches = 0


def roi_align_patch_int8(features: Sequence[torch.Tensor], scales: torch.Tensor,
                         rois: torch.Tensor, output_size: int, out_dtype: torch.dtype,
                         sampling_ratio: int = 2,
                         spatial_scales: Tuple[float, ...] = SPATIAL_SCALES) -> torch.Tensor:
    """K7, the patch-window RoIAlign over an int8 pyramid: features P2..P5
    [B, C, H_l, W_l] int8 and scales [4, C] f32 from
    ``roi_align_patch.quantize_features_int8``; rois [B, R, 4] -> [B*R, C,
    out, out] in ``out_dtype`` (f32 or bf16).  The kernel needs C a multiple
    of 16 and the wrapper checks of ``roi_align_patch``.  No gradient."""
    return _patch_forward(features, rois, output_size, sampling_ratio, spatial_scales,
                          scales, out_dtype)


roi_align_patch_int8.launches = 0


def _patch_forward(features, rois, output_size, sampling_ratio, spatial_scales, scales=None,
                   out_dtype=None):
    if rois.device.type == "cpu":
        return patch.roi_align_patch(features, rois, output_size, sampling_ratio,
                                     spatial_scales, scales=scales, out_dtype=out_dtype)
    wrapper = roi_align_patch if scales is None else roi_align_patch_int8
    name = wrapper.__name__
    req = native.require
    dtype = features[0].dtype
    b, r, c = _check_levels(name, features, rois, spatial_scales,
                            (torch.float32, torch.bfloat16) if scales is None else (torch.int8,))
    req(1 <= output_size <= ROI_PATCH_MAX_OUT and 1 <= sampling_ratio <= ROI_PATCH_MAX_RATIO,
        name, f"output_size must be in [1, {ROI_PATCH_MAX_OUT}] and sampling_ratio in "
        f"[1, {ROI_PATCH_MAX_RATIO}]")
    if scales is None:
        out_dtype = dtype
    else:
        req(out_dtype in (torch.float32, torch.bfloat16), name, f"out_dtype {out_dtype}")
        req(scales.device == rois.device and scales.dtype == torch.float32
            and tuple(scales.shape) == (4, c) and scales.is_contiguous(), name,
            "scales must be contiguous f32 [4, C] on the rois' device")
    n = b * r
    out = torch.empty((n, output_size, output_size, c), dtype=out_dtype, device=rois.device)
    if n:
        lib = native.library()
        args = [*[native.ptr(f) for f in features], *[f.shape[2] for f in features],
                *[f.shape[3] for f in features], *[float(s) for s in spatial_scales],
                native.ptr(rois)]
        with native.device(rois.device):
            if scales is None:
                status = lib.seam_roi_align_patch(
                    *args, native.ptr(out), n, r, c, output_size, sampling_ratio,
                    int(dtype == torch.bfloat16), native.stream(rois.device))
            else:
                status = lib.seam_roi_align_patch_int8(
                    *args, native.ptr(scales), native.ptr(out), n, r, c, output_size,
                    sampling_ratio, int(out_dtype == torch.bfloat16), native.stream(rois.device))
        native.check(status, name)
        wrapper.launches += 1
    return out.permute(0, 3, 1, 2)


def roi_align_adjoint(grad: torch.Tensor, rois: torch.Tensor,
                      level_shapes: Sequence[Tuple[int, int]], dtype: torch.dtype,
                      sampling_ratio: int = 2,
                      spatial_scales: Tuple[float, ...] = SPATIAL_SCALES
                      ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``roi_align`` with respect to each level: grad [B, R,
    out, out, C] f32 cotangent (NHWC bins), rois [B, R, 4] -> per level [B,
    C, H_l, W_l] in ``dtype``, channels_last.  CPU tensors take the plain
    version; CUDA tensors launch K5, which writes every cell of the output
    (allocated here with ``torch.empty``, the one device op besides the
    launch) once, in ``dtype``.  The kernel sums each cell in a fixed order,
    so two calls on the same inputs return the same bytes; that order is
    not the plain version's, whose f32 sums may differ in the last bits."""
    if rois.device.type == "cpu":
        grads = multilevel_roi_align_adjoint(grad, rois, level_shapes, sampling_ratio,
                                             spatial_scales)
        return tuple(g.to(dtype).permute(0, 3, 1, 2) for g in grads)
    name = "roi_align_adjoint"
    req = native.require
    req(rois.device.type == "cuda", name, f"rois on {rois.device}, not cuda")
    req(len(level_shapes) == 4 and len(spatial_scales) == 4, name, "needs the 4 levels P2..P5")
    req(dtype in (torch.float32, torch.bfloat16), name, f"features dtype {dtype}")
    req(rois.dtype == torch.float32 and rois.dim() == 3 and rois.shape[-1] == 4
        and rois.is_contiguous(), name, "rois must be contiguous f32 [B, R, 4]")
    b, r = rois.shape[:2]
    req(grad.device == rois.device and grad.dtype == torch.float32 and grad.dim() == 5
        and grad.shape[:2] == (b, r) and grad.shape[2] == grad.shape[3]
        and grad.is_contiguous(), name, "grad must be contiguous f32 [B, R, out, out, C]")
    o, c = grad.shape[2], grad.shape[4]
    req(o >= 1 and 1 <= sampling_ratio <= ROI_ADJOINT_MAX_RATIO
        and o * sampling_ratio <= ROI_ALIGN_MAX_SAMPLES, name,
        f"sampling_ratio must be in [1, {ROI_ADJOINT_MAX_RATIO}] and output_size x "
        f"sampling_ratio at most {ROI_ALIGN_MAX_SAMPLES}")
    vec = 16 // dtype.itemsize  # channels a 16-byte store holds
    req(c > 0 and c % vec == 0, name, f"C = {c} must be a positive multiple of {vec}")
    sizes = [b * h * w * c for h, w in level_shapes]
    n = b * r
    # the kernel writes every cell; with no roi there is nothing to launch
    alloc = torch.empty if n else torch.zeros
    flat = alloc(sum(sizes), dtype=dtype, device=rois.device)
    levels, start = [], 0
    for (h, w), size in zip(level_shapes, sizes):
        levels.append(flat[start:start + size].view(b, h, w, c))
        start += size
    if n:
        with native.device(rois.device):
            status = native.library().seam_roi_align_adjoint(
                *[native.ptr(g) for g in levels], *[h for h, _ in level_shapes],
                *[w for _, w in level_shapes], *[float(s) for s in spatial_scales],
                native.ptr(grad), native.ptr(rois), n, r, c, o, sampling_ratio,
                int(dtype == torch.bfloat16), native.stream(rois.device))
        native.check(status, name)
        roi_align_adjoint.launches += 1
    return tuple(g.permute(0, 3, 1, 2) for g in levels)


roi_align_adjoint.launches = 0


class RoIAlignFunction(torch.autograd.Function):
    """Differentiable multilevel RoIAlign: the given forward (``_forward``,
    K2, or ``_patch_forward``, K6; their plain versions for CPU tensors),
    backward the exact adjoint of K2: ``adjoint="pallas"`` is K5 (the plain
    adjoint for CPU tensors), ``"xla"`` the scatter-add adjoint on any
    device.  The rois get no gradient.  ``apply(forward, rois, output_size,
    sampling_ratio, spatial_scales, adjoint, *features)``."""

    @staticmethod
    def forward(ctx, forward, rois, output_size, sampling_ratio, spatial_scales, adjoint,
                *features):
        if adjoint not in ADJOINT_BACKENDS:
            raise ValueError(f"unknown roi_adjoint_backend {adjoint!r}; expected 'pallas' or "
                             "'xla'")
        ctx.save_for_backward(rois)
        ctx.meta = (output_size, sampling_ratio, spatial_scales, adjoint,
                    [tuple(f.shape[2:]) for f in features], features[0].dtype)
        return forward(features, rois, output_size, sampling_ratio, spatial_scales)

    @staticmethod
    def backward(ctx, grad):
        (rois,) = ctx.saved_tensors
        output_size, sampling_ratio, spatial_scales, adjoint, level_shapes, dtype = ctx.meta
        b, r = rois.shape[:2]
        # [B*R, C, o, o] (a bf16 cotangent for bf16 features) -> f32 NHWC bins
        g = grad.permute(0, 2, 3, 1).to(torch.float32).contiguous()
        g = g.view(b, r, output_size, output_size, -1)
        if adjoint == "xla":
            grads = tuple(x.to(dtype).permute(0, 3, 1, 2) for x in multilevel_roi_align_adjoint(
                g, rois, level_shapes, sampling_ratio, spatial_scales))
        else:
            grads = roi_align_adjoint(g, rois.contiguous(), level_shapes, dtype,
                                      sampling_ratio, spatial_scales)
        return (None, None, None, None, None, None) + grads
