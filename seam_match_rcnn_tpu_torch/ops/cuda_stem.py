"""Kernel K1: the fused ResNet stem (``csrc/stem.cu``).

Replaces ``seam_match_rcnn_tpu/ops/pallas_stem.py`` (``fused_stem``):
maxpool3x3/s2/p1(relu(conv7x7/s2/p3(x) * bn_scale + bn_shift)).  As on the
TPU, the BN scale is folded into the conv weights in f32 before x and the
weights are rounded to bf16; products accumulate in f32 and the pooled
result is rounded to bf16.  See the source note in ``csrc/stem.cu`` for
what bounds the kernel and how it is laid out.

The kernel is the ``torch.library`` custom op ``seam::fused_stem``: its CPU
implementation is the plain version, its CUDA implementation the launch
(which counts ``fused_stem.launches``), and its fake implementation gives
the output's shape and dtype, so ``torch.export`` keeps the op in the graph
and a replayed program launches the kernel.  No other device has one.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import native

STEM_TAPS = 3 * 7 * 7
STEM_WEIGHT_ROW = 168  # the kernel's weight row: K = 147 taps padded with zeros


def fold_stem_weights(conv_w: torch.Tensor, bn_scale: torch.Tensor,
                      bn_shift: torch.Tensor):
    """conv1 [64, 3, 7, 7] and FrozenBN (scale, shift) -> (bf16 folded
    weights [64, 3, 7, 7], f32 bias [64])."""
    w = conv_w.to(torch.float32) * bn_scale.to(torch.float32)[:, None, None, None]
    return w.to(torch.bfloat16), bn_shift.to(torch.float32)


def stem_plain(x: torch.Tensor, conv_w: torch.Tensor, bn_scale: torch.Tensor,
               bn_shift: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's exact math as plain ops: x [B, 3, H, W] -> [B, 64, H/4, W/4]."""
    w, bias = fold_stem_weights(conv_w, bn_scale, bn_shift)
    y = F.conv2d(x.to(torch.bfloat16).to(torch.float32), w.to(torch.float32),
                 stride=2, padding=3)
    y = F.relu(y + bias[None, :, None, None])
    y = F.max_pool2d(y, 3, stride=2, padding=1)
    return y.to(torch.bfloat16).to(out_dtype)


def stem_tile():
    """(pooled rows, pooled columns, e) of the kernel's tile and of its rule
    for the conv values it recomputes (|value + shift| < 2^e max|x| of the
    tile's input patch x sum|w| of the channel, not an exactly-zero sum),
    read from the kernel library."""
    v = [ctypes.c_int() for _ in range(3)]
    native.check(native.library().seam_stem_tile(*[ctypes.byref(x) for x in v]),
                 "seam_stem_tile")
    return tuple(x.value for x in v)


@torch.library.custom_op("seam::fused_stem", mutates_args=(), device_types="cpu")
def _stem_op(x: torch.Tensor, conv_w: torch.Tensor, bn_scale: torch.Tensor,
             bn_shift: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``seam::fused_stem`` on CPU tensors: the plain version."""
    return stem_plain(x, conv_w, bn_scale, bn_shift, out_dtype)


@_stem_op.register_kernel("cuda")
def _stem_cuda(x, conv_w, bn_scale, bn_shift, out_dtype):
    """``seam::fused_stem`` on CUDA tensors: the kernel's launch."""
    name = "fused_stem"
    req = native.require
    req(x.device.type == "cuda", name, f"x on {x.device}, not cuda")
    req(x.dim() == 4 and x.shape[1] == 3, name, f"x must be [B, 3, H, W], got {tuple(x.shape)}")
    req(x.dtype in (torch.float32, torch.bfloat16), name, f"x dtype {x.dtype}")
    req(out_dtype in (torch.float32, torch.bfloat16), name, f"out_dtype {out_dtype}")
    b, _, h, w_ = x.shape
    req(h % 4 == 0 and w_ % 4 == 0 and h > 0 and w_ > 0 and b > 0, name,
        f"H, W must be positive multiples of 4, got {h}x{w_}")
    req(3 * h * w_ < 2**31, name, "an image's 3 x H x W must be below 2^31")
    req(tuple(conv_w.shape) == (64, 3, 7, 7), name, "conv1 weight must be [64, 3, 7, 7]")
    wf, bias = fold_stem_weights(conv_w, bn_scale, bn_shift)
    # [cout, (ci, ky, kx)], K padded with zero weights to the kernel's row of 168
    wt = F.pad(wf.reshape(64, STEM_TAPS), (0, STEM_WEIGHT_ROW - STEM_TAPS))
    bias = bias.contiguous()
    x = x.contiguous()
    req(wt.device == x.device and bias.device == x.device, name,
        "weights must be on x's device")
    out = torch.empty((b, 64, h // 4, w_ // 4), dtype=out_dtype, device=x.device)
    with native.device(x.device):
        status = native.library().seam_stem_forward(
            native.ptr(x), native.ptr(wt), native.ptr(bias), native.ptr(out), b, h, w_,
            int(x.dtype == torch.float32), int(out_dtype == torch.float32),
            native.stream(x.device))
    native.check(status, name)
    fused_stem.launches += 1
    return out


@_stem_op.register_fake
def _stem_fake(x, conv_w, bn_scale, bn_shift, out_dtype):
    b, _, h, w = x.shape
    return x.new_empty((b, 64, h // 4, w // 4), dtype=out_dtype)


def fused_stem(x: torch.Tensor, conv_w: torch.Tensor, bn_scale: torch.Tensor,
               bn_shift: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """x [B, 3, H, W] f32 or bf16 (normalized; H, W multiples of 4) -> NCHW
    [B, 64, H/4, W/4] in ``out_dtype`` (bf16, or f32 holding the bf16-rounded
    value).  The kernel rounds f32 input to bf16 as it loads it, so f32 and
    bf16 input give the same output.  The custom op ``seam::fused_stem``:
    CPU tensors take the plain version, CUDA tensors the kernel, and a
    traced or exported program keeps the op.  Forward only, as the TPU
    kernel: it raises when its input or weights need a gradient (the
    backbone keeps the stem frozen, ``models/resnet.py``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, conv_w, bn_scale, bn_shift)):
        raise RuntimeError("fused_stem has no backward: keep the stem frozen "
                           "or use stem_backend='xla'")
    return torch.ops.seam.fused_stem(x, conv_w, bn_scale, bn_shift, out_dtype)


fused_stem.launches = 0
