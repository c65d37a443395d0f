"""Kernel K1: the fused ResNet stem (``csrc/stem.cu``).

Replaces ``seam_match_rcnn_tpu/ops/pallas_stem.py`` (``fused_stem``):
maxpool3x3/s2/p1(relu(conv7x7/s2/p3(x) * bn_scale + bn_shift)).  As on the
TPU, the BN scale is folded into the conv weights in f32 before x and the
weights are rounded to bf16; products accumulate in f32 and the pooled
result is rounded to bf16.  See the source note in ``csrc/stem.cu`` for
what bounds the kernel and how it is laid out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import native


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


def fused_stem(x: torch.Tensor, conv_w: torch.Tensor, bn_scale: torch.Tensor,
               bn_shift: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """x [B, 3, H, W] (normalized; H, W multiples of 4) -> NCHW [B, 64, H/4,
    W/4] in ``out_dtype``.  CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return stem_plain(x, conv_w, bn_scale, bn_shift, out_dtype)
    name = "fused_stem"
    req = native.require
    req(x.device.type == "cuda", name, f"x on {x.device}, not cuda")
    req(x.dim() == 4 and x.shape[1] == 3, name, f"x must be [B, 3, H, W], got {tuple(x.shape)}")
    b, _, h, w_ = x.shape
    req(h % 4 == 0 and w_ % 4 == 0 and h > 0 and w_ > 0 and b > 0, name,
        f"H, W must be positive multiples of 4, got {h}x{w_}")
    req(tuple(conv_w.shape) == (64, 3, 7, 7), name, "conv1 weight must be [64, 3, 7, 7]")
    wf, bias = fold_stem_weights(conv_w, bn_scale, bn_shift)
    wt = wf.permute(1, 2, 3, 0).reshape(147, 64).contiguous()  # [(ci, ky, kx), cout]
    bias = bias.contiguous()
    xb = x.to(torch.bfloat16).contiguous()
    req(wt.device == xb.device and bias.device == xb.device, name,
        "weights must be on x's device")
    out = torch.empty((b, 64, h // 4, w_ // 4), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        status = native.library().seam_stem_forward(
            native.ptr(xb), native.ptr(wt), native.ptr(bias), native.ptr(out),
            b, h, w_, native.stream(x.device))
    native.check(status, name)
    fused_stem.launches += 1
    return out.to(out_dtype)


fused_stem.launches = 0
