"""Layers whose parameters stay f32 while their forward runs in a compute dtype.

Frozen copy of ``seam_match_rcnn_tpu_torch/models/layers.py`` (what the benchmark's
plain reference uses of it); it imports nothing of the port. The control's scaled float8
cast (``cast``) is added.

The JAX package stores f32 parameters and computes the backbone and heads in
``ModelConfig.compute_dtype`` (bf16 when serving) and the match trunks in
``MatchHeadConfig.trunk_dtype``; flax casts inputs and weights at each layer.
These subclasses do the same cast explicitly (no ``torch.autocast``) and keep
torchvision's parameter names.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

# The control's compute dtype: inputs and weights of every conv and dense
# layer rounded to float8 e4m3 with a per-tensor scale (amax / 448), the
# products summed in bf16 -- the precision one step below the bf16 that the
# configuration states.
FP8 = "float8_e4m3fn"


def cast(t: torch.Tensor, dt) -> torch.Tensor:
    """``t`` in the compute dtype ``dt`` (a torch dtype, or ``FP8``)."""
    if dt != FP8:
        return t.to(dt)
    t = t.to(torch.float32)
    scale = t.abs().amax().clamp(min=1e-12) / 448.0
    return ((t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale).to(torch.bfloat16)


def elementwise_dtype(dt):
    """The dtype of elementwise work under ``dt`` (bf16 for the control)."""
    return torch.bfloat16 if dt == FP8 else dt


class Conv2d(nn.Conv2d):
    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``dtype``: compute in it instead of ``compute_dtype``."""
        dt = dtype or self.compute_dtype
        bias = None if self.bias is None else self.bias.to(elementwise_dtype(dt))
        return F.conv2d(cast(x, dt), cast(self.weight, dt), bias, self.stride, self.padding,
                        self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv_transpose2d(cast(x, dt), cast(self.weight, dt),
                                  self.bias.to(elementwise_dtype(dt)), self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation)


class Linear(nn.Linear):
    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(cast(x, dt), cast(self.weight, dt), self.bias.to(elementwise_dtype(dt)))


class FrozenBatchNorm2d(nn.Module):
    """torchvision ``FrozenBatchNorm2d``: y = x * scale + shift with
    scale = weight / sqrt(running_var + eps), shift = bias - mean * scale,
    applied in the compute dtype (the JAX ``FrozenBN`` stores scale/shift)."""

    def __init__(self, n: int, eps: float = 1e-5, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.register_buffer("weight", torch.ones(n))
        self.register_buffer("bias", torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def scale_shift(self):
        scale = self.weight * (self.running_var + self.eps).rsqrt()
        return scale, self.bias - self.running_mean * scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, shift = self.scale_shift()
        dt = elementwise_dtype(self.compute_dtype)
        return x * scale.to(dt)[None, :, None, None] + shift.to(dt)[None, :, None, None]
