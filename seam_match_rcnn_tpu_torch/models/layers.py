"""Layers whose parameters stay f32 while their forward runs in a compute dtype.

The JAX package stores f32 parameters and computes the backbone and heads in
``ModelConfig.compute_dtype`` (bf16 when serving) and the match trunks in
``MatchHeadConfig.trunk_dtype``; flax casts inputs and weights at each layer.
These subclasses do the same cast explicitly (no ``torch.autocast``) and keep
torchvision's parameter names.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv2d(nn.Conv2d):
    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding,
                        self.dilation, self.groups)


class Linear(nn.Linear):
    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


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
        dt = self.compute_dtype
        return x * scale.to(dt)[None, :, None, None] + shift.to(dt)[None, :, None, None]
