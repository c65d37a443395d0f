"""Layers whose parameters stay f32 while their forward runs in a compute dtype.

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

from ..ops.cuda_epilogue import bn_epilogue


class Conv2d(nn.Conv2d):
    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``dtype``: compute in it instead of ``compute_dtype``."""
        dt = dtype or self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding,
                        self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation)


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
    applied in the compute dtype (the JAX ``FrozenBN`` stores scale/shift).

    The forward is kernel K8 (``ops/cuda_epilogue.bn_epilogue``), which can
    also add a residual and apply ReLU in the same pass.  The compute-dtype
    ``(scale, shift)`` are cached between calls, keyed on the four buffers'
    storage and version, the dtype and the device, so ``load_state_dict``,
    ``.to()`` and in-place fills refresh them; under ``torch.export`` or
    ``torch.compile`` they are computed afresh, in the traced graph."""

    def __init__(self, n: int, eps: float = 1e-5, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.register_buffer("weight", torch.ones(n))
        self.register_buffer("bias", torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))
        self._cached = None

    def scale_shift(self):
        scale = self.weight * (self.running_var + self.eps).rsqrt()
        return scale, self.bias - self.running_mean * scale

    def compute_scale_shift(self):
        """``scale_shift()`` cast to the compute dtype, cached (see the class)."""
        dt = self.compute_dtype
        if torch.compiler.is_compiling():
            scale, shift = self.scale_shift()
            return scale.to(dt), shift.to(dt)
        bufs = (self.weight, self.bias, self.running_mean, self.running_var)
        key = (dt, self.weight.device) + tuple((b.data_ptr(), b._version) for b in bufs)
        if self._cached is None or self._cached[0] != key:
            # plain tensors even inside inference_mode, so a later training
            # forward can save them; the buffers' aliases keep their storage
            # alive, so no later buffer can reuse a cached address
            with torch.inference_mode(False), torch.no_grad():
                scale, shift = self.scale_shift()
                self._cached = (key, scale.to(dt), shift.to(dt), [b.detach() for b in bufs])
        return self._cached[1], self._cached[2]

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                residual_bn: Optional["FrozenBatchNorm2d"] = None,
                relu: bool = False) -> torch.Tensor:
        """FrozenBN of ``x`` (in the compute dtype), then ``+ residual`` (FrozenBN'd
        by ``residual_bn`` first when given: the downsample conv's raw output),
        then ReLU when ``relu``; one K8 pass."""
        scale, shift = self.compute_scale_shift()
        scale_r = shift_r = None
        if residual_bn is not None:
            scale_r, shift_r = residual_bn.compute_scale_shift()
        return bn_epilogue(x, scale, shift, residual, scale_r, shift_r, relu)
