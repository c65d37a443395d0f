"""Kernel K8: the epilogue of a backbone conv in one pass (``csrc/conv_epilogue.cu``).

``bn_epilogue(y, scale, shift, residual, scale_r, shift_r, relu)`` computes,
from the conv output ``y`` [B, C, H, W] and a FrozenBN's ``(scale, shift)`` in
the compute dtype::

    t = y * scale + shift                       (FrozenBatchNorm2d)
    t = t + residual                            (the identity), or
    t = t + (residual * scale_r + shift_r)      (the downsample conv's raw output)
    relu(t)                                     (when ``relu``)

It replaces no TPU kernel: on the TPU, XLA fused these ops into the conv.
The plain version is exactly that op chain, so the kernel is held to it bit
for bit, forward and backward (see the source note for how it rounds).

The kernel is the ``torch.library`` custom op ``seam::bn_epilogue``, and its
backward the op ``seam::bn_epilogue_backward``, bound to it with
``register_autograd``: CPU tensors run the plain versions, CUDA tensors the
launches (which count ``bn_epilogue.launches`` and
``bn_epilogue_grad.launches``), and the fake implementations let
``torch.export`` keep the op.  The backward saves the output (for the ReLU's
mask) and the scales, as autograd saves them for the chain.

Eager calls on the card skip the custom op's dispatch, which costs more host
time than the launch itself: without a gradient they call the CUDA
implementation, with one an ``autograd.Function`` that runs the op's own
setup and backward.  Traced, compiled and CPU calls go through the op.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import native

NONE, IDENTITY, RAW = 0, 1, 2  # the residual's kind


def _c(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


def bn_epilogue_plain(y, scale, shift, residual=None, scale_r=None, shift_r=None,
                      relu: bool = False) -> torch.Tensor:
    """The op chain the kernel replaces: FrozenBN, the residual (raw
    downsample when ``scale_r`` is given), ReLU."""
    out = y * _c(scale) + _c(shift)
    if residual is not None:
        if scale_r is not None:
            residual = residual * _c(scale_r) + _c(shift_r)
        out = out + residual
    return F.relu(out) if relu else out


def bn_epilogue_grad_plain(grad, out, scale, scale_r, mode: int, relu: bool):
    """Autograd's gradients of the chain: (grad of y, grad of the residual,
    or an empty tensor when there is none)."""
    g = torch.ops.aten.threshold_backward(grad, out, 0) if relu else grad
    grad_y = g * _c(scale)
    if mode == RAW:
        return grad_y, g * _c(scale_r)
    if mode == IDENTITY:
        return grad_y, g if relu else g.clone()  # an op's output may not alias its input
    return grad_y, grad.new_empty(0)


def _mode(residual, scale_r) -> int:
    return NONE if residual is None else (IDENTITY if scale_r is None else RAW)


def _ptr(t) -> int:
    return 0 if t is None else native.ptr(t)


def _aligned(*ts) -> int:
    return int(all(_ptr(t) % 16 == 0 for t in ts))


_DTYPES = (torch.bfloat16, torch.float32)


def _check(name, y, scale, others):
    """Raise on what the kernel does not take.  The common case is one test;
    the messages are made only when it fails (a call's host time matters:
    the backbone makes 48 of them a forward)."""
    if (y.is_cuda and y.dtype in _DTYPES and y.dim() == 4 and y.numel() < 2**31
            and scale.shape == y.shape[1:2]
            and all(t is None or (t.dtype == y.dtype and t.device == y.device) for t in others)):
        return
    req = native.require
    req(y.device.type == "cuda", name, f"y on {y.device}, not cuda")
    req(y.dtype in (torch.bfloat16, torch.float32), name, f"dtype {y.dtype}")
    req(y.dim() == 4, name, f"y must be [B, C, H, W], got {tuple(y.shape)}")
    req(y.numel() < 2**31, name, "B x C x H x W must be below 2^31")
    req(scale.shape == y.shape[1:2], name,
        f"scale must be [{y.shape[1]}], got {tuple(scale.shape)}")
    req(False, name, "every tensor must be on y's device, in y's dtype")


@torch.library.custom_op("seam::bn_epilogue", mutates_args=(), device_types="cpu")
def _epilogue_op(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                 residual: Optional[torch.Tensor], scale_r: Optional[torch.Tensor],
                 shift_r: Optional[torch.Tensor], relu: bool) -> torch.Tensor:
    """``seam::bn_epilogue`` on CPU tensors: the plain version."""
    residual = None if residual is None else residual.contiguous()
    return bn_epilogue_plain(y.contiguous(), scale, shift, residual, scale_r, shift_r, relu)


@_epilogue_op.register_kernel("cuda")
def _epilogue_cuda(y, scale, shift, residual, scale_r, shift_r, relu):
    """``seam::bn_epilogue`` on CUDA tensors: the kernel's launch."""
    name = "bn_epilogue"
    mode = _mode(residual, scale_r)
    _check(name, y, scale, (scale, shift, residual, scale_r, shift_r))
    native.require(mode != RAW or shift_r is not None, name, "scale_r without shift_r")
    native.require(residual is None or residual.shape == y.shape, name,
                   "the residual must have y's shape")
    y = y.contiguous()
    residual = None if residual is None else residual.contiguous()
    scale, shift = scale.contiguous(), shift.contiguous()
    if mode == RAW:
        scale_r, shift_r = scale_r.contiguous(), shift_r.contiguous()
    else:
        scale_r = shift_r = None
    out = torch.empty_like(y)
    if y.numel() == 0:
        return out
    with native.device(y.device):
        status = native.library().seam_bn_epilogue_forward(
            *map(_ptr, (y, scale, shift, residual, scale_r, shift_r, out)), y.numel(),
            y.shape[1], y.shape[2] * y.shape[3], mode, int(relu), int(y.dtype == torch.float32),
            _aligned(y, residual, out), native.stream(y.device))
    native.check(status, name)
    bn_epilogue.launches += 1
    return out


@_epilogue_op.register_fake
def _epilogue_fake(y, scale, shift, residual, scale_r, shift_r, relu):
    return y.new_empty(y.shape)


@torch.library.custom_op("seam::bn_epilogue_backward", mutates_args=(), device_types="cpu")
def _grad_op(grad: torch.Tensor, out: Optional[torch.Tensor], scale: torch.Tensor,
             scale_r: Optional[torch.Tensor], mode: int,
             relu: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``seam::bn_epilogue_backward`` on CPU tensors: the plain version."""
    return bn_epilogue_grad_plain(grad.contiguous(), out, scale, scale_r, mode, relu)


@_grad_op.register_kernel("cuda")
def _grad_cuda(grad, out, scale, scale_r, mode, relu):
    """``seam::bn_epilogue_backward`` on CUDA tensors: the kernel's launch."""
    name = "bn_epilogue_backward"
    _check(name, grad, scale, (out, scale, scale_r))
    native.require(not relu or (out is not None and out.shape == grad.shape), name,
                   "the ReLU's backward needs the output, of the gradient's shape")
    grad = grad.contiguous()
    out = out.contiguous() if relu else None
    scale = scale.contiguous()
    scale_r = scale_r.contiguous() if mode == RAW else None
    grad_y = torch.empty_like(grad)
    grad_r = torch.empty_like(grad) if mode != NONE else grad.new_empty(0)
    if grad.numel() == 0:
        return grad_y, grad_r
    with native.device(grad.device):
        status = native.library().seam_bn_epilogue_backward(
            *map(_ptr, (grad, out, scale, scale_r, grad_y, grad_r)), grad.numel(),
            grad.shape[1], grad.shape[2] * grad.shape[3], mode, int(relu),
            int(grad.dtype == torch.float32),
            _aligned(grad, out, grad_y, grad_r),
            native.stream(grad.device))
    native.check(status, name)
    bn_epilogue_grad.launches += 1
    return grad_y, grad_r


@_grad_op.register_fake
def _grad_fake(grad, out, scale, scale_r, mode, relu):
    return grad.new_empty(grad.shape), grad.new_empty(grad.shape if mode != NONE else (0,))


def _setup_context(ctx, inputs, output):
    y, scale, shift, residual, scale_r, shift_r, relu = inputs
    ctx.mode, ctx.relu = _mode(residual, scale_r), relu
    ctx.save_for_backward(output if relu else None, scale,
                          scale_r if ctx.mode == RAW else None)


def _backward(ctx, grad):
    out, scale, scale_r = ctx.saved_tensors
    grad_y, grad_r = bn_epilogue_grad(grad, out, scale, scale_r, ctx.mode, ctx.relu)
    return grad_y, None, None, grad_r if ctx.mode != NONE else None, None, None, None


_epilogue_op.register_autograd(_backward, setup_context=_setup_context)


class _EagerEpilogue(torch.autograd.Function):
    """``seam::bn_epilogue``'s autograd, the same setup and backward, for eager
    calls on the card."""

    @staticmethod
    def forward(ctx, y, scale, shift, residual, scale_r, shift_r, relu):
        out = _epilogue_cuda(y, scale, shift, residual, scale_r, shift_r, relu)
        _setup_context(ctx, (y, scale, shift, residual, scale_r, shift_r, relu), out)
        return out

    backward = staticmethod(_backward)


def bn_epilogue(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                residual: Optional[torch.Tensor] = None, scale_r: Optional[torch.Tensor] = None,
                shift_r: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """FrozenBN ``(scale, shift)`` on the conv output ``y`` [B, C, H, W], then
    the residual (the identity, or with ``(scale_r, shift_r)`` the downsample
    conv's raw output), then ReLU; every tensor in y's dtype (bf16 or f32),
    scales and shifts [C].  The custom op ``seam::bn_epilogue``: CPU tensors
    take the plain version, CUDA tensors the kernel (non-contiguous input is
    made contiguous; the output is contiguous).  Differentiable in ``y`` and
    ``residual``; the scales and shifts are a frozen layer's and take no
    gradient."""
    grad = torch.is_grad_enabled()
    if grad and any(t is not None and t.requires_grad for t in (scale, shift, scale_r, shift_r)):
        raise RuntimeError("bn_epilogue: FrozenBN's scale and shift take no gradient")
    if not y.is_cuda or torch.compiler.is_compiling():
        return torch.ops.seam.bn_epilogue(y, scale, shift, residual, scale_r, shift_r, relu)
    if grad and (y.requires_grad or (residual is not None and residual.requires_grad)):
        return _EagerEpilogue.apply(y, scale, shift, residual, scale_r, shift_r, relu)
    return _epilogue_cuda(y, scale, shift, residual, scale_r, shift_r, relu)


def bn_epilogue_grad(grad: torch.Tensor, out: Optional[torch.Tensor], scale: torch.Tensor,
                     scale_r: Optional[torch.Tensor], mode: int,
                     relu: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of ``bn_epilogue`` from the output's gradient: (grad of y,
    grad of the residual, empty when ``mode`` is NONE).  ``out``: the
    forward's output (needed with ``relu``).  The custom op
    ``seam::bn_epilogue_backward`` (eager calls on the card launch directly)."""
    if grad.is_cuda and not torch.compiler.is_compiling():
        return _grad_cuda(grad, out, scale, scale_r, mode, relu)
    return torch.ops.seam.bn_epilogue_backward(grad, out, scale, scale_r, mode, relu)


bn_epilogue.launches = 0
bn_epilogue_grad.launches = 0
