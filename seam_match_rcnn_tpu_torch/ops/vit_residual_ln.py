"""Kernel K10: ViTDet's residual stream in one pass (``csrc/vit_residual_ln.cu``).

``vit_residual_ln(x, branch, weight, bias, eps, dtype)`` computes, per token
row of the f32 residual stream ``x`` [..., C] and a residual branch in the
compute dtype::

    x_new = x + branch                                 (f32, one rounding)
    y     = layer_norm(x_new; weight, bias, eps).to(dtype)

and returns ``(x_new, y)``; without a branch (the first block's ``norm1``)
``x_new`` is ``x`` itself.  The f32 LayerNorm output never reaches device
memory: the kernel reads x and the branch and writes x_new and y, half the
bytes of the three passes it replaces (the source note has the count, the
design and how it rounds: x_new bit for bit the add's, y from its own f32
statistics).

It replaces no TPU kernel: the JAX package has no vision transformer.  The
plain version is that op chain exactly, so the CPU sees the numbers it saw
before the kernel.

The op is ``seam::vit_residual_ln``: its CPU implementation is the plain
version, its CUDA implementation the launch (which counts
``vit_residual_ln.launches``), and its fake implementation gives the outputs'
shapes.  Every call goes through the op, so a profiler records its shapes
(the benchmark's roofline of K10 reads them).  Forward only: ViTDet training
is not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import native

MAX_CHANNELS = 2048  # the kernel holds a row in registers: C / 32 values a lane
_DTYPES = (torch.bfloat16, torch.float32)


def vit_residual_ln_plain(x: torch.Tensor, branch: Optional[torch.Tensor], weight: torch.Tensor,
                          bias: torch.Tensor, eps: float,
                          dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The op chain the kernel replaces: the f32 + compute-dtype add, the
    LayerNorm in f32, the cast of its output."""
    if branch is not None:
        x = x + branch
    return x, F.layer_norm(x, (x.shape[-1],), weight, bias, eps).to(dtype)


def _check(x, branch, weight, bias, dtype) -> None:
    name = "vit_residual_ln"
    req = native.require
    req(x.dtype == torch.float32, name, f"x must be the float32 stream, got {x.dtype}")
    req(x.dim() >= 2, name, f"x must be [..., C], got {tuple(x.shape)}")
    c = x.shape[-1]
    req(dtype in _DTYPES, name, f"the compute dtype must be bfloat16 or float32, got {dtype}")
    req(weight.shape == (c,) and bias.shape == (c,), name,
        f"weight and bias must be [{c}], got {tuple(weight.shape)}, {tuple(bias.shape)}")
    req(weight.dtype == torch.float32 and bias.dtype == torch.float32, name,
        f"weight and bias must be float32, got {weight.dtype}, {bias.dtype}")
    if branch is not None:
        req(branch.shape == x.shape, name,
            f"the branch must have x's shape {tuple(x.shape)}, got {tuple(branch.shape)}")
        req(branch.dtype == dtype, name, f"the branch must be {dtype}, got {branch.dtype}")
    req(all(t.device == x.device for t in (weight, bias, branch) if t is not None), name,
        "every tensor must be on x's device")


@torch.library.custom_op("seam::vit_residual_ln", mutates_args=(), device_types="cpu")
def _residual_ln_op(x: torch.Tensor, branch: Optional[torch.Tensor], weight: torch.Tensor,
                    bias: torch.Tensor, eps: float,
                    dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """``seam::vit_residual_ln`` on CPU tensors: the plain version (x_new
    empty without a branch: an op's output may not alias its input)."""
    _check(x, branch, weight, bias, dtype)
    x_new, y = vit_residual_ln_plain(x, branch, weight, bias, eps, dtype)
    return (x_new if branch is not None else x.new_empty(0)), y


@_residual_ln_op.register_kernel("cuda")
def _residual_ln_cuda(x, branch, weight, bias, eps, dtype):
    """``seam::vit_residual_ln`` on CUDA tensors: the kernel's launch."""
    name = "vit_residual_ln"
    _check(x, branch, weight, bias, dtype)
    c = x.shape[-1]
    native.require(c % 8 == 0 and c <= MAX_CHANNELS, name,
                   f"C = {c} must be a multiple of 8 up to {MAX_CHANNELS}")
    rows = x.numel() // c
    native.require(rows < 2**31, name, "too many rows")
    x, weight, bias = x.contiguous(), weight.contiguous(), bias.contiguous()
    branch = None if branch is None else branch.contiguous()
    x_new = torch.empty_like(x) if branch is not None else x.new_empty(0)
    y = torch.empty(x.shape, dtype=dtype, device=x.device)
    if rows == 0:
        return x_new, y
    ptrs = [native.ptr(t) if t is not None else 0
            for t in (x, branch, weight, bias, x_new if branch is not None else None, y)]
    native.require(all(p % 16 == 0 for p in ptrs), name, "every tensor must be 16-byte aligned")
    with native.device(x.device):
        status = native.library().seam_vit_residual_ln(
            *ptrs, rows, c, eps, int(dtype == torch.float32), native.stream(x.device))
    native.check(status, name)
    vit_residual_ln.launches += 1
    return x_new, y


@_residual_ln_op.register_fake
def _residual_ln_fake(x, branch, weight, bias, eps, dtype):
    return (x.new_empty(x.shape) if branch is not None else x.new_empty(0),
            x.new_empty(x.shape, dtype=dtype))


def vit_residual_ln(x: torch.Tensor, branch: Optional[torch.Tensor], weight: torch.Tensor,
                    bias: torch.Tensor, eps: float,
                    dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., C] f32 and the residual branch (x's shape, in ``dtype``, or
    None) -> (x + branch in f32, or x itself without a branch; its LayerNorm
    by f32 ``weight``, ``bias`` [C] and ``eps``, in ``dtype``: bfloat16 or
    float32).  CPU tensors take the plain version, CUDA tensors the kernel
    (outputs contiguous).  Forward only: raises when an input needs a
    gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, branch, weight, bias)):
        raise RuntimeError("vit_residual_ln has no backward: ViTDet runs for inference only")
    x_new, y = torch.ops.seam.vit_residual_ln(x, branch, weight, bias, eps, dtype)
    return (x if branch is None else x_new), y


vit_residual_ln.launches = 0
