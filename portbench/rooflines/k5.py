"""Kernel K5, the RoIAlign adjoint (``csrc/roi_adjoint.cu``), K2's backward in
training: it sums each pyramid cell's taps in one thread and writes every cell.

A K5 launch is the backward of one K2 launch that recorded a gradient, so its
shapes are that forward's: bytes = the f32 cotangent [B*R, C, o, o] and the rois
read once + the bf16 gradient pyramid of the B images written once."""

from . import k2

KERNEL = r"\broi_adjoint_kernel\b"


def count(b: int, r: int, o: int, ratio: int, canvas, grad_elem: int = 2):
    h, w = canvas
    pyramid = sum((h // s) * (w // s) for s in k2.STRIDES) * b * k2.CHANNELS * grad_elem
    cot = b * r * k2.CHANNELS * o * o * 4
    flops = b * r * k2.CHANNELS * o * o * ratio * ratio * 8  # 4 taps, multiply-add each
    return flops, cot + b * r * 16 + pyramid


def launches(trace):
    """One launch per K2 forward of the window that had a backward: in a
    training step every K2 forward does."""
    out = []
    for op in trace.ops(k2.OP):
        stem = trace.last_before(op, "seam::fused_stem")
        if stem is None:
            return None
        b, r = op.shapes[1][:2]
        out.append(count(b, r, op.concrete[2], op.concrete[3], stem.shapes[0][2:]))
    return out
