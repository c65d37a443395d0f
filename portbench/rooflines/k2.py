"""Kernel K2, ``seam::roi_align`` (``csrc/roi_align.cu``): the exact multilevel
RoIAlign forward over P2..P5 in natural roi order.

Per launch on rois [B, R, 4] at output size o over a pyramid of C = 256 channels
in the compute dtype: bytes = the four levels of the B images read once + the
rois + [B*R, C, o, o] written once; the interpolation's operations (4 taps a
sample, ratio^2 samples a bin) are far below the byte bound.  The op's record
does not carry the levels' shapes; they follow from the canvas of the stem (K1)
launch that came last before it in the same forward: P_l = canvas / 2^(l+1)."""

KERNEL = r"\broi_align_kernel\b"
OP = "seam::roi_align"
CHANNELS = 256
STRIDES = (4, 8, 16, 32)


def count(b: int, r: int, o: int, ratio: int, canvas, elem: int = 2):
    """-> (flops, bytes) of one launch."""
    h, w = canvas
    levels = sum((h // s) * (w // s) for s in STRIDES) * b * CHANNELS * elem
    out = b * r * CHANNELS * o * o * elem
    flops = b * r * CHANNELS * o * o * ratio * ratio * 8  # 4 taps, multiply-add each
    return flops, levels + b * r * 16 + out


def launches(trace, elem: int = 2):
    out = []
    for op in trace.ops(OP):
        stem = trace.last_before(op, "seam::fused_stem")
        if stem is None:
            return None
        canvas = stem.shapes[0][2:]
        b, r = op.shapes[1][:2]
        out.append(count(b, r, op.concrete[2], op.concrete[3], canvas, elem))
    return out
