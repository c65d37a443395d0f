"""Kernel K1, ``seam::fused_stem`` (``csrc/stem.cu``): the ResNet stem, a 7x7
stride-2 conv of 3 -> 64 channels with FrozenBN and relu, then a 3x3 stride-2
max-pool, in one kernel on bf16 tensor cores.

Per launch on x [B, 3, H, W]: 2 * B * 64 * (H/2) * (W/2) * 3 * 49 operations;
bytes: x and the weights read once, [B, 64, H/4, W/4] written once."""

KERNEL = r"\bstem_kernel\b"
OP = "seam::fused_stem"
_ELEMENT = {"float": 4, "c10::BFloat16": 2, "BFloat16": 2}
_OUT_ELEMENT = {15: 2, 6: 4}  # the op's out_dtype: torch.bfloat16, torch.float32


def count(b: int, h: int, w: int, in_bytes: int, out_bytes: int):
    """-> (flops, bytes) of one launch."""
    flops = 2 * b * 64 * (h // 2) * (w // 2) * 3 * 49
    nbytes = b * 3 * h * w * in_bytes + 64 * 3 * 49 * 4 + 2 * 64 * 4 \
        + b * 64 * (h // 4) * (w // 4) * out_bytes
    return flops, nbytes


def launches(trace):
    out = []
    for op in trace.ops(OP):
        b, _, h, w = op.shapes[0]
        out.append(count(b, h, w, _ELEMENT.get(op.dtypes[0], 4),
                         _OUT_ELEMENT.get(op.concrete[4], 2)))
    return out
