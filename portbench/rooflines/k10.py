"""Kernel K10, ``seam::vit_residual_ln`` (``ops/vit_residual_ln.py``, CUDA C++):
ViTDet's residual add, the LayerNorm after it and the rounding of its output to
the compute dtype, one pass over the f32 stream.

Per launch on x [..., C] f32 (rows = its size / C), with or without a branch:
bytes x read, the branch read (when given, in its dtype), x_new written (f32,
when there is a branch), y written (in the compute dtype the call names), and
the LayerNorm's f32 weight and bias read; operations ``OPS`` an element (the
add when there is a branch, then the mean's sum, the squared deviations'
sum, and y's subtraction, scale and fused multiply-add)."""

KERNEL = r"\bvit_residual_ln_kernel\b"
OP = "seam::vit_residual_ln"
OPS, ADD_OPS = 8, 1
_ELEMENT = {"float": 4, "c10::BFloat16": 2, "BFloat16": 2}
_DTYPE_ELEMENT = {15: 2, 6: 4}  # torch's ScalarType codes of bfloat16, float32


def count(rows: int, c: int, branch_elem: int = 0, y_elem: int = 2):
    """-> (flops, bytes) of one launch; ``branch_elem`` 0 when there is no
    branch."""
    n = rows * c
    flops = n * (OPS + (ADD_OPS if branch_elem else 0))
    nbytes = n * 4 + (n * (branch_elem + 4) if branch_elem else 0) + n * y_elem + 2 * c * 4
    return flops, nbytes


def launches(trace):
    out = []
    for op in trace.ops(OP):
        shape, branch = op.shapes[0], op.shapes[1]
        c = shape[-1]
        rows = 1
        for d in shape[:-1]:
            rows *= d
        branch_elem = _ELEMENT.get(op.dtypes[1], 2) if branch else 0
        dtype = op.concrete[5] if len(op.concrete) > 5 else None
        y_elem = _DTYPE_ELEMENT.get(dtype, branch_elem or 2)
        out.append(count(rows, c, branch_elem, y_elem))
    return out
