"""Kernel K9, ``seam::vit_attention`` (``ops/vit_attention.py``, a Triton
kernel): ViTDet's attention with decomposed relative positions, every window of
a padded token grid (a global block: one window over the grid) in one launch.

Per launch on qkv [B, Hp, Wp, 3 * heads * d] with the rel terms [n, heads, T, S]
(n windows of T = S * S tokens): operations 4 * n * heads * T^2 * d for q k^T and
p v, plus ``SOFTMAX_OPS`` a logit for its scale and bias, maximum, exponential
and sum; bytes: qkv, rel_h and rel_w read once, out [B, Hp, Wp, heads * d]
written once, in bf16 (the rel terms in their own dtype)."""

KERNEL = r"\bvit_attention_kernel\b"
OP = "seam::vit_attention"
SOFTMAX_OPS = 5
_ELEMENT = {"float": 4, "c10::BFloat16": 2, "BFloat16": 2}


def count(b: int, hp: int, wp: int, c3: int, n: int, heads: int, t: int, s: int,
          rel_elem: int = 2):
    """-> (flops, bytes) of one launch."""
    d = c3 // (3 * heads)
    logits = n * heads * t * t
    flops = 4 * logits * d + SOFTMAX_OPS * logits
    grid = b * hp * wp
    nbytes = grid * c3 * 2 + 2 * n * heads * t * s * rel_elem + grid * (c3 // 3) * 2
    return flops, nbytes


def launches(trace):
    out = []
    for op in trace.ops(OP):
        b, hp, wp, c3 = op.shapes[0]
        n, heads, t, s = op.shapes[1]
        out.append(count(b, hp, wp, c3, n, heads, t, s, _ELEMENT.get(op.dtypes[1], 2)))
    return out
