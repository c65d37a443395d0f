"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W power limit).  A share of a peak is stated against these, with the card's
power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {
    "bfloat16": 989e12,   # tensor cores, dense
    "float32": 67e12,     # outside the tensor cores (the port runs TF32 off)
}


def bound_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time of a kernel: the larger of its operations over the peak of
    their type and its bytes over the HBM bandwidth."""
    return max(flops / FLOPS_PER_S[dtype], nbytes / HBM_BYTES_PER_S)
