"""Pairwise match scoring: logits[i, j] = W @ (x_i - y_j)**2 + b.

Frozen copy of ``seam_match_rcnn_tpu_torch/ops/pairwise.py`` (what the benchmark's plain
reference uses of it); it imports nothing of the port.

Port of ``seam_match_rcnn_tpu/ops/pairwise.py``: the square is expanded so
that no [N, M, C] difference tensor is materialized.  The expansion
subtracts large, nearly equal terms, so everything stays full f32 (the
matmuls here must not run in TF32: see ``torch.backends.cuda.matmul.allow_tf32``).
"""

from __future__ import annotations

import torch


def pairwise_match_logits(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor) -> torch.Tensor:
    """x: [N, C] street descriptors; y: [M, C] shop descriptors; w: [K, C],
    b: [K] (the reference's Linear(256, 2)).  Returns [N, M, K]."""
    x, y, w = x.to(torch.float32), y.to(torch.float32), w.to(torch.float32)
    xw = (x * x) @ w.T
    yw = (y * y) @ w.T
    cross = torch.einsum("ic,kc,jc->ikj", x, w, y)
    out = xw[:, None, :] + yw[None, :, :] - 2.0 * cross.transpose(1, 2)
    return out + b.to(torch.float32)
