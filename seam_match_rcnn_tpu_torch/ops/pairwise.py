"""Pairwise match scoring: logits[i, j] = W @ (x_i - y_j)**2 + b.

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


def pairwise_match_scores(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor) -> torch.Tensor:
    """softmax(logits)[..., 1] -> [N, M]: the match probability used for
    ranking.  Two-class softmax is sigmoid(l1 - l0), which is linear in
    (x - y)^2: d[i, j] = a_i + g_j - 2 (x o v) . y_j + c0 with v = w1 - w0,
    c0 = b1 - b0.  This is kernel K4's plain version."""
    x, y = x.to(torch.float32), y.to(torch.float32)
    v = (w[1] - w[0]).to(torch.float32)
    c0 = (b[1] - b[0]).to(torch.float32)
    a = (x * x) @ v
    g = (y * y) @ v
    cross = (x * v) @ y.T
    return torch.sigmoid(a[:, None] + g[None, :] - 2.0 * cross + c0)
