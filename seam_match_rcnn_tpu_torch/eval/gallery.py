"""Gallery scoring for retrieval, on the device.

Port of ``seam_match_rcnn_tpu/eval/gallery.py``'s f32 ``score_matrix``: the
[Q, G] match-probability matrix of street queries against shop gallery
descriptors, chunked over queries.  On a CUDA device every chunk is one
launch of kernel K4 (``ops/cuda_kernels.pairwise_scores``); there is no
size gate.  Eager PyTorch has no compile cache to feed, so the JAX
package's power-of-two shape buckets are not needed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda_kernels import pairwise_scores


def score_matrix(street, shop, w, b, device=None, chunk: int = 4096) -> np.ndarray:
    """softmax((street - shop)^2 W^T + b)[..., 1] for all pairs -> [Q, G]
    f32 numpy.  ``street`` [Q, C], ``shop`` [G, C], ``w`` [2, C], ``b`` [2]
    (numpy arrays or tensors) are scored on ``device``: by default the
    device of the first tensor among them, else the CUDA device."""
    if device is None:
        device = next((a.device for a in (street, shop, w, b) if isinstance(a, torch.Tensor)),
                      torch.device("cuda"))
    street, shop, w, b = (torch.as_tensor(a, dtype=torch.float32, device=device)
                          for a in (street, shop, w, b))
    q, g = street.shape[0], shop.shape[0]
    if q == 0:
        return np.zeros((0, g), np.float32)
    outs = [pairwise_scores(street[i:i + chunk], shop, w, b) for i in range(0, q, chunk)]
    return torch.cat(outs).cpu().numpy()
