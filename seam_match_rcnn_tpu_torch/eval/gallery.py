"""Gallery scoring for retrieval.

Port of ``seam_match_rcnn_tpu/eval/gallery.py``: ``score_matrix``, the [Q, G]
match-probability matrix of street queries against shop gallery
descriptors, in f32 on the device (chunked over queries; on a CUDA device
every chunk is one launch of kernel K4, ``ops/cuda_kernels.pairwise_scores``,
with no size gate; eager PyTorch has no compile cache to feed, so the JAX
package's power-of-two shape buckets are not needed), or with
``dtype="fp16"`` the reference's numpy fp16 chain (``score_matrix_fp16``)
on the host; ``score_matrix_sharded``, the same matrix with the queries
sharded over a mesh axis; and ``rank_of``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda_kernels import pairwise_scores
from ..parallel.collectives import all_gather
from ..parallel.mesh import axis_group, axis_index, axis_size


def score_matrix_fp16(street: np.ndarray, shop: np.ndarray, w: np.ndarray, b: np.ndarray,
                      chunk: int = 512) -> np.ndarray:
    """The reference's numpy fp16 scoring chain, bit for bit: fp16
    descriptors, fp16 squared differences, fp16 matmul + bias, fp16 softmax
    -> [Q, G] f32.  Host numpy on purpose (the reference's rounding is
    numpy's); chunked over queries to bound the [chunk, G, 256] term."""
    street16 = np.asarray(street).astype(np.float16)
    shop16 = np.asarray(shop).astype(np.float16)
    wt = np.asarray(w).transpose().astype(np.float16)
    b16 = np.asarray(b).astype(np.float16)
    outs = []
    for i in range(0, max(len(street16), 1), chunk):
        part = street16[i: i + chunk]
        if len(part) == 0:
            break
        sq = (shop16[np.newaxis] - part[:, np.newaxis]) ** 2
        raw = sq @ wt + b16
        cls = np.exp(raw) / np.exp(raw).sum(2)[:, :, np.newaxis]
        outs.append(cls[:, :, 1])
    if not outs:
        return np.zeros((0, len(shop16)), np.float32)
    return np.concatenate(outs, 0).astype(np.float32)


def score_matrix(street, shop, w, b, device=None, chunk: int = 4096,
                 dtype: str = "f32") -> np.ndarray:
    """softmax((street - shop)^2 W^T + b)[..., 1] for all pairs -> [Q, G]
    f32 numpy.  ``street`` [Q, C], ``shop`` [G, C], ``w`` [2, C], ``b`` [2]
    (numpy arrays or tensors).  ``dtype="f32"`` scores on ``device``: by
    default the device of the first tensor among them, else the CUDA device;
    ``dtype="fp16"`` takes ``score_matrix_fp16`` on the host."""
    if dtype == "fp16":
        host = [a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
                for a in (street, shop, w, b)]
        return score_matrix_fp16(*host)
    if dtype != "f32":
        raise ValueError(f"unknown gallery dtype {dtype!r}: 'f32' or 'fp16'")
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


def score_matrix_sharded(street, shop, w, b, mesh, axis: str = "model",
                         device=None) -> np.ndarray:
    """``score_matrix``'s f32 [Q, G] with the queries sharded over the mesh
    ``axis`` (the JAX package's layout, eval/gallery.py:103-123): the
    queries padded to a multiple of the axis size, each rank scoring its
    shard against the whole (small) gallery with kernel K4 on its card,
    then one gather, so every rank returns the whole matrix.  Every rank
    passes the same inputs."""
    if device is None:
        device = next((a.device for a in (street, shop, w, b) if isinstance(a, torch.Tensor)),
                      torch.device("cuda"))
    street, shop, w, b = (torch.as_tensor(a, dtype=torch.float32, device=device)
                          for a in (street, shop, w, b))
    q, n, i = street.shape[0], axis_size(mesh, axis), axis_index(mesh, axis)
    per = -(-q // n)
    street = torch.cat([street, street.new_zeros((per * n - q, street.shape[1]))])
    mine = pairwise_scores(street[i * per:(i + 1) * per].contiguous(), shop, w, b)
    return all_gather(mine, axis_group(mesh, axis)).flatten(0, 1)[:q].cpu().numpy()


def rank_of(scores: np.ndarray, target: int) -> np.ndarray:
    """For each query row, the rank (0-based) of ``target`` when gallery
    entries are sorted by descending score (argsort + nonzero, as the
    reference)."""
    order = np.argsort(scores, axis=-1)[:, ::-1]
    return np.nonzero(order == target)[1]
