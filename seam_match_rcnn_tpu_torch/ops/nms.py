"""Exact greedy NMS with tensor ops, batched over a leading axis.

Port of ``seam_match_rcnn_tpu/ops/nms.py``.  Boxes are sorted by score
(stable, so ties keep their input order as in the reference) and the greedy
recursion

    kept[i] = alive[i] & ~any_{j<i}(kept[j] & iou(i, j) > t)

is solved by Jacobi iteration on the whole [N, N] conflict matrix.  The
fixpoint is unique (induction over the score order) and equals the greedy
solution, and position i is final after i + 1 steps, so the loop ends with
the exact greedy result; it typically converges in a handful of steps.  All
rows of the batch iterate together, and the host reads back one flag per
step, instead of once per box as a Python loop over boxes would.

The loop is the ``while_loop`` higher-order operator of
``torch._higher_order_ops``, the counterpart of the JAX package's
``lax.while_loop``: it carries (kept, done), all on the boxes' device, and
stops once a step changes nothing.  Eagerly it runs the steps as a Python
loop that reads ``done`` on the host after each; under ``torch.export`` it
stays one loop node of the graph, where a Python loop that breaks on tensor
data cannot be traced.  The operator is called directly, with the conflict
matrix and the valid mask as explicit operands: the public
``torch._higher_order_ops.while_loop`` lifts closures by compiling the call
with Dynamo every time, which on the H100 cost 9-15 s for the first call
of a process and up to 2.3 ms a call after it (``tools/time_torch_nms.py``).

Under a profiler each call is a ``seam.nms`` span, and the host counts its
calls (``nms.calls``) and eager steps (``nms.steps``), each step one host
read-back (``utils/profiling``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch._higher_order_ops.while_loop import while_loop_op

from ..utils.profiling import annotate, count
from .boxes import box_iou

_NEG_INF = -1e10


def _not_done(kept, done, conflict_f, svalid):
    return ~done


def _step(kept, done, conflict_f, svalid):
    """One Jacobi step: (kept, done) -> (the new kept, whether it equals kept)."""
    count("nms.steps")
    hit = torch.bmm(conflict_f, kept.to(torch.float32)[..., None])[..., 0] > 0
    new = svalid & ~hit
    return new, (new == kept).all()


def _kept_sorted(sboxes: torch.Tensor, svalid: torch.Tensor, iou_threshold: float
                 ) -> torch.Tensor:
    """sboxes [M, N, 4], svalid [M, N] in score order -> kept [M, N]."""
    n = sboxes.shape[1]
    if n == 0:
        return svalid.clone()
    earlier = torch.ones((n, n), dtype=torch.bool, device=sboxes.device).tril(-1)
    conflict = (box_iou(sboxes, sboxes) > iou_threshold) & earlier
    conflict_f = conflict.to(torch.float32)
    done = torch.zeros((), dtype=torch.bool, device=sboxes.device)
    count("nms.calls")
    kept, _ = while_loop_op(_not_done, _step, (svalid, done), (conflict_f, svalid))
    return kept


def _sort(boxes, scores, valid):
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    order = torch.argsort(-scores, dim=-1, stable=True)
    sboxes = torch.take_along_dim(boxes, order[..., None], dim=-2)
    svalid = torch.take_along_dim(valid, order, dim=-1)
    return order, sboxes, svalid


def nms_kept_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                  valid: torch.Tensor) -> torch.Tensor:
    """[M, N, 4] boxes, [M, N] scores -> [M, N] survivor mask in ORIGINAL order.
    ``valid`` False entries are never kept and never suppress."""
    with annotate("seam.nms"):
        order, sboxes, svalid = _sort(boxes, scores, valid)
        kept = _kept_sorted(sboxes, svalid, iou_threshold)
        return torch.zeros_like(kept).scatter(-1, order, kept)


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
               max_output: int, valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[M, N, 4], [M, N] -> (indices [M, max_output] int64 into N, score
    ordered and -1 padded; mask [M, max_output])."""
    m = scores.shape[0]
    with annotate("seam.nms"):
        order, sboxes, svalid = _sort(boxes, scores, valid)
        kept = _kept_sorted(sboxes, svalid, iou_threshold)
        rank = torch.cumsum(kept.to(torch.int64), dim=-1) - 1
        slot = torch.where(kept & (rank < max_output), rank, torch.full_like(rank, max_output))
        out = torch.full((m, max_output + 1), -1, dtype=torch.int64, device=boxes.device)
        out.scatter_(-1, slot, torch.where(slot < max_output, order, torch.full_like(order, -1)))
        indices = out[:, :max_output]
        return indices, indices >= 0


def batched_nms_padded(boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor,
                       iou_threshold: float, max_output: int, valid: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Category-aware NMS by the coordinate-offset trick (torchvision
    ``batched_nms``): boxes with different ``idxs`` never suppress each
    other.  The offset scale is the largest valid coordinate per row."""
    max_coord = torch.where(valid[..., None], boxes, torch.zeros_like(boxes)).amax(dim=(-2, -1))
    offsets = idxs.to(boxes.dtype) * (max_coord[:, None] + 1.0)
    return nms_padded(boxes + offsets[..., None], scores, iou_threshold, max_output, valid)
