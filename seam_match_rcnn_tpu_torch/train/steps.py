"""The phase-1 training step.

Port of ``seam_match_rcnn_tpu/train/steps.py``'s ``Phase1Trainer``: one
optimizer update per batch with the fused batch's semantics, whether the
batch is one canvas bucket or several (mixed orientations).  In PyTorch the
several buckets need no rematerialised second forward:
``MatchRCNN.training_losses`` keeps every bucket's graph and computes the
batch's losses at once, and one ``backward()`` and one optimizer step
follow.  All bucket graphs stay alive until that backward: at batch 8
about one fused batch's activations.

The JAX package's gradient-accumulation triple (``make_phase1_grad_apply``)
is an ablation path and is not ported.

With a mesh, the step is the global batch's over the mesh's ``data`` axis,
each rank holding its share of the images (as the JAX package's step on a
data-sharded batch): ``training_losses`` normalizes by the global counts and
computes the match loss over every rank's slots, and the optimizer sums
the gradients over the ranks, averaging the match predictor's, which every
rank computes whole from the replicated match loss (the gradient scale is
set out in ``MatchRCNN.training_losses``).  Every rank then applies the same
update.  A step makes the same collectives on every rank, whatever its
bucket count: two in the losses, one gradient all-reduce, one for the
reported losses.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ..models.matchrcnn import MatchRCNN
from ..parallel.collectives import reduce_dict
from ..parallel.mesh import axis_group
from .optim import SGD


class Phase1Trainer:
    """``step(batches)`` runs one phase-1 update.  A batch is a dict with
    images [B, 3, H, W] in [0, 1], sizes [B, 2] and gt (see
    ``MatchRCNN.train_export``), all on the model's device.  With ``mesh``,
    the batches are this rank's share of the global batch (every rank
    holding as many images) and ``optimizer`` is set to synchronise the
    gradients over the mesh's ``data`` axis; every rank must start from the
    same weights."""

    def __init__(self, model: MatchRCNN, optimizer: SGD, mesh=None):
        self.model, self.optimizer = model, optimizer
        self.group = axis_group(mesh, "data")
        if self.group is not None:
            optimizer.distribute(self.group,
                                 mean=model.roi_heads["match_predictor"].parameters())

    def step(self, batches: Sequence[Dict], generator: Optional[torch.Generator] = None,
             draws: Optional[List[Dict[str, torch.Tensor]]] = None
             ) -> Dict[str, torch.Tensor]:
        """batches: one per canvas bucket; the samplers draw from
        ``generator``, or take ``draws`` (one dict per bucket).  Returns the
        detached losses of the (global) batch, with their sum as "loss",
        equal on every rank."""
        self.optimizer.zero_grad()
        losses = self.model.training_losses(batches, generator, draws, group=self.group)
        total = sum(losses.values())
        total.backward()
        self.optimizer.step()
        out = {k: v.detach() for k, v in losses.items()}
        if self.group is None:
            out["loss"] = total.detach()
            return out
        # the detector losses are this rank's shares: their sums are the
        # global batch's; the match loss is already the global one
        out.update(reduce_dict({k: v for k, v in out.items() if k != "loss_match"},
                               self.group, average=False))
        out["loss"] = sum(out.values())
        return out
