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
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ..models.matchrcnn import MatchRCNN
from .optim import SGD


class Phase1Trainer:
    """``step(batches)`` runs one phase-1 update.  A batch is a dict with
    images [B, 3, H, W] in [0, 1], sizes [B, 2] and gt (see
    ``MatchRCNN.train_export``), all on the model's device."""

    def __init__(self, model: MatchRCNN, optimizer: SGD):
        self.model, self.optimizer = model, optimizer

    def step(self, batches: Sequence[Dict], generator: Optional[torch.Generator] = None,
             draws: Optional[List[Dict[str, torch.Tensor]]] = None
             ) -> Dict[str, torch.Tensor]:
        """batches: one per canvas bucket; the samplers draw from
        ``generator``, or take ``draws`` (one dict per bucket).  Returns the
        detached losses, with their sum as "loss"."""
        self.optimizer.zero_grad()
        losses = self.model.training_losses(batches, generator, draws)
        total = sum(losses.values())
        total.backward()
        self.optimizer.step()
        out = {k: v.detach() for k, v in losses.items()}
        out["loss"] = total.detach()
        return out
