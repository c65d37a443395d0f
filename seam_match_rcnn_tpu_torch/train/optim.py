"""Optimizer and learning-rate schedule of phase 1.

Port of ``seam_match_rcnn_tpu/train/optim.py``: SGD with momentum 0.9 over
the trainable parameters only, a MultiStepLR schedule and a linear warmup
from ``warmup_factor`` over at most 1000 steps of the first epoch (the
reference's recipe).  ``torch.optim.SGD`` has the optax chain's semantics:
weight decay added to the gradient, heavy-ball momentum with dampening 0
and a first momentum buffer equal to the gradient, update = -lr * buffer.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Sequence

import torch

from ..parallel.collectives import all_reduce_sum

def backbone_frozen_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """Parameter name -> trainable, as the reference's optimizer sees it.
    The backbone marks its frozen stem and layer1 (torchvision's
    ``trainable_layers=3``) with ``requires_grad=False``; its FrozenBatchNorm2d
    affines are buffers here, so they are never parameters."""
    return {name: p.requires_grad for name, p in model.named_parameters()}


def multistep_warmup_schedule(base_lr: float, milestones: Sequence[int], gamma: float,
                              steps_per_epoch: int, warmup_iters: int,
                              warmup_factor: float) -> Callable[[int], float]:
    """step -> lr, counting optimizer steps from 0 as optax does.  The warmup
    applies within epoch 0 only; as the reference clamps it to
    ``steps_per_epoch - 1``, a one-step epoch has none."""
    warmup_iters = min(warmup_iters, steps_per_epoch - 1)

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        decay = gamma ** sum(epoch >= m for m in milestones)
        if warmup_iters <= 0 or epoch >= 1:
            return base_lr * decay
        alpha = min(max(step / warmup_iters, 0.0), 1.0)
        return base_lr * decay * (warmup_factor * (1 - alpha) + alpha)

    return schedule


class SGD:
    """``torch.optim.SGD`` over ``params`` with the learning rate of
    ``schedule(step)`` at each step, and optional global-norm clipping of the
    raw gradients first, written the optax way (scale = max_norm / max(norm,
    max_norm)).  After ``distribute(group)`` the gradients are summed over
    the group's ranks before the clip, so every rank applies the same
    update."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Callable[[int], float],
                 momentum: float = 0.9, weight_decay: float = 0.0,
                 clip_grad_norm: float = 0.0):
        self.params = list(params)
        self.schedule = schedule
        self.clip_grad_norm = clip_grad_norm
        self.optimizer = torch.optim.SGD(self.params, lr=schedule(0), momentum=momentum,
                                         dampening=0.0, weight_decay=weight_decay)
        self.count = 0
        self.group, self._mean = None, None

    def distribute(self, group, mean: Iterable[torch.nn.Parameter] = ()) -> "SGD":
        """Synchronise the gradients over ``group`` at each ``step``, in one
        flattened all-reduce: summed, but averaged for the parameters in
        ``mean`` (those every rank computes the whole gradient of, from a
        loss replicated on every rank).  A parameter that has a gradient on
        some rank gets the synchronised one on all; one that has none on
        any rank keeps none, so the update skips it as on one process."""
        ids = {id(p) for p in mean}
        self.group, self._mean = group, [id(p) in ids for p in self.params]
        return self

    def _sync_gradients(self) -> None:
        ref = next(p for p in self.params)
        parts = [p.grad.reshape(-1).to(torch.float32) if p.grad is not None
                 else torch.zeros(p.numel(), dtype=torch.float32, device=ref.device)
                 for p in self.params]
        parts.append(torch.tensor([float(p.grad is not None) for p in self.params],
                                  device=ref.device))
        flat = all_reduce_sum(torch.cat(parts), self.group)
        world = torch.distributed.get_world_size(self.group)
        has = flat[-len(self.params):].tolist()
        offset = 0
        for p, mean, h in zip(self.params, self._mean, has):
            g = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
            p.grad = ((g / world) if mean else g).to(p.dtype) if h else None

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        if self.group is not None:
            self._sync_gradients()
        if self.clip_grad_norm:
            grads = [p.grad for p in self.params if p.grad is not None]
            norm = torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in grads))
            scale = self.clip_grad_norm / torch.clamp(norm, min=self.clip_grad_norm)
            for g in grads:
                g.mul_(scale)
        for group in self.optimizer.param_groups:
            group["lr"] = float(self.schedule(self.count))
        self.optimizer.step()
        self.count += 1

    def state_dict(self) -> Dict[str, object]:
        """The checkpoint entries of the optimizer: the torch optimizer's
        state dict (momentum buffers keyed by position in ``params``) as the
        reference's ``optimizer_state_dict``, and the step ``count`` that
        drives the schedule as ``optimizer_count``."""
        return {"optimizer_state_dict": self.optimizer.state_dict(),
                "optimizer_count": self.count}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Restore ``state_dict()``'s entries (a checkpoint payload holds
        them).  The momentum buffers go to their parameters by position, so
        ``params`` must be the saving run's trainable list in its order:
        build the optimizer the same way (``sgd`` with the same frozen
        mask)."""
        self.optimizer.load_state_dict(state["optimizer_state_dict"])
        self.count = int(state["optimizer_count"])


def sgd(model: torch.nn.Module, schedule: Callable[[int], float], momentum: float = 0.9,
        weight_decay: float = 0.0, clip_grad_norm: float = 0.0) -> SGD:
    """SGD over the parameters ``backbone_frozen_mask`` keeps.  A frozen
    parameter is simply not in the optimizer, so it gets no update and no
    momentum or decay state."""
    mask = backbone_frozen_mask(model)
    return SGD([p for name, p in model.named_parameters() if mask[name]],
               schedule, momentum, weight_decay, clip_grad_norm)
