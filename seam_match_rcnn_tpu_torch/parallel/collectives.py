"""Process groups and collectives of the port.

Port of ``seam_match_rcnn_tpu/parallel/collectives.py``.  The JAX package
runs one controller a host, and a jitted loss over a data-sharded batch is
already reduced over the mesh; here every rank is a process of its own, so
the collectives are ``torch.distributed`` calls that every rank of a group
must make in the same order with the same shapes.

* ``initialize_distributed``: the gate (``SEAM_MULTIHOST=1``), the env
  rendezvous of ``torchrun`` and the backend rule (``dist_backend``).
* The rank helpers ``process_index``, ``process_count``,
  ``is_main_process``.
* ``all_reduce_sum``, ``all_gather``, ``reduce_dict``, ``gather_objects``,
  ``broadcast_object``, ``barrier`` and ``lockstep`` over a group (the
  default group when None).  Tensor collectives carry no gradient.

Without a process group every helper is the identity and runs no
collective; a group of one rank (a one-rank NCCL group, say) still runs
them.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Iterable, Iterator, List, Optional

import torch
import torch.distributed as dist

TORCHRUN_MARKERS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "TORCHELASTIC_RUN_ID")


def _gate_on() -> bool:
    return os.environ.get("SEAM_MULTIHOST", "") in ("1", "true")


def dist_backend(local_world_size: int, device_count: int,
                 requested: Optional[str] = None) -> str:
    """The backend of a process group: ``requested`` (by default
    ``SEAM_DIST_BACKEND``) when set, else NCCL where there are cards and Gloo
    where there are none.  NCCL needs a card a rank: with more ranks on a
    host than cards it refuses at init, so asking for it there (or leaving
    the choice to the rule) raises instead of switching transports."""
    requested = requested or os.environ.get("SEAM_DIST_BACKEND") or None
    if requested not in (None, "nccl", "gloo"):
        raise ValueError(f"SEAM_DIST_BACKEND={requested!r}: 'nccl' or 'gloo'")
    if requested == "gloo" or (requested is None and device_count == 0):
        return "gloo"
    if local_world_size > device_count:
        raise RuntimeError(
            f"{local_world_size} ranks on this host share {device_count} CUDA device(s): NCCL "
            "needs one device a rank. Set SEAM_DIST_BACKEND=gloo to run the collectives "
            "over Gloo (the compute stays on the cards), or start one rank a card")
    return "nccl"


def initialize_distributed() -> None:
    """Join the process group of a ``torchrun``-style launch.

    A no-op unless ``SEAM_MULTIHOST=1``, as in the JAX package; then it
    calls ``torch.distributed.init_process_group`` from the env rendezvous
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE) with ``dist_backend``'s
    backend and makes ``LOCAL_RANK``'s card the current one (a rank's card
    is LOCAL_RANK modulo the cards, where Gloo ranks share them).  Without
    the gate but with torchrun's markers set it warns loudly: each process
    would then train as an independent single-process job."""
    if not _gate_on():
        markers = [k for k in TORCHRUN_MARKERS if os.environ.get(k)]
        if markers:
            warnings.warn(
                f"torchrun environment detected ({', '.join(markers)} set) but SEAM_MULTIHOST "
                "is not 1: skipping torch.distributed.init_process_group; this process will "
                "run as an INDEPENDENT single-process job. Set SEAM_MULTIHOST=1 to join the "
                "process group.", RuntimeWarning, stacklevel=2)
        return
    if dist.is_initialized():
        return
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    count = torch.cuda.device_count()
    backend = dist_backend(local_world, count)
    if count:
        torch.cuda.set_device(local_rank % count)
    dist.init_process_group(backend, init_method="env://")


def _size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (the reference's ``get_rank``), 0 without a
    process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (the reference's ``get_world_size``)."""
    return _size()


def is_main_process() -> bool:
    return process_index() == 0


def _device(group=None) -> torch.device:
    """Where a helper's own tensors go: the current card under NCCL, the
    host under Gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, as a new tensor (``x`` is
    left as it is)."""
    if not dist.is_initialized():
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading axis, [W, *x.shape] in
    rank order (``jax.lax.all_gather``'s layout); every rank's ``x`` must
    have the same shape and dtype."""
    if not dist.is_initialized():
        return x[None]
    out = torch.empty((_size(group),) + tuple(x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather(list(out.unbind(0)), x.detach().contiguous(), group=group)
    return out


def reduce_dict(d: Dict[str, torch.Tensor], group=None,
                average: bool = True) -> Dict[str, torch.Tensor]:
    """The reference's ``reduce_dict``: each scalar of ``d`` averaged (or
    summed) over the group, in one all-reduce."""
    if not dist.is_initialized() or not d:
        return dict(d)
    keys = list(d)
    total = all_reduce_sum(torch.stack([d[k].detach().to(torch.float32) for k in keys]), group)
    if average:
        total = total / _size(group)
    return {k: total[i] for i, k in enumerate(keys)}


def gather_objects(obj: Any, group=None) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order, on every rank; the
    payloads may differ in size."""
    if not dist.is_initialized():
        return [obj]
    out: List[Any] = [None] * _size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_object(obj: Any, src: int = 0, group=None) -> Any:
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def barrier(group=None) -> None:
    if dist.is_initialized():
        dist.barrier(group=group)


def lockstep(items: Iterable, group=None) -> Iterator:
    """``items`` for as long as every rank of the group has one: one small
    all-reduce an item, so that ranks whose shards hold different numbers of
    batches take the same number of steps and none waits in a collective
    that the others never reach."""
    if not dist.is_initialized():
        yield from items
        return
    it = iter(items)
    flag = torch.zeros((1,), dtype=torch.int32, device=_device(group))
    while True:
        try:
            item, have = next(it), 1
        except StopIteration:
            item, have = None, 0
        flag.fill_(have)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
        if not int(flag.item()):
            return
        yield item
