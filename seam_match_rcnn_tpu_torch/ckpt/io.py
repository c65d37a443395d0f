"""Training checkpoints as torch files.

Port of ``seam_match_rcnn_tpu/ckpt/io.py`` with the same API over torch
files instead of Orbax directories.  A payload is the reference's
``torch.save`` layout (train_matchrcnn.py:90-105): ``model_state_dict``
under the reference's key names, ``optimizer_state_dict``, and ``epoch``;
the port adds ``optimizer_count`` (the step count that drives the learning
rate schedule, ``train.optim.SGD.state_dict``), and a mid-epoch file adds
``step_in_epoch`` and, where the loop threads one, ``generator`` (a
``torch.Generator.get_state()``).  Tensors are stored on the CPU, so a file
loads on a machine without a card, and a payload holds only what
``torch.load(weights_only=True)`` accepts: no numpy, no objects.  The JAX
package's torch-file branch (``ckpt/torch_convert.unwrap_state_dict``) reads
the weights of such a file unchanged.

``CheckpointManager`` writes ``epochNNN.pt`` every ``save_epochs`` epochs
and ``final.pt``; ``save_mid`` overwrites the ``mid.pt`` slot by writing a
``.mid-<pid>-<n>.pt`` staging file and swapping it in with ``os.replace``,
so a kill during the write leaves the previous slot intact.  ``latest()``
ranks by modification time with the name as tiebreak and never considers a
dot-file.

Under a process group rank 0 writes every file and all ranks wait at a
barrier after the write; every rank reads on resume, and
``resolve_auto_resume`` hands all of them rank 0's choice.  A mid file of
W > 1 ranks holds every rank's generator state, [W, n]
(``generator_state``), and each rank restores its own row.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..parallel.collectives import (barrier, broadcast_object, gather_objects,
                                    is_main_process, process_count, process_index)

_LEAVES = (int, float, bool, str, type(None))


def _to_cpu(x: Any, where: str = "payload") -> Any:
    """``x`` with every tensor detached and on the CPU; raises TypeError for
    anything ``torch.load(weights_only=True)`` would refuse."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v, f"{where}[{k!r}]") for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v, f"{where}[{i}]") for i, v in enumerate(x))
    if isinstance(x, _LEAVES):
        return x
    raise TypeError(f"{where}: a checkpoint holds tensors, numbers, strings and "
                    f"containers of them, not {type(x).__name__}")


def save_checkpoint(path: str, payload: Dict[str, Any]) -> str:
    """Write ``payload`` to the torch file ``path``, through a dot-file in the
    same directory and ``os.replace``.  Returns ``path``."""
    path = os.path.abspath(path)
    head, name = os.path.split(path)
    tmp = os.path.join(head, f".{name}.{os.getpid()}.tmp")
    torch.save(_to_cpu(payload), tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of a torch file, its tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_training_checkpoint(path: str) -> Tuple[Dict[str, Any], bool]:
    """Restore an epoch-level or mid-epoch training checkpoint.  Returns
    ``(payload, is_mid)``: ``is_mid`` is True for a file that
    ``CheckpointManager.save_mid`` wrote, whose payload then also holds
    ``step_in_epoch`` (and ``generator`` for loops that thread one)."""
    payload = restore_checkpoint(path)
    return payload, "step_in_epoch" in payload


def training_payload(model: torch.nn.Module, optimizer, epoch: int,
                     **mid: Any) -> Dict[str, Any]:
    """The training CLIs' payload: the model's state dict, the optimizer's
    entries (``train.optim.SGD.state_dict``), ``epoch`` and, for a mid-epoch
    file, ``mid``'s entries (``step_in_epoch``, ``generator``)."""
    return {"model_state_dict": model.state_dict(), **optimizer.state_dict(),
            "epoch": epoch, **mid}


def generator_state(generator: torch.Generator) -> torch.Tensor:
    """The payload entry of ``generator``: its state, or under W > 1 ranks
    every rank's, stacked [W, n] in rank order (a collective)."""
    if process_count() == 1:
        return generator.get_state()
    return torch.stack(gather_objects(generator.get_state().cpu()))


def restore_training_state(payload: Dict[str, Any], model: torch.nn.Module, optimizer,
                           generator: Optional[torch.Generator] = None) -> None:
    """Load a ``training_payload`` into ``model`` and ``optimizer`` in place,
    and, when the payload carries one, the generator's state (this rank's
    row of a [W, n] entry)."""
    model.load_state_dict(payload["model_state_dict"])
    optimizer.load_state_dict(payload)
    if generator is not None and "generator" in payload:
        state = payload["generator"]
        if (state.dim() == 2) != (process_count() > 1) or (
                state.dim() == 2 and state.shape[0] != process_count()):
            raise ValueError(f"the checkpoint's generator states ({tuple(state.shape)}) were "
                             f"saved by another number of ranks than {process_count()}: a "
                             "mid-epoch file resumes at the world size that wrote it")
        generator.set_state(state[process_index()].clone() if state.dim() == 2 else state)


def resolve_auto_resume(save_dir: str, save_tag: str) -> Optional[str]:
    """``--auto_resume``: the newest checkpoint (the mid slot included) under
    ``save_dir/save_tag``, or None when there is nothing to resume from;
    rank 0's choice on every rank."""
    path = None
    directory = os.path.join(save_dir, save_tag)
    if is_main_process() and os.path.isdir(directory):
        path = CheckpointManager(directory).latest()
    return broadcast_object(path)


class CheckpointManager:
    """Periodic saver: ``epochNNN.pt`` every ``save_epochs`` epochs (0 = only
    ``final.pt``), and the overwriting ``mid.pt`` slot."""

    def __init__(self, directory: str, save_epochs: int = 2):
        self.directory = directory
        self.save_epochs = save_epochs
        self._mid_seq = -1
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, epoch: int, payload: Dict[str, Any], final: bool = False):
        """Rank 0 writes; every rank must call it (a barrier follows)."""
        if final or (self.save_epochs > 0 and epoch % self.save_epochs == 0):
            name = "final.pt" if final else f"epoch{epoch:03d}.pt"
            if is_main_process():
                save_checkpoint(os.path.join(self.directory, name), payload)
                self._clear_mid()
            barrier()

    def _clear_mid(self):
        """An epoch-level save supersedes the mid slot: drop it, and any
        staging file a crash left, so that ``latest()`` never resumes from a
        stale mid-epoch snapshot."""
        for name in os.listdir(self.directory):
            if name == "mid.pt" or name.startswith(".mid-") or (
                    name.startswith(".") and name.endswith(".tmp")):
                p = os.path.join(self.directory, name)
                if os.path.isfile(p):
                    os.remove(p)

    def save_mid(self, payload: Dict[str, Any]) -> str:
        """Overwrite the mid-epoch slot (no reference equivalent: the
        reference saves between epochs only): the payload goes to a
        ``.mid-<pid>-<n>.pt`` staging file, then replaces ``mid.pt``.  Rank 0
        writes; every rank must call it (a barrier follows)."""
        self._mid_seq += 1
        tmp = os.path.join(self.directory, f".mid-{os.getpid()}-{self._mid_seq}.pt")
        dst = os.path.join(self.directory, "mid.pt")
        if is_main_process():
            torch.save(_to_cpu(payload), tmp)
            os.replace(tmp, dst)
        barrier()
        return dst

    def latest(self) -> Optional[str]:
        """The newest checkpoint file, by modification time (name tiebreak).

        Not by name: a completed run leaves ``final.pt``, which sorts after
        every ``epochNNN.pt``, so a relaunch with more epochs that is then
        preempted must resume from its newest epoch save.  ``mid.pt`` lives
        only until the next epoch-level save, so while it exists it is the
        newest.  Dot-files (staging) are never considered."""
        entries = sorted(
            (e for e in os.listdir(self.directory)
             if e.endswith(".pt") and not e.startswith(".")
             and os.path.isfile(os.path.join(self.directory, e))),
            key=lambda e: (os.stat(os.path.join(self.directory, e)).st_mtime_ns, e))
        return os.path.join(self.directory, entries[-1]) if entries else None
