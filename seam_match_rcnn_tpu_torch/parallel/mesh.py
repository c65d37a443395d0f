"""Device meshes and sharding helpers.

Port of ``seam_match_rcnn_tpu/parallel/mesh.py``: a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group with the JAX package's axes

  * ``data``: batch sharding (data parallelism).  The steps sum the
    gradients over it (``train/optim.SGD.distribute``), so the ranks train
    one model on the global batch, not independent replicas;
  * ``model``: sharding of the retrieval gallery's score matrix
    (``eval/gallery.score_matrix_sharded``).

Where the JAX package places arrays with a sharding and lets XLA insert the
collectives, here each rank holds its own slice (``shard_batch``) and the
callers call the collectives themselves (``parallel/collectives``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd.graph import increment_version


def make_mesh(data: int = -1, model: int = 1, device_type: str = "cuda"):
    """The (data, model) mesh over every rank of the process group (rank =
    data index x model + model index), on ``device_type``: the card unless
    the caller asks for "cpu" (without a card "cuda" raises).  ``data=-1``
    takes the ranks that ``model`` leaves.  Needs the process group
    (``initialize_distributed`` under ``SEAM_MULTIHOST=1``, or
    ``init_process_group``)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.collectives.initialize_distributed() under "
                           "SEAM_MULTIHOST=1 (or torch.distributed.init_process_group) first")
    n = dist.get_world_size()
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} does not cover the {n} ranks")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device (torch.cuda.is_available() is False); "
                           "pass device_type='cpu' for a mesh of CPU ranks")
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of ``mesh``'s ``axis`` through this rank (None
    without a mesh: the collectives' identity)."""
    return None if mesh is None else mesh.get_group(axis)


def _tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, (torch.Tensor, np.ndarray)) else tree


def shard_batch(batch: Any, mesh, axis: str = "data") -> Any:
    """This rank's slice of the leading axis of every tensor or array leaf
    along ``axis`` (a leading size the axis does not divide raises)."""
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)

    def take(x):
        if x.shape[0] % n:
            raise ValueError(f"shard_batch: leading size {x.shape[0]} is not a multiple of "
                             f"the {axis!r} axis size {n}")
        per = x.shape[0] // n
        return x[i * per:(i + 1) * per]

    return _tree_map(take, batch)


def replicate(module_or_tensors: Any, mesh) -> Any:
    """Rank 0's values on every rank of the mesh, in place: every parameter
    and buffer of an ``nn.Module``, or every tensor of a tree."""
    if mesh is None or mesh.size() == 1:
        return module_or_tensors
    if isinstance(module_or_tensors, torch.nn.Module):
        m = module_or_tensors
        tensors = list(m.parameters()) + list(m.buffers())
    else:
        tensors = []
        _tree_map(lambda t: tensors.append(t) if isinstance(t, torch.Tensor) else None,
                  module_or_tensors)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)
    for t in tensors:  # the broadcast writes past the version counters, which caches
        increment_version(t)  # read (FrozenBatchNorm2d's compute-dtype scale and shift)
    return module_or_tensors


def reduce_scalars(tree: Any) -> Any:
    """Python floats of a tree of scalars, for logging.  The steps return
    the global batch's losses, equal on every rank, so nothing is reduced
    here (as in the JAX package)."""
    if isinstance(tree, dict):
        return {k: reduce_scalars(v) for k, v in tree.items()}
    return float(tree)
