"""Torch checkpoints into the port, and the phase-2 warm start.

Counterpart of ``seam_match_rcnn_tpu/ckpt/torch_convert.py`` for the port,
whose modules carry the reference's torchvision key names: a torch file of
the reference (or of the port) loads with ``load_state_dict``, after the
``module.`` prefix of DistributedDataParallel and the ``{epoch,
model_state_dict, ...}`` wrapper of the reference's CLIs are taken off.
No layout changes.  ``clone_match_to_aggregator`` is the reference's
``load_saved_matchrcnn`` warm start (video_matchrcnn.py:325-328): the
temporal aggregator's trunk, ``last`` scorer and BatchNorm statistics
become copies of the match predictor's, and its NLB and attention keep
their values; a checkpoint without an aggregator gives it the JAX
converter's fresh NLB and attention (``fresh_aggregator_extras``), so that
both packages warm-start the same aggregator from one phase-1 file.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

_TA = "roi_heads.temporal_aggregator."


def unwrap_state_dict(ckpt: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The state dict of a checkpoint: ``model_state_dict`` when wrapped,
    the ``module.`` prefix removed, ``num_batches_tracked`` counters
    dropped (nothing reads them)."""
    sd = ckpt.get("model_state_dict", ckpt)
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if not k.endswith("num_batches_tracked"):
            out[k] = torch.as_tensor(v)
    return out


@torch.no_grad()
def clone_match_to_aggregator(model: torch.nn.Module) -> torch.nn.Module:
    """Copy the match predictor's trunk (convs, linear, BatchNorm affine and
    running statistics) and ``last`` into the temporal aggregator of the
    video ``model``, in place; returns the model."""
    mp = model.roi_heads["match_predictor"]
    ta = model.roi_heads["temporal_aggregator"]
    src = dict(mp.named_parameters())
    src.update(mp.named_buffers())
    for name, t in list(ta.named_parameters()) + list(ta.named_buffers()):
        if name in src:
            t.copy_(src[name])
    return model


_clone = clone_match_to_aggregator  # the name load_pretrained_detector's flag shadows


def fresh_aggregator_extras(d_model: int = 256) -> Dict[str, torch.Tensor]:
    """The temporal aggregator's attention scorer and NLB as the JAX
    converter draws them for a checkpoint without an aggregator
    (``_fresh_aggregator_extras``: ``RandomState(0)``, uniform weights and
    biases in +-1/sqrt(fan_in), W_z zero so that the NLB starts as an
    identity residual), drawn in the same order, under the port's key
    names."""
    rng = np.random.RandomState(0)
    inter = d_model // 2
    sd = {}

    def dense(key, i, o):  # a JAX Dense kernel [i, o] -> torch weight [o, i]
        lim = 1.0 / np.sqrt(i)
        kernel = rng.uniform(-lim, lim, (i, o)).astype(np.float32)
        bias = rng.uniform(-lim, lim, (o,)).astype(np.float32)
        shape = (o, i) if key == "attention_scorer" else (o, i, 1)  # Linear, Conv1d
        sd[f"{_TA}{key}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.T)).reshape(shape)
        sd[f"{_TA}{key}.bias"] = torch.from_numpy(bias)

    dense("attention_scorer", d_model, 1)
    for name in ("theta", "phi", "g"):
        dense(f"newnlb.{name}", d_model, inter)
    sd[f"{_TA}newnlb.W.weight"] = torch.zeros((d_model, inter, 1))
    sd[f"{_TA}newnlb.W.bias"] = torch.zeros((d_model,))
    lim = 1.0 / np.sqrt(2 * inter)
    concat_w = rng.uniform(-lim, lim, (2 * inter, 1)).astype(np.float32)
    sd[f"{_TA}newnlb.concat_project.0.weight"] = torch.from_numpy(
        np.ascontiguousarray(concat_w.T)).reshape(1, 2 * inter, 1, 1)
    return sd


def load_pretrained_detector(path_or_state_dict: Union[str, Mapping[str, Any]],
                             model: torch.nn.Module,
                             clone_match_to_aggregator: bool = True) -> torch.nn.Module:
    """Warm-start the video ``model`` from a phase-1 torch checkpoint (a
    path to a torch file, or its loaded dict), in place.

    Every key of the model must be in the checkpoint but the temporal
    aggregator's; with none of those the aggregator is warm-started from
    the match predictor whatever ``clone_match_to_aggregator`` says, and its
    NLB and attention are ``fresh_aggregator_extras()``, as in the JAX
    converter; with them it is only when the flag asks.  Keys the model
    lacks raise.  The port's own phase-1 and phase-2 files (``ckpt/io``) load
    here as the reference's do.  An Orbax directory of the JAX package's CLIs
    raises: ``tools/orbax_to_torch.py`` converts it to a torch file first."""
    if isinstance(path_or_state_dict, str) and os.path.isdir(path_or_state_dict):
        raise NotImplementedError(
            f"{path_or_state_dict} is a directory: convert an Orbax checkpoint of the JAX "
            "package's CLIs with tools/orbax_to_torch.py and pass the torch file it writes")
    if isinstance(path_or_state_dict, str):
        path_or_state_dict = torch.load(path_or_state_dict, map_location="cpu",
                                        weights_only=True)
    sd = unwrap_state_dict(path_or_state_dict)
    want = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    has_ta = any(k.startswith(_TA) for k in sd)
    missing = sorted(k for k in want - set(sd) if has_ta or not k.startswith(_TA))
    unexpected = sorted(set(sd) - want)
    if missing or unexpected:
        raise ValueError(f"load_pretrained_detector: checkpoint keys do not fit the model: "
                         f"missing {missing[:5]} ({len(missing)}), unexpected "
                         f"{unexpected[:5]} ({len(unexpected)})")
    if not has_ta:
        sd.update(fresh_aggregator_extras())
    model.load_state_dict(sd, strict=False)
    if clone_match_to_aggregator or not has_ta:
        _clone(model)
    return model


@torch.no_grad()
def import_imagenet_backbone(model: torch.nn.Module,
                             resnet_state_dict: Mapping[str, Any]) -> torch.nn.Module:
    """Warm-start the backbone body from a plain torchvision ``resnet50``
    ImageNet state dict (keys ``conv1.weight``, ``layer1.0.conv1.weight``,
    ...), in place: the reference's ``pretrained_backbone=True``
    (models/matchrcnn.py:486) and the JAX package's function of the same
    name.  ``fc.*`` and ``num_batches_tracked`` are dropped; every other key
    becomes ``backbone.body.<key>``, and the keys must be exactly the body's.
    The FPN and the heads keep their values.  Returns the model."""
    sd = {f"backbone.body.{k}": torch.as_tensor(v) for k, v in resnet_state_dict.items()
          if not k.startswith("fc.") and not k.endswith("num_batches_tracked")}
    want = {k for k in model.state_dict()
            if k.startswith("backbone.body.") and not k.endswith("num_batches_tracked")}
    if set(sd) != want:
        raise ValueError(f"import_imagenet_backbone: not a resnet50 body: missing "
                         f"{sorted(want - set(sd))[:5]}, unexpected {sorted(set(sd) - want)[:5]}")
    model.load_state_dict(sd, strict=False)
    return model
