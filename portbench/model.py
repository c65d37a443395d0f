"""Configurations from ``configs/<name>.json`` to models: the port's model with
the seed's weights on the card, and the reference's.

A configuration file holds ``model``, the fields of ``ModelConfig`` as the port
runs them (nested groups as objects), ``video`` (the SEAM video model or the
image model), and ``source``, ``reduced`` and ``assumed``."""

from __future__ import annotations

import dataclasses
import json
import time
import typing
from pathlib import Path

import torch

from . import weights

HERE = Path(__file__).resolve().parent


class Clock:
    """Laps of set-up on the host clock, each ending in a synchronise."""

    def __init__(self, device):
        self.device, self.laps, self.t = device, {}, time.perf_counter()

    def lap(self, name: str) -> None:
        if self.device == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.laps[name] = now - self.t
        self.t = now


def load_config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def _build(cls, d: dict):
    """A (nested) frozen dataclass from its dict; lists become tuples."""
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        t = hints[f.name]
        if dataclasses.is_dataclass(t):
            kw[f.name] = _build(t, v)
        else:
            kw[f.name] = tuple(v) if isinstance(v, list) else v
    return cls(**kw)


def port_config(cfg: dict, transform=None):
    """The port's ``ModelConfig``; ``transform`` replaces the transform config
    (the CPU tests' small canvases)."""
    from seam_match_rcnn_tpu_torch.config import ModelConfig

    mc = _build(ModelConfig, cfg["model"])
    return mc if transform is None else dataclasses.replace(mc, transform=transform)


def reference_config(cfg: dict, compute_dtype: str = "float32", transform=None):
    """The reference's ``ModelConfig``: the same sizes, computed in float32
    (or, for the control, ``layers.FP8``) with f32 trunks."""
    from .reference.config import MatchHeadConfig, ModelConfig

    mc = _build(ModelConfig, cfg["model"])
    mc = dataclasses.replace(mc, compute_dtype=compute_dtype,
                             match=dataclasses.replace(mc.match, trunk_dtype="float32"))
    if transform is not None:
        mc = dataclasses.replace(mc, transform=transform)
    assert isinstance(mc.match, MatchHeadConfig)
    return mc


def port_model(cfg: dict, seed: int, device, transform=None):
    """The port's ``MatchRCNN`` with the seed's weights, made on ``device``."""
    from seam_match_rcnn_tpu_torch.models.matchrcnn import MatchRCNN

    with torch.device("meta"):
        model = MatchRCNN(port_config(cfg, transform), video=cfg["video"])
    model = model.to_empty(device=device)
    model.load_state_dict(weights.make_state(model, seed, device), strict=True)
    return model


def reference_model(cfg: dict, seed: int, device, compute_dtype: str = "float32",
                    transform=None):
    """The reference with the same weights, drawn again from the seed."""
    from .reference import model as ref

    rcfg = reference_config(cfg, compute_dtype, transform)
    with torch.device("meta"):
        shell = ref.MatchRCNN(rcfg, cfg["video"])
    return ref.build(rcfg, cfg["video"], weights.make_state(shell, seed, device), device)
