"""Random weights from the seed, made on the device in a few large calls.

The initializers are the port's (``init_parameters`` in
``seam_match_rcnn_tpu_torch/models/matchrcnn.py``, the JAX package's): lecun-normal
convs and dense layers with zero biases, N(0, 0.01) RPN convs, He fan-out mask
convs, identity BatchNorm statistics and a zero NLB output projection.  The
rule is read from each tensor's name and shape, so the same call makes the same
state dict for the port's model and for the reference (their names are equal).
All normal draws come from one ``torch.randn`` on a generator of the device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

_BN_EPS = 1e-5


def _rule(name: str, shape: Tuple[int, ...], frozen_bn: bool):
    """-> ("const", value) or ("normal", std) for the tensor ``name``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "num_batches_tracked":
        return "const", 0.0
    if leaf == "running_mean":
        return "const", 0.0
    if leaf == "running_var":
        # FrozenBN: scale = weight / sqrt(var + eps) == 1, as the JAX init
        return "const", (1.0 - _BN_EPS) if frozen_bn else 1.0
    if leaf == "bias":
        return "const", 0.0
    if len(shape) == 1:  # a BatchNorm's weight
        return "const", 1.0
    if name.startswith("rpn."):
        return "normal", 0.01
    if name.endswith("newnlb.W.weight"):
        return "const", 0.0
    if ".mask_head." in name or ".mask_predictor." in name:
        per_out = 1
        for s in shape[2:]:
            per_out *= s
        # ConvTranspose2d keeps [in, out, kh, kw]
        fan_out = (shape[1] if "conv5_mask" in name else shape[0]) * per_out
        return "normal", (2.0 / fan_out) ** 0.5
    fan_in = 1
    for s in shape[1:]:
        fan_in *= s
    return "normal", (1.0 / fan_in) ** 0.5


def make_state(model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of ``model``'s names and shapes, drawn from ``seed`` on
    ``device``.  ``model`` may live on the meta device."""
    frozen = {n for n, m in model.named_modules()
              if hasattr(m, "running_var") and not isinstance(m, torch.nn.BatchNorm1d)}
    shapes = {n: (tuple(t.shape), t.dtype) for n, t in model.state_dict().items()}
    rules = {n: _rule(n, s, n.rsplit(".", 1)[0] in frozen) for n, (s, _) in shapes.items()}
    normals = [n for n, r in rules.items() if r[0] == "normal"]
    total = sum(torch.Size(shapes[n][0]).numel() for n in normals)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    state, offset = {}, 0
    for n, (shape, dtype) in shapes.items():
        kind, v = rules[n]
        if kind == "const":
            state[n] = torch.full(shape, v, dtype=dtype, device=device)
        else:
            k = torch.Size(shape).numel()
            state[n] = (flat[offset:offset + k].view(shape) * v).to(dtype)
            offset += k
    return state
