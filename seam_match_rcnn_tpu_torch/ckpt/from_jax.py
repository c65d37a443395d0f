"""Weight bridge: JAX variables -> the port's torch state dict.

The inverse of ``seam_match_rcnn_tpu.ckpt.torch_convert.convert_state_dict``:
the JAX ``{'params', 'batch_stats'}`` tree (numpy leaves) becomes a state
dict with the reference's torchvision key names, so
``convert_state_dict(model.state_dict())`` gives the JAX tree back.  Every
JAX leaf is used exactly once; a leaf left over or missing raises, and so
does a torch key the model lacks or does not receive (``strict`` load).

Conversions: conv HWIO -> OIHW; Dense [in, out] -> Linear [out, in]; fc6's
HWC flatten order -> torchvision's CHW order; conv-transpose kernels
un-flipped; NLB Dense kernels -> Conv1d [out, in, 1]; ``concat_w`` [2C', 1]
-> Conv2d [1, 2C', 1, 1]; FrozenBN (scale, shift) -> weight = scale, bias =
shift, running_mean = 0, running_var = 1 - eps.  In f32, (1 - 1e-5) + 1e-5
rounds to exactly 1.0, so the port's scale = weight / sqrt(var + eps) equals
the JAX scale bit for bit (the 1-ulp drift this form could cause does not
occur at eps = 1e-5).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

_EPS = 1e-5


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, dtype=np.float32)
    return out


class _Leaves:
    """JAX leaves by path; each may be taken once."""

    def __init__(self, variables):
        self.params = _flatten(variables["params"])
        self.stats = _flatten(variables.get("batch_stats", {}))

    def take(self, *path, stats=False) -> np.ndarray:
        pool = self.stats if stats else self.params
        if path not in pool:
            raise KeyError(f"JAX leaf {'/'.join(path)} missing (or used twice)")
        return pool.pop(path)

    def left(self):
        return ["params/" + "/".join(p) for p in self.params] + \
               ["batch_stats/" + "/".join(p) for p in self.stats]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))  # a writable copy


def load_jax_variables(model: torch.nn.Module, variables: Dict[str, Any]) -> torch.nn.Module:
    """Load a JAX MatchRCNN variables tree into the port's ``model``
    (``models.matchrcnn.MatchRCNN``) in place; returns the model."""
    jx = _Leaves(variables)
    sd: Dict[str, torch.Tensor] = {}

    def conv(key, *path, bias=True):
        sd[f"{key}.weight"] = _t(jx.take(*path, "kernel").transpose(3, 2, 0, 1))
        if bias:
            sd[f"{key}.bias"] = _t(jx.take(*path, "bias"))

    def dense(key, *path):
        sd[f"{key}.weight"] = _t(jx.take(*path, "kernel").T)
        sd[f"{key}.bias"] = _t(jx.take(*path, "bias"))

    def frozen_bn(key, *path):
        scale = jx.take(*path, "scale")
        sd[f"{key}.weight"] = _t(scale)
        sd[f"{key}.bias"] = _t(jx.take(*path, "shift"))
        sd[f"{key}.running_mean"] = torch.zeros(scale.shape)
        sd[f"{key}.running_var"] = torch.full(scale.shape, 1.0 - _EPS)

    body = ("backbone", "body")
    conv("backbone.body.conv1", *body, "conv1", bias=False)
    frozen_bn("backbone.body.bn1", *body, "bn1")
    for stage, n in enumerate((3, 4, 6, 3)):
        for b in range(n):
            pre, node = f"backbone.body.layer{stage + 1}.{b}", f"layer{stage + 1}_{b}"
            for i in (1, 2, 3):
                conv(f"{pre}.conv{i}", *body, node, f"conv{i}", bias=False)
                frozen_bn(f"{pre}.bn{i}", *body, node, f"bn{i}")
            if b == 0:
                conv(f"{pre}.downsample.0", *body, node, "downsample_conv", bias=False)
                frozen_bn(f"{pre}.downsample.1", *body, node, "downsample_bn")
    for i in range(4):
        conv(f"backbone.fpn.inner_blocks.{i}.0", "backbone", "fpn", f"inner{i}")
        conv(f"backbone.fpn.layer_blocks.{i}.0", "backbone", "fpn", f"layer{i}")
    for name in ("conv", "cls_logits", "bbox_pred"):
        conv(f"rpn.head.{name}", "rpn_head", name)

    # fc6: JAX flattens the 7x7x256 RoI features HWC, torchvision CHW
    k = jx.take("box_head", "fc6", "kernel").T  # [1024, S*S*C]
    c = 256
    s = int(round((k.shape[1] // c) ** 0.5))
    sd["roi_heads.box_head.fc6.weight"] = _t(
        k.reshape(-1, s, s, c).transpose(0, 3, 1, 2).reshape(k.shape[0], -1))
    sd["roi_heads.box_head.fc6.bias"] = _t(jx.take("box_head", "fc6", "bias"))
    dense("roi_heads.box_head.fc7", "box_head", "fc7")
    dense("roi_heads.box_predictor.cls_score", "box_predictor", "cls_score")
    dense("roi_heads.box_predictor.bbox_pred", "box_predictor", "bbox_pred")
    for i in (1, 2, 3, 4):
        conv(f"roi_heads.mask_head.mask_fcn{i}", "mask_head", f"mask_fcn{i}")
    # flax's conv_transpose correlates: torch [in, out, kh, kw] = flipped HWIO
    kt = jx.take("mask_predictor", "conv5_mask", "kernel")
    sd["roi_heads.mask_predictor.conv5_mask.weight"] = _t(
        kt.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    sd["roi_heads.mask_predictor.conv5_mask.bias"] = _t(
        jx.take("mask_predictor", "conv5_mask", "bias"))
    conv("roi_heads.mask_predictor.mask_fcn_logits", "mask_predictor", "mask_fcn_logits")

    def trunk(prefix, node):
        for i, ti in enumerate((0, 2, 4, 6)):
            conv(f"{prefix}.conv_seq.{ti}", node, "trunk", f"conv{i}")
        dense(f"{prefix}.linear.0", node, "trunk", "linear")
        bn = f"{prefix}.linear.1"
        sd[f"{bn}.weight"] = _t(jx.take(node, "trunk", "bn", "scale"))
        sd[f"{bn}.bias"] = _t(jx.take(node, "trunk", "bn", "bias"))
        sd[f"{bn}.running_mean"] = _t(jx.take(node, "trunk", "bn", "mean", stats=True))
        sd[f"{bn}.running_var"] = _t(jx.take(node, "trunk", "bn", "var", stats=True))
        sd[f"{bn}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
        dense(f"{prefix}.last", node, "last")  # PairScorer kernel [256, 2]

    trunk("roi_heads.match_predictor", "match_predictor")
    if "temporal_aggregator" in variables["params"]:
        pre, node = "roi_heads.temporal_aggregator", "temporal_aggregator"
        trunk(pre, node)
        dense(f"{pre}.attention_scorer", node, "attention_scorer")
        for jname, tname in (("theta", "theta"), ("phi", "phi"), ("g", "g"), ("w_z", "W")):
            sd[f"{pre}.newnlb.{tname}.weight"] = _t(
                jx.take(node, "nlb", jname, "kernel").T[:, :, None])
            sd[f"{pre}.newnlb.{tname}.bias"] = _t(jx.take(node, "nlb", jname, "bias"))
        sd[f"{pre}.newnlb.concat_project.0.weight"] = _t(
            jx.take(node, "nlb", "concat_w").T[:, :, None, None])

    left = jx.left()
    if left:
        raise ValueError(f"JAX leaves not used by the bridge: {left}")
    device = next(model.parameters()).device
    model.load_state_dict({k: v.to(device) for k, v in sd.items()}, strict=True)
    return model
