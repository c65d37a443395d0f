"""SEAM (video) Match R-CNN inference: the full detector plus descriptors.

Port of ``seam_match_rcnn_tpu/models/matchrcnn.py`` for the serving path:
backbone -> RPN -> proposal NMS -> box branch -> class NMS -> 14x14 RoIAlign
on the detections -> match descriptors, plus the temporal aggregator's
descriptors and sequence aggregation.  Module names follow the reference's
torchvision state dict (``backbone.body.*``, ``rpn.head.*``,
``roi_heads.box_head.*``, ``roi_heads.match_predictor.*``, ...).

The TPU plumbing of the JAX model is gone: the tile-sorted box path and its
unpermute (kernel K2 returns rois in natural order), the int8 pyramid and
the exact fixup.  Public outputs keep the JAX shapes and padding.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn

from seam_match_rcnn_tpu.config import ModelConfig
from seam_match_rcnn_tpu.models.anchors import grid_anchors

from ..ops.cuda_roi_align import roi_align
from ..ops.roi_align import multilevel_roi_align
from .detection import postprocess_detections
from .heads import FastRCNNPredictor, MaskHead, MaskPredictor, RPNHead, TwoMLPHead
from .match_head import MatchPredictor, TemporalAggregator
from .resnet import BackboneWithFPN
from .rpn import flatten_rpn_outputs, select_proposals
from .transform import normalize


class MatchRCNN(nn.Module):
    """video=False: Match R-CNN (fallback detection score 1.0).  video=True:
    SEAM VideoMatchRCNN with the temporal aggregator (fallback 0.1).
    Inference only; the module is put in eval mode."""

    def __init__(self, cfg: ModelConfig, video: bool = False):
        super().__init__()
        rh = cfg.roi_heads
        if rh.roi_align_backend in ("pallas", "pallas_int8"):
            raise NotImplementedError(
                f"roi_align_backend {rh.roi_align_backend!r} is not ported yet (ROADMAP M13)")
        if rh.roi_align_backend not in ("xla", "pallas_resident"):
            raise ValueError(f"unknown roi_align_backend {rh.roi_align_backend!r}")
        # f32 paths (match/aggregator trunks, NLB, pairwise scorer) must not
        # run in TF32, cuDNN's default for convolutions
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.video = video
        dt = getattr(torch, cfg.compute_dtype)
        tdt = getattr(torch, cfg.match.trunk_dtype)
        self.backbone = BackboneWithFPN(dt, cfg.stem_backend)
        self.rpn = nn.ModuleDict({"head": RPNHead(cfg.anchors.num_anchors_per_location, dt)})
        heads = {
            "box_head": TwoMLPHead(256, rh.box_roi_output, dt),
            "box_predictor": FastRCNNPredictor(1024, cfg.num_classes, dt),
            "mask_head": MaskHead(dt),
            "mask_predictor": MaskPredictor(cfg.num_classes),
            "match_predictor": MatchPredictor(tdt),
        }
        if video:
            heads["temporal_aggregator"] = TemporalAggregator(tdt, cfg.match.nlb_backend)
        self.roi_heads = nn.ModuleDict(heads)
        self._anchors: Dict[tuple, Tuple[torch.Tensor, ...]] = {}
        self.eval()

    # ---- building blocks ----------------------------------------------

    def features(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """images [B, 3, H, W] in [0, 1] -> (P2, ..., P6)."""
        x = normalize(images.to(torch.float32), self.cfg.transform)
        return self.backbone(x.to(getattr(torch, self.cfg.compute_dtype)))

    def _grid_anchors(self, feats) -> Tuple[torch.Tensor, ...]:
        canvas = (feats[0].shape[2] * 4, feats[0].shape[3] * 4)
        shapes = tuple((f.shape[2], f.shape[3]) for f in feats)
        key = (canvas, shapes, feats[0].device)
        if key not in self._anchors:
            a = self.cfg.anchors
            self._anchors[key] = tuple(
                torch.from_numpy(x).to(feats[0].device)
                for x in grid_anchors(canvas, shapes, tuple(a.sizes), tuple(a.aspect_ratios)))
        return self._anchors[key]

    def proposals(self, feats, image_sizes: torch.Tensor):
        """-> proposals [B, R, 4], scores [B, R], valid [B, R]."""
        obj, regs = self.rpn["head"](feats)
        logits, deltas = flatten_rpn_outputs(obj, regs)
        return select_proposals([x.to(torch.float32) for x in logits],
                                [x.to(torch.float32) for x in deltas],
                                self._grid_anchors(feats), image_sizes, self.cfg.rpn)

    def _roi_align(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                   output_size: int) -> torch.Tensor:
        """[B, R, 4] rois -> [B*R, C, out, out] in the features' dtype."""
        rh = self.cfg.roi_heads
        if rh.roi_align_backend == "pallas_resident":
            levels = [f.contiguous(memory_format=torch.channels_last) for f in feats[:4]]
            return roi_align(levels, rois.contiguous(), output_size, rh.sampling_ratio)
        return multilevel_roi_align(feats[:4], rois, output_size, rh.sampling_ratio)

    def box_branch(self, feats, rois: torch.Tensor):
        """-> class_logits [B, R, C] f32, deltas [B, R, 4C] f32."""
        b, r = rois.shape[:2]
        x = self.roi_heads["box_head"](self._roi_align(feats, rois, self.cfg.roi_heads.box_roi_output))
        logits, deltas = self.roi_heads["box_predictor"](x)
        return (logits.reshape(b, r, -1).to(torch.float32),
                deltas.reshape(b, r, -1).to(torch.float32))

    def match_descriptors(self, roi_feats: torch.Tensor) -> torch.Tensor:
        return self.roi_heads["match_predictor"].descriptors(roi_feats.to(torch.float32))

    @torch.no_grad()
    def aggregator_descriptors(self, roi_feats: torch.Tensor) -> torch.Tensor:
        """[N, 256, 14, 14] RoI features -> [N, 256] per-frame descriptors of
        the aggregator's own trunk."""
        return self.roi_heads["temporal_aggregator"].descriptors(roi_feats.to(torch.float32))

    @torch.no_grad()
    def aggregate_sequences(self, seqs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """seqs [S, T, 256], mask [S, T] -> [S, 256] video descriptors."""
        return self.roi_heads["temporal_aggregator"].aggregate(seqs, mask)

    # ---- serving forward ----------------------------------------------

    @torch.no_grad()
    def inference(self, images: torch.Tensor, image_sizes: torch.Tensor,
                  with_masks: bool = False, with_match: bool = True,
                  with_roi_features: bool = True) -> Dict[str, torch.Tensor]:
        """Eval-mode forward of one canvas batch.

        images [B, 3, H, W] in [0, 1]; image_sizes [B, 2] valid (h, w).
        Returns boxes [B, D, 4] (canvas coords), scores [B, D], labels
        [B, D], valid [B, D], roi_features [B, D, 256, 14, 14] f32 and
        match_features [B, D, 256], with D = detections_per_img."""
        if with_masks:
            raise NotImplementedError("mask branch: ROADMAP M8")
        image_sizes = image_sizes.to(images.device)
        feats = self.features(images)
        props, _, pvalid = self.proposals(feats, image_sizes)
        logits, deltas = self.box_branch(feats, props)
        det = postprocess_detections(logits, deltas, props, pvalid, image_sizes,
                                     self.cfg.roi_heads,
                                     fallback_score=0.1 if self.video else 1.0)
        out = {"boxes": det.boxes, "scores": det.scores, "labels": det.labels,
               "valid": det.valid}
        b, d = det.boxes.shape[:2]
        o = self.cfg.roi_heads.mask_roi_output
        roi14 = self._roi_align(feats, det.boxes, o).to(torch.float32)
        if with_roi_features:
            out["roi_features"] = roi14.reshape(b, d, -1, o, o)
        if with_match:
            out["match_features"] = self.match_descriptors(roi14).reshape(b, d, -1)
        return out


def _lecun_std(w: torch.Tensor) -> float:
    return (1.0 / w[0].numel()) ** 0.5


def init_parameters(model: MatchRCNN, generator: torch.Generator) -> MatchRCNN:
    """Fill every parameter and buffer from ``generator`` (CPU), with the JAX
    package's initializers: lecun-normal convs and dense layers with zero
    biases, N(0, 0.01) RPN convs, He fan-out mask convs, identity BatchNorm
    statistics and a zero-initialized NLB output projection (W_z), so the
    block starts as an identity residual."""
    done = set()

    def fill(t, values):
        with torch.no_grad():
            t.copy_(values)
        done.add(id(t))

    def normal(t, std):
        fill(t, torch.randn(t.shape, generator=generator) * std)

    for name, mod in model.named_modules():
        if hasattr(mod, "running_var") and hasattr(mod, "running_mean"):
            eps = mod.eps
            fill(mod.weight, torch.ones_like(mod.weight))
            fill(mod.bias, torch.zeros_like(mod.bias))
            fill(mod.running_mean, torch.zeros_like(mod.running_mean))
            # FrozenBN: scale = weight / sqrt(var + eps) == 1, as JAX's init
            var = 1.0 - eps if not isinstance(mod, nn.BatchNorm1d) else 1.0
            fill(mod.running_var, torch.full_like(mod.running_var, var))
            if getattr(mod, "num_batches_tracked", None) is not None:
                fill(mod.num_batches_tracked, torch.zeros_like(mod.num_batches_tracked))
        elif isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = mod.weight
            if name.startswith("rpn."):
                normal(w, 0.01)
            elif name.endswith("newnlb.W"):
                fill(w, torch.zeros_like(w))
            elif ".mask_head." in name or ".mask_predictor." in name:
                fan_out = w.shape[0] * w[0, 0].numel() if not isinstance(
                    mod, nn.ConvTranspose2d) else w.shape[1] * w[0, 0].numel()
                normal(w, (2.0 / fan_out) ** 0.5)
            else:
                normal(w, _lecun_std(w))
            if mod.bias is not None:
                fill(mod.bias, torch.zeros_like(mod.bias))
    missing = [n for n, t in list(model.named_parameters()) + list(model.named_buffers())
               if id(t) not in done]
    if missing:
        raise RuntimeError(f"init_parameters left tensors unset: {missing[:5]}")
    return model


def init_model(cfg: ModelConfig, video: bool = False, seed: int = 0,
               device="cpu") -> MatchRCNN:
    """A MatchRCNN with random weights made from ``seed`` on a CPU
    generator (the same weights on every device), moved to ``device``."""
    with torch.device("meta"):
        model = MatchRCNN(cfg, video)
    model = model.to_empty(device="cpu")
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)
