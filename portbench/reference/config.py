"""Typed configuration of the model.

Frozen copy of ``seam_match_rcnn_tpu_torch/config.py`` (what the benchmark's plain
reference uses of it); it imports nothing of the port.

The reference scatters hyperparameters across a ``params`` dict
(reference models/matchrcnn.py:14-29), argparse defaults in every CLI
(reference train_matchrcnn.py:110-133 etc.) and hardcoded constants
(inferstep, eval chunk sizes, aggregator min-frames).  Here a single set of
dataclasses is the source of truth, consumed by every entry point.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    # One size per FPN level with 3 aspect ratios, matching the reference
    # AnchorGenerator((32, 64, 128, 256, 512), (0.5, 1.0, 2.0))
    # (reference models/matchrcnn.py:15).
    sizes: Sequence[float] = (32.0, 64.0, 128.0, 256.0, 512.0)
    aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0)

    @property
    def num_anchors_per_location(self) -> int:
        return len(self.aspect_ratios)


@dataclasses.dataclass(frozen=True)
class RPNConfig:
    # Reference overrides at reference models/matchrcnn.py:16-19.
    pre_nms_top_n_train: int = 2000
    pre_nms_top_n_test: int = 1000
    post_nms_top_n_train: int = 8000
    post_nms_top_n_test: int = 4000
    nms_thresh: float = 0.7
    score_thresh: float = 0.0
    min_size: float = 1e-3
    fg_iou_thresh: float = 0.7
    bg_iou_thresh: float = 0.3
    batch_size_per_image: int = 256
    positive_fraction: float = 0.5

    def pre_nms_top_n(self, training: bool) -> int:
        return self.pre_nms_top_n_train if training else self.pre_nms_top_n_test

    def post_nms_top_n(self, training: bool) -> int:
        return self.post_nms_top_n_train if training else self.post_nms_top_n_test


@dataclasses.dataclass(frozen=True)
class RoIHeadsConfig:
    # torchvision MaskRCNN defaults, inherited unchanged by the reference's
    # NewRoIHeads (reference models/matchrcnn.py:58-64).
    fg_iou_thresh: float = 0.5
    bg_iou_thresh: float = 0.5
    batch_size_per_image: int = 512
    positive_fraction: float = 0.25
    bbox_reg_weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    detections_per_img: int = 100
    # RoIAlign geometry (reference models/matchrcnn.py:21-28).
    box_roi_output: int = 7
    mask_roi_output: int = 14
    sampling_ratio: int = 2
    # FPN level range used by the RoI pools (featmaps '0'-'3' == P2..P5).
    canonical_scale: float = 224.0
    canonical_level: int = 4
    # "xla" (gather-based, exact), "pallas" (patch-DMA kernel, equal
    # semantics for typical boxes), "pallas_int8" (EXPERIMENTAL: patch DMA
    # over a per-channel int8-quantized pyramid — measured retrieval deltas
    # at/above the gate's noise floor and slower than bf16 on current TPUs;
    # see tools/results/int8_gate_r4.json + PERF.md round 4 before using),
    # or "pallas_resident" (tile-resident kernel: shared VMEM tiles instead
    # of per-roi HBM DMA, ~9x fewer HBM bytes, same window semantics as
    # "pallas", differentiable via its exact-adjoint custom_vjp — the
    # serving AND phase-1 training default).  See PERF.md.
    roi_align_backend: str = "xla"
    # RoIAlign BACKWARD implementation for the trainable Pallas backends:
    # "pallas" (default — the tile-resident adjoint kernel,
    # ops/pallas_roi_adjoint.py: VMEM-accumulated window gradients, one
    # HBM write per ownership tile instead of ~1.6M serialized scatter
    # rows; measured full production step 168 vs 249 ms — +48% img/s,
    # PERF.md round 5) or "xla" (the scatter-add adjoint,
    # ops/roi_align.multilevel_roi_align_adjoint — the escape hatch).
    # Numerics: for f32 features the kernel's summands bit-match the
    # exact adjoint (compiled parity 3e-5); for bf16 features it uses
    # single bf16 MXU passes like the FORWARD kernel itself (bounded
    # drift at bf16 rounding).  Footprints beyond its 2x2 ownership
    # bands (aspect ~5+ outliers) drop tail samples — samples the
    # windowed forward never pooled.  Ignored by the "xla" forward
    # backend (jax transposes the exact forward itself).
    roi_adjoint_backend: str = "pallas"
    # Exact-fixup escape hatch for the pallas backends: re-run up to this
    # many patch-clamped rois per image through the exact XLA kernel and
    # scatter the results back (ops/pallas_roi_align.apply_exact_fixup).
    # Measured (tools/measure_roi_clamp.py + the descriptor-drift regression
    # test, PERF.md): clamping needs aspect ≥ 2.0 at the very top of a level
    # band (≥ 2.7 mid-band), hits 1–3% of an anchor-shaped roi distribution,
    # and the resulting match-descriptor drift is ~2e-4 on O(1) descriptors
    # — negligible for retrieval, so the serving default keeps the budget at
    # 0; set >0 for bit-exactness on clamped rois.
    roi_align_fixup_budget: int = 0


@dataclasses.dataclass(frozen=True)
class MatchHeadConfig:
    d_model: int = 256
    trunk_channels: int = 1024
    # Aggregator needs >= n_frames weak candidates per product
    # (reference models/match_head.py:304).
    n_frames: int = 3
    match_threshold: float = -10.0
    # Temporal-aggregation backend: "xla", or "pallas" for the fused
    # NLB + attention-pooling kernel (ops/pallas_kernels.nlb_aggregate;
    # interprets automatically off-TPU).
    nlb_backend: str = "xla"
    # Compute dtype of the match/aggregator conv trunks (the reference
    # runs them f32; descriptors, BN statistics and the pairwise scorer
    # stay f32 regardless).  "bfloat16" halves the trunk conv time on the
    # serving tail — opt-in until its retrieval deltas are gated like the
    # other approximate profiles (PERF.md round 4).
    trunk_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    # GeneralizedRCNNTransform semantics (torchvision): resize so
    # min side -> 800 unless the max side would exceed 1333; ImageNet
    # normalization; pad to a static canvas (stride-32 aligned).
    min_size: int = 800
    max_size: int = 1333
    image_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    image_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    size_divisible: int = 32

    @property
    def landscape_canvas(self) -> Tuple[int, int]:
        # (H, W) covering every landscape resize: H <= 800, W <= 1333 -> 1344.
        return (800, 1344)

    @property
    def portrait_canvas(self) -> Tuple[int, int]:
        return (1344, 800)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # 13 garment categories + background (reference train_matchrcnn.py:62).
    num_classes: int = 14
    anchors: AnchorConfig = dataclasses.field(default_factory=AnchorConfig)
    rpn: RPNConfig = dataclasses.field(default_factory=RPNConfig)
    roi_heads: RoIHeadsConfig = dataclasses.field(default_factory=RoIHeadsConfig)
    match: MatchHeadConfig = dataclasses.field(default_factory=MatchHeadConfig)
    transform: TransformConfig = dataclasses.field(default_factory=TransformConfig)
    # Compute dtype for conv/matmul heavy paths; params stay float32.
    compute_dtype: str = "bfloat16"
    # Rematerialize backbone blocks in the backward pass (memory for FLOPs).
    remat_backbone: bool = False
    # Backbone stem implementation: "xla" (conv1 + FrozenBN + relu +
    # maxpool as separate ops — the 378 MB stride-2 conv activation
    # round-trips HBM) or "pallas" (ops/pallas_stem.fused_stem: the whole
    # stem tail in one kernel, activation stays in VMEM; measured
    # 9.1 vs 16.5 ms/batch-11 at the probe level, PERF.md round 5).  The
    # fused kernel has no vjp — valid wherever no gradient reaches the
    # stem: inference, and training with freeze_backbone_stages (whose
    # stop_gradient sits above the stem).  Same parameter tree either
    # way; checkpoints interchange freely.
    stem_backend: str = "xla"
    # Stop gradients at the layer1/layer2 boundary of the backbone.  The
    # reference's torchvision backbone freezes conv1+bn1+layer1
    # (trainable_layers=3, reference models/matchrcnn.py:486) — the
    # optimizer-side ``backbone_frozen_mask`` already zeroes their updates,
    # but gradients THROUGH the stem are still computed wherever the grad
    # and the masked update live in different jits (Phase1Trainer's linked
    # step, the accumulation triple).  stop_gradient makes the dead stem/
    # layer1 backward explicit so XLA drops it in every step variant.
    # Training-semantics neutral: forward values identical, trainable-param
    # gradients identical (tests/test_backbone_freeze.py pins both).
    freeze_backbone_stages: bool = False
