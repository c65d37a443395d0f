"""Typed configuration for the whole framework.

The reference scatters hyperparameters across a ``params`` dict
(reference models/matchrcnn.py:14-29), argparse defaults in every CLI
(reference train_matchrcnn.py:110-133 etc.) and hardcoded constants
(inferstep, eval chunk sizes, aggregator min-frames).  Here a single set of
dataclasses is the source of truth, consumed by every entry point.

The port's own copy of ``seam_match_rcnn_tpu/config.py``: the port imports nothing
of the JAX package.  tests/test_torch_port_copies.py holds the two equal.
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


def serving_model_config(**overrides) -> "ModelConfig":
    """Inference profile: parity hyperparameters with the tile-resident
    Pallas RoIAlign backend — same-session bench A/B on the dev chip:
    68.2 fps vs 65.7 patch-DMA vs ~15 exact-gather (PERF.md), and ~9×
    fewer RoIAlign HBM bytes (the lever that grows on production v5e
    where bandwidth binds).  Window semantics identical to the patch-DMA
    backend (40×48 footprint contract; extreme-aspect outliers clamp at
    the patch edge; compiled e2e parity in tools/drive_resident_e2e.py).
    Differentiable: the resident forward carries the same exact-adjoint
    custom_vjp as the patch-DMA backend
    (ops/pallas_roi_align_resident.pallas_roi_align_resident_trainable),
    so phase-1 can train through this profile too (cli/train_matchrcnn
    --roi_backend).  Use ModelConfig() for the exact path."""
    kw = dict(
        roi_heads=RoIHeadsConfig(roi_align_backend="pallas_resident"),
        match=MatchHeadConfig(nlb_backend="pallas"),
        # Fused conv1+BN+relu+maxpool stem: same-session serving A/B
        # 80.10 vs 79.52 fps once the kernel stores NHWC directly
        # (PERF.md round 5; compiled parity tests/test_pallas_stem.py).
        # Inference-only kernel — fine here; ModelConfig() keeps "xla".
        stem_backend="pallas",
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def fast_eval_model_config(**overrides) -> "ModelConfig":
    """Reduced-work variant of serving_model_config: torchvision-default
    1000 post-NMS proposals instead of the reference's 4000
    (matchrcnn.py:18) — 4× less RoIAlign work in the box branch; accuracy
    impact to be validated against real data (PERF.md lever 1)."""
    kw = dict(rpn=RPNConfig(post_nms_top_n_test=1000))
    kw.update(overrides)
    return serving_model_config(**kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # Phase-1 (reference train_matchrcnn.py:69-97).
    lr: float = 0.02
    momentum: float = 0.9
    weight_decay: float = 0.0
    milestones: Sequence[int] = (6, 9)
    gamma: float = 0.1
    epochs: int = 12
    warmup_iters: int = 1000
    warmup_factor: float = 1.0 / 1000
    # Reference CLI default (reference train_matchrcnn.py:115).
    batch_size: int = 8
    # Global-norm gradient clipping; 0 = off (reference parity — the
    # reference never clips, but it also never trains from scratch:
    # without an ImageNet backbone the mask branch diverges at full
    # geometry (measured in tools/validate_fast_profile.py).  Set e.g. 5.0
    # for from-scratch runs.
    clip_grad_norm: float = 0.0
    save_epochs: int = 2
    # Mid-epoch checkpoint every N optimizer steps into the overwriting
    # "mid" slot (0 = off).  Beyond-reference robustness for preemptible
    # TPU jobs: --start_ckpt on a mid checkpoint resumes inside the epoch
    # (same batch order — the pair sampler is epoch-seeded).
    save_steps: int = 0
    print_freq: int = 100
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class SEAMTrainConfig:
    # Phase-2 (reference train_movingfashion.py:97-101,158-189).
    lr: float = 0.04
    momentum: float = 0.9
    weight_decay: float = 5e-4
    milestones: Sequence[int] = (15, 25)
    gamma: float = 0.1
    epochs: int = 31
    warmup_iters: int = 1000
    warmup_factor: float = 1.0 / 1000
    n_shops: int = 16
    frames_per_shop: int = 10
    # The reference CLIs *pass* score_thresh=0.1 into both phase-2 epoch
    # loops (reference train_movingfashion.py:119,
    # train_multiDF2.py:113) — the engine-signature default of 0.7
    # (stuffs/engine.py:77) is never used in practice.
    score_thresh: float = 0.1
    infer_chunk: int = 15
    eval_freq: int = 4
    save_epochs: int = 2
    # Mid-epoch checkpoint every N product batches into the overwriting
    # "mid" slot (0 = off); see TrainConfig.save_steps.
    save_steps: int = 0
    print_freq: int = 20
    seed: int = 0

    @property
    def batch_size(self) -> int:
        # (1 shop + T frames) per product (reference train_movingfashion.py:188).
        return (1 + self.frames_per_shop) * self.n_shops


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    # (reference evaluate_movingfashion.py:15-16,448-468).
    score_threshold: float = 0.0
    k_thresholds: Sequence[int] = (1, 5, 10, 20)
    frames_per_product: int = 10
    tracking_threshold: float = 0.3
    first_n_withvideo: int | None = 100
    infer_chunk: int = 11
    # Inference-runner ingest path: "host" (cv2 resize before upload,
    # reference parity) or "device" (raw-frame upload + TPU-fused bilinear
    # resize/canvas placement — eval/runner.py, PERF.md lever 6).
    ingest: str = "host"
    # Gallery scoring dtype: "f32" (device matmul expansion, algebraically
    # identical) or "fp16" (the reference's numpy-fp16 chain,
    # evaluate_movingfashion.py:94-121 — bit-faithful rank parity for the
    # real-data gate; see eval/gallery.score_matrix_fp16).
    gallery_dtype: str = "f32"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout.  data = batch sharding (DP); model = sharding of
    the retrieval gallery / pairwise score matrix at eval scale."""

    data: int = -1  # -1: all devices
    model: int = 1
