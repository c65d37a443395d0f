"""Match R-CNN and SEAM (video) Match R-CNN: serving and phase-1 training.

Port of ``seam_match_rcnn_tpu/models/matchrcnn.py``.  Serving: backbone ->
RPN -> proposal NMS -> box branch -> class NMS -> 14x14 RoIAlign on the
detections -> match descriptors, plus the temporal aggregator's descriptors
and sequence aggregation.  Phase-1 training (``train_export`` per canvas
bucket, ``training_losses`` per batch): RPN loss over all anchors, RoI sampling with the GTs
appended, box branch (K2 at 7x7), mask branch and match-slot RoIs (K2 at
14x14), the supervised match loss; the RoIAlign backward is K5.  Module
names follow the reference's torchvision state dict (``backbone.body.*``,
``rpn.head.*``, ``roi_heads.box_head.*``, ``roi_heads.match_predictor.*``,
...).

RoIAlign backends (``RoIHeadsConfig.roi_align_backend``): "xla" (the plain
exact version), "pallas_resident" (kernel K2, exact), "pallas" (kernel K6,
the TPU kernel's 40x48-cell window) and "pallas_int8" (kernel K7 over an
int8 pyramid quantized once per forward); every one but "pallas_int8" is
trainable, and the window backends take the exact fixup when
``roi_align_fixup_budget`` > 0.  The kernels' backward is
``RoIHeadsConfig.roi_adjoint_backend``: "pallas" (kernel K5) or "xla" (the
scatter-add adjoint); the "xla" forward ignores it, since autograd
transposes the plain forward itself, as in the JAX package.
``ModelConfig.remat_backbone`` recomputes each backbone bottleneck in the
backward (``models/resnet.py``).  ``ModelConfig.backbone = "vitdet_l"`` puts
ViTDet-L and its simple feature pyramid (``models/vit.py``, inference only)
in the ResNet-50-FPN's place; the heads and everything after P2-P6 stay.

Two measurement and evaluation surfaces of the JAX model are here too:
``profile_losses`` (the loss of a cumulative prefix of the phase-1
pipeline, ``tools/profile_torch_train.py``'s stages) and ``inference(gt=)``
(ground-truth boxes prepended to the detections with score 1, the video
model's evaluation path).  The tile-sorted box path
of the JAX model and its unpermute are gone (every kernel returns rois in
natural order).  Public outputs keep the JAX shapes and padding.  Random
draws of the samplers come from a ``torch.Generator`` or are handed in
(``draws``), since ``jax.random`` and torch give different numbers.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..config import ModelConfig
from ..losses import detection as det_losses
from ..losses.match import match_loss_supervised
from ..ops.boxes import box_iou, encode_boxes
from ..ops.cuda_roi_align import (ADJOINT_BACKENDS, roi_align, roi_align_patch,
                                  roi_align_patch_int8)
from ..ops.roi_align import multilevel_roi_align
from ..ops.roi_align_patch import apply_exact_fixup, quantize_features_int8
from ..ops.targets import assign_and_sample
from .anchors import grid_anchors
from .detection import postprocess_detections, prepend_gt
from .heads import FastRCNNPredictor, MaskHead, MaskPredictor, RPNHead, TwoMLPHead
from .match_head import MatchPredictor, TemporalAggregator
from .resnet import BackboneWithFPN
from .rpn import flatten_rpn_outputs, select_proposals, topk_stable
from .transform import normalize
from .vit import ChannelLayerNorm, ViTDetBackbone

# the cumulative prefixes of the phase-1 pipeline that ``train_export`` can
# stop after; ``profile_losses`` also takes "match" and "full" (everything)
PROFILE_STAGES = ("backbone", "rpn", "sample", "boxbranch", "mask")
BACKBONES = ("resnet50_fpn", "vitdet_l")  # ModelConfig.backbone


def _select_match_slots(pos_props: torch.Tensor, pos_valid: torch.Tensor,
                        gt_boxes: torch.Tensor, gt_valid: torch.Tensor, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``filter_proposals``, batched: keep, per GT, the top
    (k // n_gt) positive proposals by IoU against it (a proposal may serve
    several GTs), compacted into k slots in GT-major order.  Ranking is by
    correct IoU (the JAX package's documented divergence from the
    reference's xywh IoU).

    pos_props [B, P, 4], pos_valid [B, P], gt_boxes [B, G, 4], gt_valid [B,
    G] -> (slot_idx [B, k] into pos_props, slot_valid [B, k])."""
    b, p = pos_props.shape[:2]
    per_gt = k // gt_valid.sum(dim=-1).clamp(min=1)  # 0 when n_gt > k, as the reference
    iou = box_iou(pos_props, gt_boxes)
    iou = torch.where(pos_valid[:, :, None] & gt_valid[:, None, :], iou,
                      torch.full_like(iou, -1.0))
    ranks = torch.argsort(torch.argsort(-iou, dim=1, stable=True), dim=1, stable=True)
    sel = (ranks < per_gt[:, None, None]) & (iou > -1.0)
    flat = sel.transpose(1, 2).reshape(b, -1)  # GT-major, as the per-GT loop
    # the JAX package's f32 keys: 1e9 - i ties in runs of 64, which the
    # stable top-k breaks by index, as lax.top_k
    ar = torch.arange(flat.shape[1], dtype=torch.float32, device=flat.device)
    _, top = topk_stable(torch.where(flat, 1e9 - ar, -ar), k)
    slot_valid = torch.take_along_dim(flat, top, dim=1)
    return torch.where(slot_valid, top % p, torch.zeros_like(top)), slot_valid


class MatchRCNN(nn.Module):
    """video=False: Match R-CNN (fallback detection score 1.0).  video=True:
    SEAM VideoMatchRCNN with the temporal aggregator (fallback 0.1).

    No layer reads the module's train/eval mode: BatchNorm is frozen in the
    backbone, and the match trunk's BatchNorm uses batch statistics only
    where the caller asks (``match_loss_from_rois``), as the JAX
    ``train=`` flag; ``inference`` always uses the running statistics."""

    def __init__(self, cfg: ModelConfig, video: bool = False):
        super().__init__()
        rh = cfg.roi_heads
        if rh.roi_align_backend not in ("xla", "pallas", "pallas_int8", "pallas_resident"):
            raise ValueError(
                f"unknown roi_align_backend {rh.roi_align_backend!r}; expected 'xla', "
                "'pallas', 'pallas_int8' or 'pallas_resident'")
        if rh.roi_adjoint_backend not in ADJOINT_BACKENDS:
            raise ValueError(
                f"unknown roi_adjoint_backend {rh.roi_adjoint_backend!r}; expected 'pallas' "
                "(kernel K5) or 'xla' (the scatter-add adjoint)")
        if not isinstance(cfg.remat_backbone, bool):
            raise ValueError(f"remat_backbone must be True or False, not {cfg.remat_backbone!r}")
        # a config without the field (the JAX package's, which the parity
        # tests hand in) is a ResNet-50-FPN's
        backbone = getattr(cfg, "backbone", "resnet50_fpn")
        if backbone not in BACKBONES:
            raise ValueError(f"unknown backbone {backbone!r}; expected one of {BACKBONES}")
        if backbone == "vitdet_l" and (cfg.stem_backend != "xla" or cfg.remat_backbone):
            raise ValueError("stem_backend and remat_backbone are the ResNet's: with "
                             "backbone 'vitdet_l' keep them at 'xla' and False")
        # f32 paths (match/aggregator trunks, NLB, pairwise scorer) must not
        # run in TF32, cuDNN's default for convolutions
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.video = video
        dt = getattr(torch, cfg.compute_dtype)
        tdt = getattr(torch, cfg.match.trunk_dtype)
        if backbone == "vitdet_l":
            self.backbone = ViTDetBackbone(cfg.vit, dt)
        else:
            self.backbone = BackboneWithFPN(dt, cfg.stem_backend, remat=cfg.remat_backbone)
        self.rpn = nn.ModuleDict({"head": RPNHead(cfg.anchors.num_anchors_per_location, dt)})
        heads = {
            "box_head": TwoMLPHead(256, rh.box_roi_output, dt),
            "box_predictor": FastRCNNPredictor(1024, cfg.num_classes, dt),
            "mask_head": MaskHead(dt),
            "mask_predictor": MaskPredictor(cfg.num_classes, dt),
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
        # f32 into the backbone: the fused stem rounds it to bf16 as it loads
        # it, and the XLA stem's conv1 casts it to the compute dtype
        return self.backbone(normalize(images.to(torch.float32), self.cfg.transform))

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

    def roi_levels(self, feats: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
        """P2..P5 as the RoIAlign backend takes them: channels_last copies for
        the kernels K2 and K6 and for the exact fixup (made once per forward,
        shared by every RoIAlign call)."""
        if self.cfg.roi_heads.roi_align_backend == "xla":
            return feats[:4]
        return [f.contiguous(memory_format=torch.channels_last) for f in feats[:4]]

    def _quantize_pyramid(self, levels: Sequence[torch.Tensor]):
        """The int8 pyramid and its scales [4, C] for the "pallas_int8"
        backend (else None), made once per forward and shared by the box and
        match RoIAlign calls: the scales span the whole canvas batch, as in
        the JAX forward."""
        if self.cfg.roi_heads.roi_align_backend != "pallas_int8":
            return None
        return quantize_features_int8(levels[:4])

    def _roi_align(self, levels: Sequence[torch.Tensor], rois: torch.Tensor,
                   output_size: int, prequant=None) -> torch.Tensor:
        """levels from ``roi_levels`` (P2..P5; a P6 after them is ignored),
        ``prequant`` from ``_quantize_pyramid`` (required by "pallas_int8");
        [B, R, 4] rois -> [B*R, C, out, out] in the features' dtype.
        Differentiable in the features (backward ``roi_adjoint_backend``), but
        for "pallas_int8"."""
        rh = self.cfg.roi_heads
        backend, ratio, adjoint = rh.roi_align_backend, rh.sampling_ratio, rh.roi_adjoint_backend
        if backend == "xla":
            return multilevel_roi_align(levels[:4], rois, output_size, ratio)
        rois = rois.contiguous()
        if backend == "pallas_resident":  # exact: the fixup would change nothing
            return roi_align(levels[:4], rois, output_size, ratio, adjoint=adjoint)
        if backend == "pallas":
            out = roi_align_patch(levels[:4], rois, output_size, ratio, adjoint=adjoint)
        else:
            if prequant is None:
                raise ValueError('"pallas_int8" needs the int8 pyramid of the forward: pass '
                                 "prequant=self._quantize_pyramid(levels)")
            q, scales = prequant
            out = roi_align_patch_int8(q, scales, rois, output_size, levels[0].dtype, ratio)
        if rh.roi_align_fixup_budget > 0:
            out = apply_exact_fixup(levels[:4], rois, out, output_size, ratio,
                                    rh.roi_align_fixup_budget)
        return out

    def box_branch(self, levels, rois: torch.Tensor, prequant=None):
        """-> class_logits [B, R, C] f32, deltas [B, R, 4C] f32."""
        b, r = rois.shape[:2]
        x = self.roi_heads["box_head"](
            self._roi_align(levels, rois, self.cfg.roi_heads.box_roi_output, prequant))
        logits, deltas = self.roi_heads["box_predictor"](x)
        return (logits.reshape(b, r, -1).to(torch.float32),
                deltas.reshape(b, r, -1).to(torch.float32))

    def mask_branch(self, roi_feats: torch.Tensor) -> torch.Tensor:
        """[N, 256, 14, 14] -> mask logits [N, num_classes, 28, 28] f32."""
        x = self.roi_heads["mask_head"](roi_feats)
        return self.roi_heads["mask_predictor"](x).to(torch.float32)

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
                  with_roi_features: bool = True,
                  gt: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Eval-mode forward of one canvas batch.

        images [B, 3, H, W] in [0, 1]; image_sizes [B, 2] valid (h, w).
        Returns boxes [B, D, 4] (canvas coords), scores [B, D], labels
        [B, D], valid [B, D], roi_features [B, D, 256, 14, 14] f32, masks
        [B, D, 28, 28] f32 (each row's own label's probability, box space)
        and match_features [B, D, 256], with D = detections_per_img.

        ``gt`` (the video model's evaluation path, video_matchrcnn.py:255-262
        of the reference): boxes [B, G, 4] in canvas coords, labels [B, G],
        valid [B, G], prepended to the detections with score 1 where valid
        (``detection.prepend_gt``), so every output has G + D rows and the
        GT rows feed the 14x14 RoIAlign, masks and descriptors too."""
        image_sizes = image_sizes.to(images.device)
        feats = self.features(images)
        levels = self.roi_levels(feats)
        pq = self._quantize_pyramid(levels)
        props, _, pvalid = self.proposals(feats, image_sizes)
        logits, deltas = self.box_branch(levels, props, pq)
        det = postprocess_detections(logits, deltas, props, pvalid, image_sizes,
                                     self.cfg.roi_heads,
                                     fallback_score=0.1 if self.video else 1.0)
        if gt is not None:
            det = prepend_gt(det, *(gt[k].to(images.device) for k in ("boxes", "labels",
                                                                      "valid")))
        out = {"boxes": det.boxes, "scores": det.scores, "labels": det.labels,
               "valid": det.valid}
        b, d = det.boxes.shape[:2]
        o = self.cfg.roi_heads.mask_roi_output
        roi14 = self._roi_align(levels, det.boxes, o, pq).to(torch.float32)
        if with_roi_features:
            out["roi_features"] = roi14.reshape(b, d, -1, o, o)
        if with_masks:
            # the mask branch on the match trunk's 14x14 RoI features; padded
            # rows (label -1) read class 0, as the JAX package
            probs = torch.sigmoid(self.mask_branch(roi14))
            lbl = det.labels.reshape(b * d).clamp(min=0).to(torch.int64)
            m = probs.shape[-1]
            out["masks"] = probs.gather(1, lbl[:, None, None, None].expand(-1, 1, m, m)
                                        ).reshape(b, d, m, m)
        if with_match:
            out["match_features"] = self.match_descriptors(roi14).reshape(b, d, -1)
        return out

    # ---- phase-1 training ------------------------------------------------

    def train_export(self, images: torch.Tensor, image_sizes: torch.Tensor,
                     gt: Dict[str, torch.Tensor], draws: Optional[Dict[str, torch.Tensor]] = None,
                     generator: Optional[torch.Generator] = None, num_match_slots: int = 8,
                     num_mask_slots: int = 128, profile_stage: Optional[str] = None):
        """One canvas bucket's share of a phase-1 step: detector losses as
        unnormalized parts (their normalizers span the whole batch, see
        ``det_losses_from_parts``), the match-slot RoIs and their metadata,
        with the graph kept for the step's single backward.

        images [B, 3, H, W] in [0, 1]; image_sizes [B, 2]; gt: boxes [B, G,
        4], labels, valid, pair_ids, styles [B, G], source [B] (0 street, 1
        shop), mask_crops [B, G, S, S].  ``draws``: "rpn" [B, N_anchors] and
        "roi" [B, post_nms_top_n_train + G] uniforms for the two samplers;
        drawn from ``generator`` when None.  Returns (parts, match RoIs [B*k,
        256, 14, 14] f32, meta: pair_ids, styles, src, valid [B*k]).

        ``profile_stage`` (the JAX ``_train_core``'s measurement hook, for
        ``profile_losses``): return (parts, None, None) after the named
        prefix of the pipeline (``PROFILE_STAGES``): "backbone" (the
        features), "rpn" (+ RPN head, proposals, RPN loss), "sample" (+ the
        RoI assignment and sampling), "boxbranch" (+ 7x7 RoIAlign, box head
        and loss), "mask" (+ 14x14 RoIAlign, mask head and loss).  The
        parts are those that exist by then; a stage that ends before any
        loss term adds a "probe" sum that depends on its last output."""
        if profile_stage is not None and profile_stage not in PROFILE_STAGES:
            raise ValueError(f"unknown profile stage {profile_stage!r}; expected one of "
                             f"{PROFILE_STAGES} (or, in profile_losses, 'match' or 'full')")
        rh = self.cfg.roi_heads
        rpn_cfg = self.cfg.rpn
        b = images.shape[0]
        dev = images.device
        image_sizes = image_sizes.to(dev)
        feats = self.features(images)
        if profile_stage == "backbone":
            return {"probe": sum(f.to(torch.float32).sum() for f in feats)}, None, None
        levels = self.roi_levels(feats)
        pq = self._quantize_pyramid(levels)
        obj, regs = self.rpn["head"](feats)
        logits, deltas = flatten_rpn_outputs(obj, regs)
        logits = [x.to(torch.float32) for x in logits]
        deltas = [x.to(torch.float32) for x in deltas]
        anchors = self._grid_anchors(feats)
        # the reference detaches its proposals
        props, _, pvalid = select_proposals([x.detach() for x in logits],
                                            [x.detach() for x in deltas], anchors,
                                            image_sizes, rpn_cfg, training=True)
        gt_boxes, gt_valid = gt["boxes"], gt["valid"]
        all_props = torch.cat([props, gt_boxes], dim=1)
        all_valid = torch.cat([pvalid, gt_valid], dim=1)
        anchors_all = torch.cat(anchors)
        if draws is None:
            draws = {
                k: torch.rand((b, n), generator=generator, device=generator.device).to(dev)
                for k, n in (("rpn", anchors_all.shape[0]), ("roi", all_props.shape[1]))}

        # --- RPN loss over all anchors (per-image means, summed) ----------
        loss_obj, loss_box = det_losses.rpn_loss(
            torch.cat(logits, dim=1), torch.cat(deltas, dim=1), anchors_all, gt_boxes,
            gt_valid, draws["rpn"], rpn_cfg.batch_size_per_image, rpn_cfg.positive_fraction,
            rpn_cfg.fg_iou_thresh, rpn_cfg.bg_iou_thresh)
        parts = {"obj_sum": loss_obj.sum(), "rpn_box_sum": loss_box.sum()}
        if profile_stage == "rpn":
            return parts, None, None

        # --- RoI sampling, GTs appended -------------------------------------
        matched, labels, sample = assign_and_sample(
            all_props, all_valid, gt_boxes, gt["labels"], gt_valid, draws["roi"],
            rh.batch_size_per_image, rh.positive_fraction, rh.fg_iou_thresh, rh.bg_iou_thresh)
        take = lambda a, idx: torch.take_along_dim(a, idx, dim=1)  # noqa: E731
        s_idx = sample.idx
        s_props = take(all_props, s_idx[..., None])
        s_labels, s_matched, s_valid = take(labels, s_idx), take(matched, s_idx), sample.valid
        if profile_stage == "sample":
            return dict(parts, probe=s_props.sum()), None, None

        # --- box branch (K2 at 7x7) -----------------------------------------
        class_logits, box_deltas = self.box_branch(levels, s_props, pq)
        reg_targets = encode_boxes(take(gt_boxes, s_matched[..., None]), s_props,
                                   rh.bbox_reg_weights)
        flat = lambda x: x.reshape((-1,) + x.shape[2:])  # noqa: E731
        cls_sum, box_sum, samp_n = det_losses.fastrcnn_loss_parts(
            flat(class_logits), flat(box_deltas), flat(s_labels), flat(reg_targets),
            flat(s_valid))
        parts.update(cls_sum=cls_sum, box_sum=box_sum, samp_n=samp_n)
        if profile_stage == "boxbranch":
            return parts, None, None

        # --- mask branch (K2 at 14x14; the sampler packs positives first) ---
        m = min(num_mask_slots, s_props.shape[1])
        m_props, m_valid = s_props[:, :m], sample.is_pos[:, :m]
        m_matched, m_labels = s_matched[:, :m], s_labels[:, :m]
        roi14 = self._roi_align(levels, m_props, rh.mask_roi_output, pq)
        mask_logits = self.mask_branch(roi14)
        mask_t = det_losses.mask_targets_from_crops(gt["mask_crops"].to(torch.float32),
                                                    gt_boxes, m_props, m_matched)
        mask_sum, mask_n = det_losses.maskrcnn_loss_parts(mask_logits, flat(mask_t),
                                                          flat(m_labels), flat(m_valid))
        parts.update(mask_sum=mask_sum, mask_n=mask_n)
        if profile_stage == "mask":
            return parts, None, None

        # --- match-branch RoIs: top-IoU positives per GT --------------------
        k = num_match_slots
        slot_idx, slot_valid = _select_match_slots(m_props, m_valid, gt_boxes, gt_valid, k)
        mt_matched = take(m_matched, slot_idx)
        rows = (torch.arange(b, device=dev)[:, None] * m + slot_idx).reshape(-1)
        mt_roi = roi14[rows].to(torch.float32)
        meta = {"pair_ids": flat(take(gt["pair_ids"], mt_matched)),
                "styles": flat(take(gt["styles"], mt_matched)),
                "src": gt["source"].repeat_interleave(k),
                "valid": flat(slot_valid)}
        return parts, mt_roi, meta

    def match_loss_from_rois(self, rois: torch.Tensor, meta: Dict[str, torch.Tensor]
                             ) -> torch.Tensor:
        """The supervised match loss over exported match-slot RoIs [N, 256,
        14, 14] f32.  The trunk's BatchNorm trains over the valid rows of
        exactly these slots: pass the whole batch's slots, never one
        bucket's."""
        mp = self.roi_heads["match_predictor"]
        sv = meta["valid"]
        desc = mp.descriptors(rois, valid=sv, train=True)
        logits = mp.score_pairs(desc, desc)
        return match_loss_supervised(logits, meta["pair_ids"], meta["styles"],
                                     meta["pair_ids"], meta["styles"],
                                     sv & (meta["src"] == 0), sv & (meta["src"] == 1),
                                     require_nonzero_style=True)

    @staticmethod
    def det_losses_from_parts(parts: Dict[str, torch.Tensor], n_images: int,
                              mask_px: int = 28 * 28) -> Dict[str, torch.Tensor]:
        """Normalize detector-loss parts (summed over the buckets of a batch)
        as the fused batch does."""
        samp_n = parts["samp_n"].clamp(min=1)
        return {
            "loss_objectness": parts["obj_sum"] / n_images,
            "loss_rpn_box_reg": parts["rpn_box_sum"] / n_images,
            "loss_classifier": parts["cls_sum"] / samp_n,
            "loss_box_reg": parts["box_sum"] / samp_n,
            "loss_mask": parts["mask_sum"] / (parts["mask_n"].clamp(min=1) * mask_px),
        }

    def training_losses(self, buckets: Sequence[Dict],
                        generator: Optional[torch.Generator] = None,
                        draws: Optional[Sequence[Dict[str, torch.Tensor]]] = None,
                        group=None, profile_stage: Optional[str] = None
                        ) -> Dict[str, torch.Tensor]:
        """The supervised Match R-CNN losses of one batch, given as one dict
        (images, sizes, gt; see ``train_export``) per canvas bucket, with the
        fused batch's semantics: the detector parts are summed over the
        buckets and divided by the batch-wide normalizers, and the match loss
        is computed once over every bucket's slots (its BatchNorm trains over
        all of them, and street/shop pairs cross buckets).  The samplers draw
        from ``generator`` or take ``draws`` (one dict per bucket).

        Under a process ``group`` of W ranks the batch is the global one,
        each rank holding its share of the images (the JAX package's
        data-sharded step, train/steps.py:140-150):

          * the normalizers (``samp_n``, ``mask_n``, the image count) are
            summed over the ranks, so each detector loss returned is this
            rank's share of the global one, and summing them over the ranks
            gives the global value;
          * the match loss is computed over every rank's slots: the other
            ranks' RoIs are gathered detached and this rank's own stay live
            in the graph, so it is the global batch's loss, equal on every
            rank, and its BatchNorm trains over all valid slots.

        The gradient scale follows: a backward from the sum of these losses
        gives this rank's share of every detector gradient (the match loss
        reaches the detector only through this rank's RoIs) and the whole
        match predictor gradient.  Summing the gradients over the ranks and
        averaging the match predictor's (``Phase1Trainer`` sets
        ``SGD.distribute`` so) gives the global batch's gradient.

        ``profile_stage`` (one process only): the losses of that prefix of
        the pipeline (``train_export``), normalized as the JAX
        ``profile_losses`` does: "probe" (1e-6 x the stage's probe sum),
        "loss_rpn" (objectness + RPN box sums over the images), "loss_box"
        (classifier + box sums over the sampled RoIs), "loss_mask", each
        where the stage reaches it."""
        if profile_stage is not None and group is not None:
            raise ValueError("profile_stage measures one process; it takes no group")
        draws = draws if draws is not None else [None] * len(buckets)
        exports = [self.train_export(b["images"], b["sizes"], b["gt"], d, generator,
                                     profile_stage=profile_stage)
                   for b, d in zip(buckets, draws)]
        parts = {k: sum(e[0][k] for e in exports) for k in exports[0][0]}
        n_images = sum(b["images"].shape[0] for b in buckets)
        if profile_stage is not None:
            return _stage_losses(parts, n_images)
        rois = torch.cat([e[1] for e in exports])
        meta = {k: torch.cat([e[2][k] for e in exports]) for k in exports[0][2]}
        if group is not None:
            rois, meta, parts, n_images = _global_match_batch(rois, meta, parts, n_images,
                                                              group)
        losses = self.det_losses_from_parts(parts, n_images)
        losses["loss_match"] = self.match_loss_from_rois(rois, meta)
        return losses

    def profile_losses(self, buckets: Sequence[Dict], stage: str,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[Sequence[Dict[str, torch.Tensor]]] = None
                       ) -> torch.Tensor:
        """The scalar loss of the cumulative prefix of the phase-1 pipeline
        named by ``stage`` (the JAX ``MatchRCNN.profile_losses``, the
        surface of ``tools/profile_torch_train.py``): "match" and "full" are
        ``sum(training_losses(...))``; the stages of ``PROFILE_STAGES`` sum
        the loss parts that exist by then with the same normalizers, plus a
        1e-6 probe term where the prefix has no loss yet."""
        full = stage in ("match", "full")
        return sum(self.training_losses(buckets, generator, draws,
                                        profile_stage=None if full else stage).values())


def _stage_losses(parts: Dict[str, torch.Tensor], n_images: int) -> Dict[str, torch.Tensor]:
    """``training_losses``' terms of a truncated pipeline, in the JAX
    ``profile_losses``' order of summation."""
    out = {}
    if "probe" in parts:
        out["probe"] = parts["probe"] * 1e-6
    if "obj_sum" in parts:
        out["loss_rpn"] = (parts["obj_sum"] + parts["rpn_box_sum"]) / n_images
    if "cls_sum" in parts:
        out["loss_box"] = (parts["cls_sum"] + parts["box_sum"]) / parts["samp_n"].clamp(min=1)
    if "mask_sum" in parts:
        out["loss_mask"] = parts["mask_sum"] / (parts["mask_n"].clamp(min=1) * (28 * 28))
    return out


_META_KEYS = ("pair_ids", "styles", "src", "valid")


def _global_match_batch(rois: torch.Tensor, meta: Dict[str, torch.Tensor],
                        parts: Dict[str, torch.Tensor], n_images: int, group):
    """``training_losses``' global batch from this rank's share: every
    rank's match-slot RoIs in rank order (the others' detached, this rank's
    live), their metadata, and the detector parts with the normalizers
    summed over the group.  Every rank must hold as many images (equal
    shapes for the gathers)."""
    from ..parallel.collectives import all_gather, all_reduce_sum

    rank = torch.distributed.get_rank(group)
    norms = all_reduce_sum(torch.stack([parts["samp_n"].to(torch.float32),
                                        parts["mask_n"].to(torch.float32),
                                        torch.tensor(float(n_images), device=rois.device)]),
                           group)
    parts = dict(parts, samp_n=norms[0], mask_n=norms[1])
    shards = list(all_gather(rois, group).unbind(0))
    shards[rank] = rois
    packed = all_gather(torch.stack([meta[k].to(torch.int64) for k in _META_KEYS], 1), group)
    packed = packed.reshape(-1, len(_META_KEYS))
    meta = {k: packed[:, i].to(meta[k].dtype) for i, k in enumerate(_META_KEYS)}
    return torch.cat(shards), meta, parts, int(norms[2])


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
        elif isinstance(mod, (nn.LayerNorm, ChannelLayerNorm)):
            fill(mod.weight, torch.ones_like(mod.weight))
            fill(mod.bias, torch.zeros_like(mod.bias))
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
    for name, t in model.named_parameters():
        if name.rsplit(".", 1)[-1] in ("pos_embed", "rel_pos_h", "rel_pos_w"):
            normal(t, 0.02)  # ViTDet's position tables (trunc-normal 0.02 there)
    missing = [n for n, t in list(model.named_parameters()) + list(model.named_buffers())
               if id(t) not in done]
    if missing:
        raise RuntimeError(f"init_parameters left tensors unset: {missing[:5]}")
    return model


def init_model(cfg: ModelConfig, video: bool = False, seed: int = 0,
               device=None) -> MatchRCNN:
    """A MatchRCNN with random weights made from ``seed`` on a CPU
    generator (the same weights on every device), moved to ``device``: the
    CUDA device unless the caller asks for another (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("init_model: no CUDA device; pass device='cpu' to build "
                               "the model on the CPU")
        device = "cuda"
    with torch.device("meta"):
        model = MatchRCNN(cfg, video)
    model = model.to_empty(device="cpu")
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)
