"""The plain Match R-CNN and SEAM Match R-CNN that the benchmark judges the port by.

A frozen copy of the plain paths of ``seam_match_rcnn_tpu_torch/models/matchrcnn.py``
(``ModelConfig()``'s "xla" backends: the torch-ops stem, the gather RoIAlign of
``roi_align.py`` and its autograd transpose, the torch-ops NLB), with the
kernels, the process group and the profiling hooks taken out.  It imports
nothing of the port.  Its module names are the port's, so one state dict
loads into both.

The benchmark builds it in float32 with TF32 off (``build``), or, as the
precision control, with every conv and dense layer of the detector in scaled
float8 (``layers.FP8``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn

from . import losses_detection as det_losses
from .anchors import grid_anchors
from .boxes import box_iou, encode_boxes
from .config import ModelConfig
from .detection import postprocess_detections
from .heads import FastRCNNPredictor, MaskHead, MaskPredictor, RPNHead, TwoMLPHead
from .layers import FP8
from .losses_match import match_loss_supervised
from .match_head import MatchPredictor, TemporalAggregator
from .resnet import BackboneWithFPN
from .roi_align import multilevel_roi_align
from .rpn import flatten_rpn_outputs, select_proposals, topk_stable
from .targets import assign_and_sample
from .transform import normalize


def _dtype(name: str):
    return FP8 if name == FP8 else getattr(torch, name)


def _select_match_slots(pos_props, pos_valid, gt_boxes, gt_valid, k: int):
    """Per GT, the top (k // n_gt) positive proposals by IoU, compacted into
    k slots in GT-major order -> (slot_idx [B, k], slot_valid [B, k])."""
    b, p = pos_props.shape[:2]
    per_gt = k // gt_valid.sum(dim=-1).clamp(min=1)
    iou = box_iou(pos_props, gt_boxes)
    iou = torch.where(pos_valid[:, :, None] & gt_valid[:, None, :], iou,
                      torch.full_like(iou, -1.0))
    ranks = torch.argsort(torch.argsort(-iou, dim=1, stable=True), dim=1, stable=True)
    sel = (ranks < per_gt[:, None, None]) & (iou > -1.0)
    flat = sel.transpose(1, 2).reshape(b, -1)
    ar = torch.arange(flat.shape[1], dtype=torch.float32, device=flat.device)
    _, top = topk_stable(torch.where(flat, 1e9 - ar, -ar), k)
    slot_valid = torch.take_along_dim(flat, top, dim=1)
    return torch.where(slot_valid, top % p, torch.zeros_like(top)), slot_valid


class MatchRCNN(nn.Module):
    """video=False: Match R-CNN (fallback detection score 1.0); video=True:
    SEAM Match R-CNN with the temporal aggregator (fallback 0.1)."""

    def __init__(self, cfg: ModelConfig, video: bool = False):
        super().__init__()
        self.cfg = cfg
        self.video = video
        dt = _dtype(cfg.compute_dtype)
        tdt = _dtype(cfg.match.trunk_dtype)
        rh = cfg.roi_heads
        self.backbone = BackboneWithFPN(dt)
        self.rpn = nn.ModuleDict({"head": RPNHead(cfg.anchors.num_anchors_per_location, dt)})
        heads = {
            "box_head": TwoMLPHead(256, rh.box_roi_output, dt),
            "box_predictor": FastRCNNPredictor(1024, cfg.num_classes, dt),
            "mask_head": MaskHead(dt),
            "mask_predictor": MaskPredictor(cfg.num_classes, dt),
            "match_predictor": MatchPredictor(tdt),
        }
        if video:
            heads["temporal_aggregator"] = TemporalAggregator(tdt)
        self.roi_heads = nn.ModuleDict(heads)
        self._anchors: Dict[tuple, Tuple[torch.Tensor, ...]] = {}
        self.eval()

    def features(self, images: torch.Tensor):
        return self.backbone(normalize(images.to(torch.float32), self.cfg.transform))

    def _grid_anchors(self, feats):
        canvas = (feats[0].shape[2] * 4, feats[0].shape[3] * 4)
        shapes = tuple((f.shape[2], f.shape[3]) for f in feats)
        key = (canvas, shapes, feats[0].device)
        if key not in self._anchors:
            a = self.cfg.anchors
            self._anchors[key] = tuple(
                torch.from_numpy(x).to(feats[0].device)
                for x in grid_anchors(canvas, shapes, tuple(a.sizes), tuple(a.aspect_ratios)))
        return self._anchors[key]

    def _roi_align(self, feats, rois, output_size: int):
        return multilevel_roi_align(feats[:4], rois, output_size,
                                    self.cfg.roi_heads.sampling_ratio)

    def box_branch(self, feats, rois):
        b, r = rois.shape[:2]
        x = self.roi_heads["box_head"](
            self._roi_align(feats, rois, self.cfg.roi_heads.box_roi_output))
        logits, deltas = self.roi_heads["box_predictor"](x)
        return (logits.reshape(b, r, -1).to(torch.float32),
                deltas.reshape(b, r, -1).to(torch.float32))

    def mask_branch(self, roi_feats):
        return self.roi_heads["mask_predictor"](
            self.roi_heads["mask_head"](roi_feats)).to(torch.float32)

    @torch.no_grad()
    def roi_features(self, feats, boxes: torch.Tensor) -> torch.Tensor:
        """[B, D, 4] canvas boxes -> [B*D, 256, 14, 14] f32 RoI features."""
        return self._roi_align(feats, boxes, self.cfg.roi_heads.mask_roi_output
                               ).to(torch.float32)

    @torch.no_grad()
    def match_descriptors(self, roi_feats):
        return self.roi_heads["match_predictor"].descriptors(roi_feats.to(torch.float32))

    @torch.no_grad()
    def aggregator_descriptors(self, roi_feats):
        return self.roi_heads["temporal_aggregator"].descriptors(roi_feats.to(torch.float32))

    @torch.no_grad()
    def aggregate_sequences(self, seqs, mask):
        return self.roi_heads["temporal_aggregator"].aggregate(seqs, mask)

    @torch.no_grad()
    def detect(self, images: torch.Tensor, image_sizes: torch.Tensor):
        """The serving forward up to the detections: (features, Detections)."""
        feats = self.features(images)
        obj, regs = self.rpn["head"](feats)
        logits, deltas = flatten_rpn_outputs(obj, regs)
        props, _, pvalid = select_proposals([x.to(torch.float32) for x in logits],
                                            [x.to(torch.float32) for x in deltas],
                                            self._grid_anchors(feats), image_sizes,
                                            self.cfg.rpn)
        cl, bd = self.box_branch(feats, props)
        det = postprocess_detections(cl, bd, props, pvalid, image_sizes, self.cfg.roi_heads,
                                     fallback_score=0.1 if self.video else 1.0)
        return feats, det

    # ---- phase-1 training ------------------------------------------------

    def train_export(self, images, image_sizes, gt, draws, num_match_slots: int = 8,
                     num_mask_slots: int = 128):
        """One canvas bucket's loss parts, match-slot RoIs and their metadata."""
        rh, rpn_cfg = self.cfg.roi_heads, self.cfg.rpn
        b, dev = images.shape[0], images.device
        feats = self.features(images)
        obj, regs = self.rpn["head"](feats)
        logits, deltas = flatten_rpn_outputs(obj, regs)
        logits = [x.to(torch.float32) for x in logits]
        deltas = [x.to(torch.float32) for x in deltas]
        anchors = self._grid_anchors(feats)
        props, _, pvalid = select_proposals([x.detach() for x in logits],
                                            [x.detach() for x in deltas], anchors,
                                            image_sizes, rpn_cfg, training=True)
        gt_boxes, gt_valid = gt["boxes"], gt["valid"]
        all_props = torch.cat([props, gt_boxes], dim=1)
        all_valid = torch.cat([pvalid, gt_valid], dim=1)
        loss_obj, loss_box = det_losses.rpn_loss(
            torch.cat(logits, dim=1), torch.cat(deltas, dim=1), torch.cat(anchors), gt_boxes,
            gt_valid, draws["rpn"], rpn_cfg.batch_size_per_image, rpn_cfg.positive_fraction,
            rpn_cfg.fg_iou_thresh, rpn_cfg.bg_iou_thresh)
        parts = {"obj_sum": loss_obj.sum(), "rpn_box_sum": loss_box.sum()}
        matched, labels, sample = assign_and_sample(
            all_props, all_valid, gt_boxes, gt["labels"], gt_valid, draws["roi"],
            rh.batch_size_per_image, rh.positive_fraction, rh.fg_iou_thresh, rh.bg_iou_thresh)
        take = lambda a, idx: torch.take_along_dim(a, idx, dim=1)  # noqa: E731
        s_idx = sample.idx
        s_props = take(all_props, s_idx[..., None])
        s_labels, s_matched, s_valid = take(labels, s_idx), take(matched, s_idx), sample.valid
        class_logits, box_deltas = self.box_branch(feats, s_props)
        reg_targets = encode_boxes(take(gt_boxes, s_matched[..., None]), s_props,
                                   rh.bbox_reg_weights)
        flat = lambda x: x.reshape((-1,) + x.shape[2:])  # noqa: E731
        cls_sum, box_sum, samp_n = det_losses.fastrcnn_loss_parts(
            flat(class_logits), flat(box_deltas), flat(s_labels), flat(reg_targets),
            flat(s_valid))
        parts.update(cls_sum=cls_sum, box_sum=box_sum, samp_n=samp_n)
        m = min(num_mask_slots, s_props.shape[1])
        m_props, m_valid = s_props[:, :m], sample.is_pos[:, :m]
        m_matched, m_labels = s_matched[:, :m], s_labels[:, :m]
        roi14 = self._roi_align(feats, m_props, rh.mask_roi_output)
        mask_t = det_losses.mask_targets_from_crops(gt["mask_crops"].to(torch.float32),
                                                    gt_boxes, m_props, m_matched)
        mask_sum, mask_n = det_losses.maskrcnn_loss_parts(self.mask_branch(roi14), flat(mask_t),
                                                          flat(m_labels), flat(m_valid))
        parts.update(mask_sum=mask_sum, mask_n=mask_n)
        k = num_match_slots
        slot_idx, slot_valid = _select_match_slots(m_props, m_valid, gt_boxes, gt_valid, k)
        mt_matched = take(m_matched, slot_idx)
        rows = (torch.arange(b, device=dev)[:, None] * m + slot_idx).reshape(-1)
        meta = {"pair_ids": flat(take(gt["pair_ids"], mt_matched)),
                "styles": flat(take(gt["styles"], mt_matched)),
                "src": gt["source"].repeat_interleave(k),
                "valid": flat(slot_valid)}
        return parts, roi14[rows].to(torch.float32), meta

    def training_losses(self, buckets: Sequence[Dict], draws: Sequence[Dict]):
        """The batch's losses with the fused batch's semantics: detector parts
        summed over the buckets over batch-wide normalizers, one match loss
        over every bucket's slots."""
        exports = [self.train_export(b["images"], b["sizes"], b["gt"], d)
                   for b, d in zip(buckets, draws)]
        parts = {k: sum(e[0][k] for e in exports) for k in exports[0][0]}
        n_images = sum(b["images"].shape[0] for b in buckets)
        rois = torch.cat([e[1] for e in exports])
        meta = {k: torch.cat([e[2][k] for e in exports]) for k in exports[0][2]}
        samp_n = parts["samp_n"].clamp(min=1)
        losses = {
            "loss_objectness": parts["obj_sum"] / n_images,
            "loss_rpn_box_reg": parts["rpn_box_sum"] / n_images,
            "loss_classifier": parts["cls_sum"] / samp_n,
            "loss_box_reg": parts["box_sum"] / samp_n,
            "loss_mask": parts["mask_sum"] / (parts["mask_n"].clamp(min=1) * 28 * 28),
        }
        mp = self.roi_heads["match_predictor"]
        sv = meta["valid"]
        desc = mp.descriptors(rois, valid=sv, train=True)
        losses["loss_match"] = match_loss_supervised(
            mp.score_pairs(desc, desc), meta["pair_ids"], meta["styles"], meta["pair_ids"],
            meta["styles"], sv & (meta["src"] == 0), sv & (meta["src"] == 1),
            require_nonzero_style=True)
        return losses


def build(cfg: ModelConfig, video: bool, state: Dict[str, torch.Tensor], device) -> MatchRCNN:
    """The reference model on ``device`` with the weights ``state`` (the
    benchmark's, by the port's names), TF32 off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.device("meta"):
        model = MatchRCNN(cfg, video)
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    for mod in (model.backbone.body.conv1, model.backbone.body.layer1):
        mod.requires_grad_(False)
    return model.eval()
