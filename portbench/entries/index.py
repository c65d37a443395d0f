"""Gallery indexing: ``InferenceRunner.run`` over calls of MovingFashion-shaped
products, every descriptor out (the eval harnesses' and offline indexing's path).

An item is one call of the mix's products (``products_per_call`` x (1 shop image +
``frames_per_product`` frames)); its unit count is the images whose detections
and match and aggregator descriptors reached the host.

The comparison (``check``), once the window has closed and the port is freed, on
``check_images`` images drawn from the seed, each as the window last returned
it, against the float32 reference run on the same raw image
(``judge_image``):

* ``score_gap``: the median score gap between the images' 20 best detections
  and the reference detections of the same label that they overlap at IoU >=
  0.9, over all of them (scores and labels).  The widest such gap is recorded
  (``diagnostics``), not judged: a best detection whose box came from another
  proposal than the reference's reads a gap that a sound run can reach;
* ``box_miss``: the share of those best detections that overlap no reference
  detection of their label at IoU >= 0.5 (boxes; with random weights and
  another precision a few proposals change near the RPN's cuts, so a few best
  detections have no counterpart even in a sound run);
* ``match_gap`` / ``aggr_gap``: the widest relative gap of a detection's match
  / aggregator descriptor from the reference's at the same box (the
  reference's own backbone, RoIAlign and f32 trunks at the port's boxes),
  against the larger of that row's norm and the image's median row norm;
* ``trunk_gap``: the widest relative gap of the descriptors that the port's
  match and aggregator trunks returned in the window's last calls, on a few
  rows of each call drawn from the seed, from the reference trunks' run on the
  port's own pooled RoI features of those rows (``TrunkTap``).  The gaps above
  carry the bf16 detector's rounding, which would hide trunks run in a lower
  precision than the configuration's f32 with TF32 off; this one holds the
  trunks alone, from the program's own state (the stage before it, pooling, is
  judged from the raw image by the gaps above).
"""

from __future__ import annotations

import collections
from typing import Dict

import numpy as np
import torch

from .. import generate
from .. import model as M
from ..reference import transform as rt

TOP_BOXES = 20   # the best detections an image whose boxes and scores are judged
SCORE_IOU = 0.9  # a best detection's counterpart for its score
CLOSE_IOUS = (0.95, 0.99)  # recorded: the widest score gap of counterparts this close
BOX_IOU = 0.5    # a best detection with no same-label reference box this close is missed
TAP_CALLS = 8    # the last trunk calls whose rows the trunk comparison keeps
TAP_ROWS = 32    # rows kept of each trunk call
TRUNKS = ("match_descriptors", "aggregator_descriptors")


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: np.clip(x[:, 2:] - x[:, :2], 0, None).prod(-1)  # noqa: E731
    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter, 1e-9)


def _row_gap(p: np.ndarray, r: np.ndarray) -> float:
    if len(r) == 0:
        return 0.0
    rn = np.linalg.norm(r, axis=1)
    denom = np.maximum(rn, np.median(rn))
    return float((np.linalg.norm(p - r, axis=1) / np.maximum(denom, 1e-12)).max())


class Judged:
    """The comparison's numbers, gathered image by image."""

    def __init__(self):
        self.match_gap = self.aggr_gap = 0.0
        self.missed = self.best = 0
        self.gaps, self.ious = [], []

    def add(self, image: dict) -> None:
        self.gaps.append(image["score_gaps"])
        self.ious.append(image["score_ious"])
        self.match_gap = max(self.match_gap, image["match_gap"])
        self.aggr_gap = max(self.aggr_gap, image["aggr_gap"])
        self.missed += image["missed"]
        self.best += image["best"]

    def numbers(self) -> Dict[str, float]:
        gaps = np.concatenate(self.gaps) if self.gaps else np.zeros(0)
        return {"score_gap": float(np.median(gaps)) if len(gaps) else 0.0,
                "box_miss": self.missed / max(self.best, 1),
                "match_gap": self.match_gap, "aggr_gap": self.aggr_gap}

    def diagnostics(self) -> Dict[str, float]:
        gaps = np.concatenate(self.gaps) if self.gaps else np.zeros(0)
        ious = np.concatenate(self.ious) if self.ious else np.zeros(0)
        out = {"score_gap_widest": float(gaps.max()) if len(gaps) else 0.0,
               "score_pairs": int(len(gaps))}
        for t in CLOSE_IOUS:
            close = gaps[ious >= t]
            out[f"score_gap_widest_iou{t}"] = float(close.max()) if len(close) else 0.0
        return out


def judge_image(ref, img: np.ndarray, prog: dict, device) -> dict:
    """One image's detections and descriptors (the runner's per-image dict:
    boxes in the original image, scores, labels, valid, match_features,
    aggr_features) against the reference's forward on the same raw image.
    Also returns the reference's descriptors at the port's boxes."""
    canvas, (nh, nw) = rt.ingest(img, ref.cfg.transform, device)
    feats, det = ref.detect(canvas, torch.tensor([[nh, nw]], device=device))
    rv = det.valid[0].cpu().numpy()
    r_boxes, r_scores = det.boxes[0].cpu().numpy()[rv], det.scores[0].cpu().numpy()[rv]
    r_labels = det.labels[0].cpu().numpy()[rv]
    pv = np.asarray(prog["valid"], bool)
    # the port's boxes are in the original image; the reference's on the canvas
    boxes = rt.to_canvas_boxes(np.asarray(prog["boxes"]), (nh, nw), img.shape[:2])
    p_scores, p_labels = np.asarray(prog["scores"])[pv], np.asarray(prog["labels"])[pv]
    top = np.argsort(-p_scores, kind="stable")[:TOP_BOXES]
    gaps, ious, missed = np.zeros(0), np.zeros(0), len(top)
    if len(top) and len(r_boxes):
        iou = _iou(boxes[pv][top], r_boxes)
        iou = np.where(p_labels[top][:, None] == r_labels[None, :], iou, 0.0)
        best, j = iou.max(axis=1), iou.argmax(axis=1)
        close = best >= SCORE_IOU
        gaps, ious = np.abs(p_scores[top] - r_scores[j])[close], best[close]
        missed = int((best < BOX_IOU).sum())
    roi = ref.roi_features(feats, torch.as_tensor(boxes, device=device)[None])
    md, ad = ref.match_descriptors(roi), ref.aggregator_descriptors(roi)
    return {"score_gaps": gaps, "score_ious": ious, "missed": missed, "best": len(top),
            "match_gap": _row_gap(np.asarray(prog["match_features"])[pv], md.cpu().numpy()[pv]),
            "aggr_gap": _row_gap(np.asarray(prog["aggr_features"])[pv], ad.cpu().numpy()[pv]),
            "ref_match": md, "ref_aggr": ad}


class TrunkTap:
    """Keeps, on the device, ``TAP_ROWS`` rows of the inputs (the port's pooled
    RoI features) and outputs (descriptors) of each of a trunk's last
    ``TAP_CALLS`` calls.  The rows are drawn from the seed, as offsets taken
    modulo the call's row count."""

    def __init__(self, model, seed: int, device):
        self.offsets = torch.as_tensor(generate.rng(seed, 10).integers(0, 2**31, TAP_ROWS),
                                       device=device)
        self.kept = {name: collections.deque(maxlen=TAP_CALLS) for name in TRUNKS}
        for name in TRUNKS:
            setattr(model, name, self._tap(name, getattr(model, name)))

    def _tap(self, name, trunk):
        def tapped(roi):
            out = trunk(roi)
            rows = self.offsets % roi.shape[0]
            self.kept[name].append((roi.index_select(0, rows).to(torch.float32),
                                    out.index_select(0, rows)))
            return out

        return tapped

    @staticmethod
    def remove(model) -> None:
        """Take the taps off ``model``, so that deleting it frees it."""
        for name in TRUNKS:
            delattr(model, name)

    def gap(self, ref) -> float:
        """The widest row gap of the kept outputs from the reference trunks'
        on the kept inputs."""
        worst = 0.0
        with torch.no_grad():
            for name in TRUNKS:
                for roi, out in self.kept[name]:
                    worst = max(worst, _row_gap(out.cpu().numpy(),
                                                getattr(ref, name)(roi).cpu().numpy()))
        return worst


class Entry:
    unit = "frames"

    def __init__(self, cfg: dict, mix: dict, seed: int, device, transform=None):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.transform = transform
        self.kept: Dict[tuple, dict] = {}

    def setup_inputs(self) -> None:
        """The calls and the images the comparison samples, from the seed."""
        self.calls = generate.products(self.mix, self.seed, self.device)
        per_call = len(self.calls[0])
        picks = generate.rng(self.seed, 6).choice(len(self.calls) * per_call,
                                                 self.mix["check_images"], replace=False)
        self.sample = sorted((int(i) // per_call, int(i) % per_call) for i in picks)

    def setup(self) -> None:
        from seam_match_rcnn_tpu_torch.eval.runner import InferenceRunner

        clock = M.Clock(self.device)
        self.model = M.port_model(self.cfg, self.seed, self.device, self.transform)
        self.tap = TrunkTap(self.model, self.seed, self.device)
        self.runner = InferenceRunner(self.model, chunk=self.mix["chunk"],
                                      ingest=self.mix["ingest"], with_match=True,
                                      with_aggr_features=True)
        clock.lap("weights")
        self.setup_inputs()
        clock.lap("inputs")
        self.next = 0
        for _ in self.calls:  # every call once: the cell's shapes, nothing else
            self.item()
        clock.lap("warm-up")
        self.phases = clock.laps

    @property
    def cycle(self) -> int:
        return len(self.calls)

    def item(self):
        c = self.next % len(self.calls)
        self.next += 1
        out = self.runner(self.calls[c])
        for cc, j in self.sample:
            if cc == c:
                self.kept[(cc, j)] = out[j]
        bad = sum(not all(np.isfinite(v).all() for v in o.values()) for o in out)
        return len(out), bad

    @staticmethod
    def end_to_end(done: int, seconds: float, lat) -> Dict[str, float]:
        return {"index_frames_per_s": done / seconds}

    def release(self) -> None:
        TrunkTap.remove(self.model)
        del self.runner, self.model
        torch.cuda.empty_cache() if torch.cuda.is_available() else None

    # ---- the comparison --------------------------------------------------

    def control_outputs(self) -> Dict[tuple, dict]:
        """The precision control in the port's place: the reference in scaled
        float8 (``reference/layers.FP8``), same images, same outputs."""
        from ..reference.layers import FP8

        ref = M.reference_model(self.cfg, self.seed, self.device, FP8, self.transform)
        out = {}
        for key in self.sample:
            img = self.calls[key[0]][key[1]]
            feats, det, (nh, nw) = self._detect(ref, img)
            v = det.valid[0]
            boxes = det.boxes[0][v]
            roi = ref.roi_features(feats, boxes[None])
            ratio = np.asarray([img.shape[1] / nw, img.shape[0] / nh] * 2, np.float32)
            out[key] = {"boxes": boxes.cpu().numpy() * ratio,
                        "scores": det.scores[0][v].cpu().numpy(),
                        "labels": det.labels[0][v].cpu().numpy(),
                        "valid": np.ones(int(v.sum()), bool),
                        "match_features": ref.match_descriptors(roi).cpu().numpy(),
                        "aggr_features": ref.aggregator_descriptors(roi).cpu().numpy()}
        del ref
        return out

    def _detect(self, ref, img):
        canvas, (nh, nw) = rt.ingest(img, ref.cfg.transform, self.device)
        feats, det = ref.detect(canvas, torch.tensor([[nh, nw]], device=self.device))
        return feats, det, (nh, nw)

    def check(self, outputs: Dict[tuple, dict] = None) -> Dict[str, float]:
        """The port's outputs (or the control's ``outputs``, which have no trunk
        rows of their own) against the reference."""
        port = outputs is None
        outputs = self.kept if port else outputs
        ref = M.reference_model(self.cfg, self.seed, self.device, transform=self.transform)
        acc = Judged()
        for key in self.sample:
            if key not in outputs:
                return {"missing_answers": float("inf")}
            acc.add(judge_image(ref, self.calls[key[0]][key[1]], outputs[key], self.device))
        numbers = acc.numbers()
        self.diagnostics = acc.diagnostics()
        if port:
            numbers["trunk_gap"] = self.tap.gap(ref)
        del ref
        return numbers

    # ---- operations a unit, for the model step's share of the peak ------

    def flops_per_unit(self) -> Dict[str, float]:
        """One image's operations on the reference: the detector (bf16 in the
        configuration) and both trunks over the detections (f32)."""
        from torch.utils.flop_counter import FlopCounterMode

        ref = M.reference_model(self.cfg, self.seed, self.device, transform=self.transform)
        img = self.calls[0][1]
        with FlopCounterMode(display=False) as det_count:
            feats, det, _ = self._detect(ref, img)
        roi = ref.roi_features(feats, det.boxes)
        with FlopCounterMode(display=False) as trunk_count:
            ref.match_descriptors(roi)
            ref.aggregator_descriptors(roi)
        del ref
        return {"bfloat16": float(det_count.get_total_flops()),
                "float32": float(trunk_count.get_total_flops())}
