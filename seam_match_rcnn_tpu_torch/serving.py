"""Video-to-shop retrieval in three calls, on PyTorch.

Port of ``seam_match_rcnn_tpu/serving.py``:

    retr = SeamRetrieval(model)                          # model holds its weights
    retr = SeamRetrieval.from_checkpoint("model.pth")    # or from a torch file
    gallery = retr.build_gallery(shop_images)            # once
    result = retr.retrieve(video_frames, gallery, k=5)   # per query video

The detector runs on the model's device; the frame self-similarity, the
temporal aggregation and the gallery scoring run there too (kernels K4, K3
and K4 on a CUDA device).  Greedy tracking stays on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .ckpt.torch_convert import load_pretrained_detector
from .config import EvalConfig, ModelConfig, serving_model_config
from .eval.gallery import score_matrix
from .eval.runner import InferenceRunner
from .eval.tracking import build_tracklets
from .models.matchrcnn import MatchRCNN, init_model


@dataclasses.dataclass
class Gallery:
    match_feats: np.ndarray   # [G, 256]
    aggr_feats: np.ndarray    # [G, 256]
    keys: List[str]

    def save(self, path: str) -> str:
        """Persist the index as one .npz (build once, serve many)."""
        if not path.endswith(".npz"):
            path += ".npz"
        np.savez(path, match_feats=self.match_feats, aggr_feats=self.aggr_feats,
                 keys=np.asarray(self.keys, dtype=str))
        return path

    @classmethod
    def load(cls, path: str) -> "Gallery":
        with np.load(path) as z:
            return cls(match_feats=z["match_feats"], aggr_feats=z["aggr_feats"],
                       keys=[str(k) for k in z["keys"]])


@dataclasses.dataclass
class RetrievalResult:
    indices: np.ndarray       # [k] gallery indices, best first
    scores: np.ndarray        # [k] match probabilities
    keys: List[str]
    track_length: int


class SeamRetrieval:
    def __init__(self, model: MatchRCNN, cfg: Optional[EvalConfig] = None, chunk: int = 8):
        if not model.video:
            raise ValueError("SeamRetrieval needs the video model (MatchRCNN(video=True))")
        self.model = model
        self.cfg = cfg or EvalConfig()
        self.runner = InferenceRunner(model, chunk=chunk)
        self.device = self.runner.device
        heads = model.roi_heads
        self._w = heads["match_predictor"].last.weight.detach()
        self._b = heads["match_predictor"].last.bias.detach()
        self._aw = heads["temporal_aggregator"].last.weight.detach()
        self._ab = heads["temporal_aggregator"].last.bias.detach()

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Optional[ModelConfig] = None,
                        cfg_eval: Optional[EvalConfig] = None, device=None,
                        **kw) -> "SeamRetrieval":
        """Serve a torch checkpoint (a file with the reference's key names):
        the video model of ``cfg`` (the serving profile by default) on
        ``device`` (the card unless asked otherwise), its aggregator
        warm-started from the match predictor, with the JAX converter's
        fresh NLB and attention, when the file has none;
        ``cfg_eval`` becomes the instance's retrieval ``cfg``.  The JAX
        package's Orbax directories wait for the port's ``ckpt/io``."""
        model = init_model(cfg or serving_model_config(), video=True, device=device)
        load_pretrained_detector(path, model, clone_match_to_aggregator=False)
        return cls(model, cfg=cfg_eval, **kw)

    def _best_box(self, out) -> Optional[int]:
        keep = np.nonzero((out["scores"] >= self.cfg.score_threshold) & out["valid"])[0]
        if keep.size == 0:
            return None
        b = out["boxes"][keep]
        areas = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        return int(keep[np.argmax(areas)])

    def build_gallery(self, shop_images: Sequence[np.ndarray],
                      keys: Optional[List[str]] = None) -> Gallery:
        """shop_images: HWC float [0, 1] arrays, one per product; each
        product is represented by its largest detection."""
        outs = self.runner(list(shop_images))
        mf, af, kk = [], [], []
        for i, o in enumerate(outs):
            j = self._best_box(o)
            if j is None:
                continue
            mf.append(o["match_features"][j])
            af.append(o["aggr_features"][j])
            kk.append(keys[i] if keys else str(i))
        if not mf:
            raise ValueError("no shop image produced a detection >= score_threshold "
                             f"({self.cfg.score_threshold}) — cannot build a gallery")
        return Gallery(np.stack(mf), np.stack(af), kk)

    def embed_video(self, frames: Sequence[np.ndarray]) -> Dict[str, np.ndarray]:
        """Detect garments in the frames, track the dominant garment by
        match-head self-similarity, and aggregate its per-frame descriptors.
        Returns {'aggr': [256], 'frames': [T, 256], 'track_rows', 'n_boxes'}."""
        outs = self.runner(list(frames))
        feats, aggr, img_of, scores = [], [], [], []
        for i, o in enumerate(outs):
            keep = np.nonzero((o["scores"] >= self.cfg.score_threshold) & o["valid"])[0]
            for j in keep:
                feats.append(o["match_features"][j])
                aggr.append(o["aggr_features"][j])
                img_of.append(i)
                scores.append(float(o["scores"][j]))
        if not feats:
            raise ValueError("no detections in the video frames")
        feats, aggr = np.stack(feats), np.stack(aggr)
        img_of, scores = np.asarray(img_of), np.asarray(scores)

        self_sim = score_matrix(feats, feats, self._w, self._b, device=self.device)
        tracks = build_tracklets(self_sim, scores, img_of, self.cfg.tracking_threshold)
        # no GT oracle when serving: the track with the highest summed score
        best = int(np.argmax([scores[np.asarray(t)].sum() for t in tracks]))
        rows = np.asarray(tracks[best])
        seqs = torch.as_tensor(aggr[rows][None], device=self.device)
        mask = torch.ones((1, len(rows)), dtype=torch.bool, device=self.device)
        agg = self.model.aggregate_sequences(seqs, mask)[0].cpu().numpy()
        return {"aggr": agg, "frames": feats[rows], "track_rows": rows,
                "n_boxes": len(feats)}

    def retrieve(self, frames: Sequence[np.ndarray], gallery: Gallery,
                 k: int = 5) -> RetrievalResult:
        emb = self.embed_video(frames)
        scores = score_matrix(emb["aggr"][None], gallery.aggr_feats, self._aw, self._ab,
                              device=self.device)[0]
        order = np.argsort(scores)[::-1][:k]
        return RetrievalResult(indices=order, scores=scores[order],
                               keys=[gallery.keys[i] for i in order],
                               track_length=len(emb["track_rows"]))
