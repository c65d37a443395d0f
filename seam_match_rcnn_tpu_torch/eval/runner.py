"""Batched inference runner: host-side bucketing around the model forward.

Port of ``seam_match_rcnn_tpu/eval/runner.py`` with its device ingest:
images are resized on the device into their orientation canvas, grouped
into batches, split into chunks, run through ``MatchRCNN.inference`` (plus
the aggregator's descriptors), and returned per image with boxes mapped
back to original coordinates (torchvision
``GeneralizedRCNNTransform.postprocess``).  ``run`` keeps chosen outputs on
the device, in input order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.matchrcnn import MatchRCNN
from ..models.transform import batch_images, device_batch_images, resize_boxes_back


def _chunk_plan(n: int, chunk: int):
    """Greedy (start, size) decomposition: full chunks, then a binary
    decomposition of the remainder (sizes 8/4/2/1, no padding)."""
    plan = []
    s = 0
    while n - s >= chunk:
        plan.append((s, chunk))
        s += chunk
    size = 8
    while s < n:
        if size <= n - s:
            plan.append((s, size))
            s += size
        else:
            size //= 2
    return plan


class InferenceRunner:
    def __init__(self, model: MatchRCNN, chunk: int = 8, ingest: str = "device",
                 with_match: bool = True, with_aggr_features: bool = True,
                 with_roi_features: bool = False):
        """Runs on the model's device.  ``ingest``: "device" (raw upload,
        resize on the device); the JAX package's "host" ingest (a cv2 resize
        before the upload) waits for the port's data layer (ROADMAP M10.1).
        The ``with_*`` flags choose the outputs: the match and aggregator
        descriptors, and the 14x14 RoI features (phase-2 training keeps
        them on the device, ``run``)."""
        if ingest == "host":
            raise NotImplementedError(
                "ingest='host' (the cv2 resize of the JAX package) is not ported: it waits "
                "for the data layer (ROADMAP M10.1); use ingest='device'")
        if ingest != "device":
            raise ValueError(f"unknown ingest {ingest!r}: 'host' or 'device'")
        self.model = model
        self.chunk = chunk
        self.with_match = with_match
        self.with_aggr = with_aggr_features
        self.with_roi = with_roi_features
        self.device = next(model.parameters()).device

    def batches(self, images: List[np.ndarray]):
        """The forward batches.  Under "pallas_int8" the int8 pyramid's
        scales span a forward batch, so images are batched as the JAX
        device ingest batches them, one batch per source geometry.  Every
        other backend's outputs are per image, whatever shares the batch:
        there the two orientation canvases fill more of each chunk, which
        matters for a gallery of images of many sizes."""
        batch = (device_batch_images
                 if self.model.cfg.roi_heads.roi_align_backend == "pallas_int8"
                 else batch_images)
        return batch(images, self.model.cfg.transform, self.device)

    def _forward(self, pixels: torch.Tensor, sizes: np.ndarray) -> Dict[str, torch.Tensor]:
        out = self.model.inference(pixels, torch.as_tensor(sizes, device=self.device),
                                   with_match=self.with_match, with_roi_features=True)
        roi = out["roi_features"] if self.with_roi else out.pop("roi_features")
        if self.with_aggr:
            b, d = roi.shape[:2]
            out["aggr_features"] = self.model.aggregator_descriptors(
                roi.reshape((b * d,) + roi.shape[2:])).reshape(b, d, -1)
        return out

    def __call__(self, images: List[np.ndarray]) -> List[Dict[str, np.ndarray]]:
        """images: HWC arrays in [0, 1] (or uint8).  Returns one dict per image
        (input order) of numpy arrays: boxes [D, 4] in ORIGINAL image
        coordinates, scores, labels, valid [D], and as the flags ask,
        match_features and aggr_features [D, 256] and roi_features [D, 256,
        14, 14]."""
        return self.run(images, device_keys=())[0]

    def run(self, images: List[np.ndarray], device_keys: Optional[Sequence[str]] = None
            ) -> Tuple[List[Dict[str, np.ndarray]], Dict[str, torch.Tensor]]:
        """As ``__call__``, but the outputs named in ``device_keys`` stay on
        the device, returned apart as [N_images, ...] tensors in input order
        (each chunk's rows written to its images' places): phase-2 training
        gathers its rows' RoI features there.  ``device_keys`` defaults to
        ("roi_features",) when the runner exports them, else ()."""
        if device_keys is None:
            device_keys = ("roi_features",) if self.with_roi else ()
        results: List[Optional[Dict[str, np.ndarray]]] = [None] * len(images)
        dev: Dict[str, torch.Tensor] = {}
        for bucket in self.batches(images):
            n = bucket.pixels.shape[0]
            for s, size in _chunk_plan(n, self.chunk):
                e = s + size
                out = self._forward(bucket.pixels[s:e], bucket.sizes[s:e])
                for k in device_keys:
                    if k not in out:
                        raise ValueError(f"run: device key {k!r} is not an output of this "
                                         f"runner ({sorted(out)})")
                    v = out.pop(k)
                    if k not in dev:
                        dev[k] = torch.empty((len(images),) + v.shape[1:], dtype=v.dtype,
                                             device=v.device)
                    dev[k][torch.as_tensor(bucket.indices[s:e], device=v.device)] = v
                host = {k: v.cpu().numpy() for k, v in out.items()}
                for j in range(e - s):
                    r = {k: v[j] for k, v in host.items()}
                    r["boxes"] = resize_boxes_back(r["boxes"], tuple(bucket.sizes[s + j]),
                                                   tuple(bucket.orig_sizes[s + j]))
                    results[bucket.indices[s + j]] = r
        return results, dev
