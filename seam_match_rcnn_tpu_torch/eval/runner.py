"""Batched inference runner: host-side bucketing around the model forward.

Port of ``seam_match_rcnn_tpu/eval/runner.py``: images are resized into
their orientation canvas (on the device, or with cv2 on the host),
grouped into batches, split into chunks, run through
``MatchRCNN.inference`` (plus the aggregator's descriptors), and returned
per image with boxes mapped back to original coordinates and, with masks,
each image's 28x28 probabilities pasted at its original size on the device
(torchvision ``GeneralizedRCNNTransform.postprocess``).  ``run`` keeps
chosen outputs on the device, in input order.

With a mesh (the JAX runner's ``shard_map`` over ``data``,
eval/runner.py:148-160 there) every chunk has the full size, the last one
padded with blank images, and each rank runs its ``chunk / data`` images
of it; the device outputs are gathered chunk by chunk and the host results
once at the end, so every rank returns the whole of them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.matchrcnn import MatchRCNN
from ..models.transform import (batch_images, device_batch_images, host_batch_images,
                                resize_boxes_back)
from ..ops.masks import paste_masks
from ..parallel.collectives import all_gather, gather_objects
from ..parallel.mesh import axis_group, axis_index, axis_size
from ..utils.profiling import annotate


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
                 with_masks: bool = False, with_match: bool = True,
                 with_aggr_features: bool = True, with_roi_features: bool = False,
                 paste_full_masks: bool = True, mesh=None):
        """Runs on the model's device.  ``ingest``: "device" (raw upload,
        resize on the device; the port's default) or "host" (the JAX
        package's default: a cv2 resize before one upload a canvas bucket).
        The ``with_*`` flags choose the outputs: the masks, the match and
        aggregator descriptors, and the 14x14 RoI features (phase-2
        training keeps them on the device, ``run``).  ``paste_full_masks``:
        with ``with_masks``, paste each detection's 28x28 probabilities at
        the ORIGINAL image size, [D, H_orig, W_orig] f32 (torchvision's
        postprocess); False keeps them [D, 28, 28].  ``mesh``: the chunks
        are sharded over its ``data`` axis, whose size must divide
        ``chunk``; every rank must call ``run`` with the same images."""
        if ingest not in ("host", "device"):
            raise ValueError(f"unknown ingest {ingest!r}: 'host' or 'device'")
        if chunk % axis_size(mesh, "data"):
            raise ValueError(f"chunk ({chunk}) must be a multiple of the mesh 'data' axis size "
                             f"({axis_size(mesh, 'data')}): each rank runs chunk / data images "
                             "of every chunk")
        self.mesh = mesh
        self.model = model
        self.chunk = chunk
        self.ingest = ingest
        self.with_masks = with_masks
        self.paste_full_masks = paste_full_masks
        self.with_match = with_match
        self.with_aggr = with_aggr_features
        self.with_roi = with_roi_features
        self.device = next(model.parameters()).device

    def batches(self, images: List[np.ndarray]):
        """The forward batches.  The host ingest buckets by orientation
        canvas, as the JAX one.  On the device under "pallas_int8" the int8
        pyramid's scales span a forward batch, so images are batched as the
        JAX device ingest batches them, one batch per source geometry.
        Every other backend's outputs are per image, whatever shares the
        batch: there the two orientation canvases fill more of each chunk,
        which matters for a gallery of images of many sizes."""
        if self.ingest == "host":
            batch = host_batch_images
        elif self.model.cfg.roi_heads.roi_align_backend == "pallas_int8":
            batch = device_batch_images
        else:
            batch = batch_images
        with annotate("seam.ingest"):
            return batch(images, self.model.cfg.transform, self.device)

    def _forward(self, pixels: torch.Tensor, sizes: np.ndarray) -> Dict[str, torch.Tensor]:
        with annotate("seam.forward"):
            out = self.model.inference(pixels, torch.as_tensor(sizes, device=self.device),
                                       with_masks=self.with_masks, with_match=self.with_match,
                                       with_roi_features=True)
            roi = out["roi_features"] if self.with_roi else out.pop("roi_features")
            if self.with_aggr:
                b, d = roi.shape[:2]
                out["aggr_features"] = self.model.aggregator_descriptors(
                    roi.reshape((b * d,) + roi.shape[2:])).reshape(b, d, -1)
            return out

    def __call__(self, images: List[np.ndarray]) -> List[Dict[str, np.ndarray]]:
        """images: HWC arrays in [0, 1] (or uint8 under the device ingest).
        Returns one dict per image (input order) of numpy arrays: boxes
        [D, 4] in ORIGINAL image coordinates, scores, labels, valid [D], and
        as the flags ask, masks [D, H_orig, W_orig] (or [D, 28, 28]),
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
        with annotate("seam.call"):
            if device_keys is None:
                device_keys = ("roi_features",) if self.with_roi else ()
            group = axis_group(self.mesh, "data")
            ranks, rank = axis_size(self.mesh, "data"), axis_index(self.mesh, "data")
            results: List[Optional[Dict[str, np.ndarray]]] = [None] * len(images)
            dev: Dict[str, torch.Tensor] = {}
            for bucket in self.batches(images):
                n = bucket.pixels.shape[0]
                plan = (_chunk_plan(n, self.chunk) if group is None
                        else [(s, self.chunk) for s in range(0, n, self.chunk)])
                for s, size in plan:
                    e = min(s + size, n)  # the chunk's images; past them, padding
                    lo, hi = s + rank * size // ranks, s + (rank + 1) * size // ranks
                    pixels, sizes = bucket.pixels[lo:min(hi, n)], bucket.sizes[lo:min(hi, n)]
                    if hi > n:
                        pad = hi - max(lo, n)
                        pixels = torch.cat([pixels, pixels.new_zeros((pad,) + pixels.shape[1:])])
                        sizes = np.concatenate([sizes, np.repeat(bucket.sizes[-1:], pad, 0)])
                    out = self._forward(pixels, sizes)
                    for k in device_keys:
                        if k not in out:
                            raise ValueError(f"run: device key {k!r} is not an output of this "
                                             f"runner ({sorted(out)})")
                        v = out.pop(k)
                        if group is not None:
                            v = all_gather(v, group).flatten(0, 1)[:e - s]
                        if k not in dev:
                            dev[k] = torch.empty((len(images),) + v.shape[1:], dtype=v.dtype,
                                                 device=v.device)
                        dev[k][torch.as_tensor(bucket.indices[s:e], device=v.device)] = v
                    masks = out.pop("masks") if self.paste_full_masks and "masks" in out else None
                    with annotate("seam.readback"):
                        host = {k: v.cpu().numpy() for k, v in out.items()}
                        for j in range(min(hi, n) - lo):
                            i = lo + j
                            r = {k: v[j] for k, v in host.items()}
                            r["boxes"] = resize_boxes_back(r["boxes"], tuple(bucket.sizes[i]),
                                                           tuple(bucket.orig_sizes[i]))
                            if masks is not None:
                                # torchvision's postprocess order: the boxes back to
                                # original coordinates first, then the paste there
                                oh, ow = map(int, bucket.orig_sizes[i])
                                r["masks"] = paste_masks(masks[j], torch.as_tensor(
                                    r["boxes"], device=masks.device), oh, ow).cpu().numpy()
                            results[bucket.indices[i]] = r
            if group is not None:
                for part in gather_objects({i: r for i, r in enumerate(results) if r is not None},
                                           group):
                    for i, r in part.items():
                        results[i] = r
            return results, dev
