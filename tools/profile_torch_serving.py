"""Where the time goes in the PyTorch port's serving path, on one GPU.

    python3 tools/profile_torch_serving.py [--out build/profile_torch_serving.json]

Builds ``serving_model_config()`` at full width with seeded random weights
(as chip_smoke.py does) and measures, after a warm-up:

* stage times of one batch of 11 frames on 800x1344 canvases (the bench
  batch), host clock with a device synchronize after each stage, median of
  5 runs: backbone, proposals (RPN head, top-k, NMS), box branch, detection
  postprocess, 14x14 RoIAlign, match trunk, aggregator trunk;
* one retrieve request (10 frames against a 16-image gallery) under
  ``torch.profiler``: wall time, summed device kernel time (busy share),
  and the device time of the top kernels and of the operators that
  launched them.

Needs a CUDA device; prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import synthetic_image  # noqa: E402
from seam_match_rcnn_tpu_torch.config import serving_model_config  # noqa: E402
from seam_match_rcnn_tpu_torch.models.detection import postprocess_detections  # noqa: E402
from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model  # noqa: E402
from seam_match_rcnn_tpu_torch.serving import SeamRetrieval  # noqa: E402


@torch.no_grad()
def stage_times(model, dev, reps=5):
    rng = np.random.RandomState(0)
    cfg = model.cfg
    images = torch.from_numpy(rng.rand(11, 3, 800, 1344).astype(np.float32)).to(dev)
    sizes = torch.tensor([[800, 1333]] * 11, device=dev)
    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(reps + 1):
        feats = timed("backbone", lambda: model.features(images))
        props, _, pvalid = timed("proposals", lambda: model.proposals(feats, sizes))

        def box_branch():  # the channels_last copy of P2..P5, RoIAlign and the head
            lv = model.roi_levels(feats)
            return lv, model.box_branch(lv, props)

        levels, (logits, deltas) = timed("box_branch", box_branch)
        det = timed("postprocess", lambda: postprocess_detections(
            logits, deltas, props, pvalid, sizes, cfg.roi_heads, fallback_score=0.1))
        roi = timed("roi_align_14x14", lambda: model._roi_align(levels, det.boxes, 14)
                    .to(torch.float32))
        timed("match_trunk", lambda: model.match_descriptors(roi))
        timed("aggregator_trunk", lambda: model.aggregator_descriptors(roi))
        del feats, levels, props, logits, deltas, det, roi
    # the first run is the warm-up
    return {k: statistics.median(v[1:]) for k, v in stages.items()}


def request_profile(retr, dev, top=25):
    rng = np.random.RandomState(1)
    gallery = retr.build_gallery([synthetic_image(rng, 600, 800) for _ in range(16)])
    frames = [synthetic_image(rng, 720, 1280) for _ in range(10)]
    retr.retrieve(frames, gallery, k=5)  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        retr.retrieve(frames, gallery, k=5)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, ops = [], []
    for e in prof.key_averages():
        dev_ms = e.self_device_time_total / 1e3
        if dev_ms <= 0:
            continue
        # device events are the kernels and copies themselves; CPU-side
        # operators report the device time of the kernels they launched
        rows = kernels if e.device_type == torch.autograd.DeviceType.CUDA else ops
        rows.append({"name": e.key[:120], "device_ms": dev_ms, "calls": e.count})
    kernels.sort(key=lambda r: -r["device_ms"])
    ops.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in kernels)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
            "top_kernels": kernels[:top], "top_ops": ops[:top]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/profile_torch_serving.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serving: no CUDA device")
    dev = torch.device("cuda", 0)
    model = init_model(serving_model_config(), video=True, seed=0, device=dev)
    result = {"device": torch.cuda.get_device_name(0),
              "stages_ms_batch11": stage_times(model, dev),
              "retrieve_request": request_profile(SeamRetrieval(model, chunk=11), dev)}
    text = json.dumps(result, indent=1)
    print(text)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
