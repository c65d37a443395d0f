"""Time the PyTorch port's gallery ingest under the runner's two batchings, on one GPU.

    python3 tools/time_torch_gallery.py [--images 33] [--reps 3]
        [--out build/time_torch_gallery.json]

A shop gallery holds images of many sizes.  ``InferenceRunner`` batches
them by orientation canvas (two batches, cut into chunks) under every
RoIAlign backend but "pallas_int8", whose int8 scales span a forward batch:
there it forms one batch per source geometry, as the JAX package's device
ingest does.  This builds the full-width serving model (``serving_model_config()``,
seeded random weights, chunk 11) and a gallery of ``--images`` synthetic
shop images of distinct sizes (480-1024 px a side), then times
``SeamRetrieval.build_gallery`` (host clock around a device synchronize,
median of ``--reps`` after a warm-up):

* under "pallas_resident" with each batching, in the order A B B A, the
  runner's ``batches`` set to one or the other;
* under "pallas_int8" with its own batching.

Prints one JSON object (seconds per build and per image, forwards per build
counted by the stem kernel's launches, the card's name and power limit) and
writes it to ``--out``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import serving_model, synthetic_image  # noqa: E402
from seam_match_rcnn_tpu_torch.models.transform import (batch_images,  # noqa: E402
                                                         device_batch_images)
from seam_match_rcnn_tpu_torch.ops import cuda_stem  # noqa: E402
from seam_match_rcnn_tpu_torch.serving import SeamRetrieval  # noqa: E402

BATCHINGS = {"orientation canvas": batch_images, "source geometry": device_batch_images}


def timed_builds(retr, shops, reps):
    """(median seconds of one build_gallery, forwards per build)."""
    retr.build_gallery(shops)  # warm-up: cuDNN plans of these batch sizes
    times, forwards = [], []
    for _ in range(reps):
        n0 = cuda_stem.fused_stem.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        retr.build_gallery(shops)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        forwards.append(cuda_stem.fused_stem.launches - n0)
    return statistics.median(times), forwards[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", type=int, default=33)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="build/time_torch_gallery.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_gallery: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    rng = np.random.RandomState(4)
    sizes = []
    while len(sizes) < args.images:
        hw = (int(rng.randint(480, 1025)), int(rng.randint(480, 1025)))
        if hw not in sizes:
            sizes.append(hw)
    shops = [synthetic_image(rng, h, w)[0] for h, w in sizes]

    runs = []
    retr = SeamRetrieval(serving_model(dev, "pallas_resident"), chunk=11)
    cfg = retr.model.cfg.transform
    for name in ("orientation canvas", "source geometry", "source geometry",
                 "orientation canvas"):
        batch = BATCHINGS[name]
        retr.runner.batches = lambda images, batch=batch: batch(images, cfg, dev)
        s, forwards = timed_builds(retr, shops, args.reps)
        runs.append({"backend": "pallas_resident", "batching": name, "build_s": s,
                     "s_per_image": s / len(shops), "forwards": forwards})
    del retr
    torch.cuda.empty_cache()
    retr = SeamRetrieval(serving_model(dev, "pallas_int8"), chunk=11)
    s, forwards = timed_builds(retr, shops, args.reps)
    runs.append({"backend": "pallas_int8", "batching": "source geometry (its own)",
                 "build_s": s, "s_per_image": s / len(shops), "forwards": forwards})

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    out = {"card": smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None,
           "images": len(shops), "distinct_sizes": len(set(sizes)), "chunk": 11,
           "reps": args.reps, "runs": runs}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
