"""Where the time goes in the PyTorch port's phase-1 training step, on one GPU.

    python3 tools/profile_torch_train.py [--out build/profile_torch_train.json]
        [--stages backbone,rpn,sample,boxbranch,mask,full,opt] [--remat]
        [--adjoint pallas|xla]

Builds the full-width phase-1 configuration of chip_smoke.py (bf16
ResNet-50-FPN with the frozen fused stem, 2000/8000 RPN proposals, 512
sampled RoIs per image, batch 8) with seeded random weights and synthetic
street/shop batches (``chip_smoke.train_batch``), warms up both paths, and
then for a mixed-orientation batch (two canvas buckets) and a
single-orientation batch (one bucket):

* the step time, host clock around ``Phase1Trainer.step`` ending in a
  device synchronize, median of 3 steps;
* one step under ``torch.profiler``: wall time, summed device time of the
  kernels and copies (busy share), the top kernels and the operators that
  launched them, and the device time of the hand-written kernels K1, K2
  and K5.

``--stages`` times instead the cumulative prefixes of the phase-1 pipeline
(``MatchRCNN.profile_losses``, as the JAX package's tools/profile_train.py)
on the single-orientation batch: for each stage the forward alone and a
step (forward, backward, update) in ms, medians of 3; "opt" times the
optimizer's update alone.  ``--remat`` sets ``ModelConfig.remat_backbone``
and ``--adjoint`` ``RoIHeadsConfig.roi_adjoint_backend`` ("pallas" is
kernel K5, "xla" the scatter-add adjoint), in both modes.

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

from chip_smoke import ABLATE_STAGES, dist_draws, stage_rows, train_batch  # noqa: E402
from seam_match_rcnn_tpu_torch.config import (RoIHeadsConfig, TrainConfig,  # noqa: E402
                                              serving_model_config)
from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model  # noqa: E402
from seam_match_rcnn_tpu_torch.train.engine import bucket_batches  # noqa: E402
from seam_match_rcnn_tpu_torch.train.optim import multistep_warmup_schedule, sgd  # noqa: E402
from seam_match_rcnn_tpu_torch.train.steps import Phase1Trainer  # noqa: E402

MIXED = [(600, 800), (720, 1280), (480, 640), (800, 600), (768, 1024), (1280, 720),
         (500, 900), (640, 480)]
SINGLE = [(600, 800), (720, 1280), (480, 640), (768, 1024), (540, 960), (500, 900),
          (640, 960), (450, 800)]
# substrings of the hand-written kernels' names in the profile
HAND_KERNELS = {"K1 fused_stem": "stem_kernel", "K2 roi_align": "roi_align_kernel",
                "K5 roi_align_adjoint": "roi_adjoint_kernel"}


def profile_step(step, top=25):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, ops = [], []
    for e in prof.key_averages():
        dev_ms = e.self_device_time_total / 1e3
        if dev_ms <= 0:
            continue
        rows = kernels if e.device_type == torch.autograd.DeviceType.CUDA else ops
        rows.append({"name": e.key[:120], "device_ms": dev_ms, "calls": e.count})
    kernels.sort(key=lambda r: -r["device_ms"])
    ops.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in kernels)
    hand = {k: sum(r["device_ms"] for r in kernels if sub in r["name"])
            for k, sub in HAND_KERNELS.items()}
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms), "hand_kernels_ms": hand,
            "top_kernels": kernels[:top], "top_ops": ops[:top]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/profile_torch_train.json")
    ap.add_argument("--stages", default=None,
                    help="comma-separated subset of " + ",".join(ABLATE_STAGES) + ",opt")
    ap.add_argument("--remat", action="store_true", help="ModelConfig.remat_backbone")
    ap.add_argument("--adjoint", default="pallas", choices=["pallas", "xla"],
                    help="RoIHeadsConfig.roi_adjoint_backend")
    args = ap.parse_args()
    stages = args.stages.split(",") if args.stages else None
    if stages and set(stages) - set(ABLATE_STAGES + ("opt",)):
        ap.error(f"unknown stages {sorted(set(stages) - set(ABLATE_STAGES + ('opt',)))}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = serving_model_config(roi_heads=RoIHeadsConfig(roi_align_backend="pallas_resident",
                                                        roi_adjoint_backend=args.adjoint),
                               freeze_backbone_stages=True, remat_backbone=args.remat)
    model = init_model(cfg, video=False, seed=0, device=dev)
    tc = TrainConfig()
    trainer = Phase1Trainer(model, sgd(model, multistep_warmup_schedule(
        tc.lr, tc.milestones, tc.gamma, 1000, tc.warmup_iters, tc.warmup_factor)))
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.RandomState(3)
    result = {"device": torch.cuda.get_device_name(0), "remat": args.remat,
              "adjoint": args.adjoint}
    if stages:
        batches = bucket_batches(model, *train_batch(rng, SINGLE), 24, dev)
        draws = [dist_draws(model, batches[0], len(SINGLE), 0)]
        result["stages"] = stage_rows(model, trainer.optimizer, batches, draws, stages)
        for row in result["stages"]:
            print(f"{row['stage']}: " + " ".join(f"{k}={v:.2f}" for k, v in row.items()
                                                 if k != "stage"), flush=True)
        return _write(result, args.out)
    batches = {name: bucket_batches(model, *train_batch(rng, sizes), 24, dev)
               for name, sizes in (("mixed", MIXED), ("single", SINGLE))}
    for b in batches.values():  # warm-up: new shapes, cuDNN plans, allocator growth
        trainer.step(b, gen)
    for name, b in batches.items():
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.step(b, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        result[name] = {"buckets": len(b), "step_ms": times,
                        "step_ms_median": statistics.median(times),
                        "profile": profile_step(lambda: trainer.step(b, gen))}
    return _write(result, args.out)


def _write(result, out) -> int:
    text = json.dumps(result, indent=1)
    print(text)
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    Path(out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
