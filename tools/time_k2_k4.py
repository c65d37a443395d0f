"""Time kernels K2 (exact RoIAlign) and K4 (pairwise scorer) of a tree of the
PyTorch port on one GPU, so that two trees can be compared in one call.

    python3 tools/time_k2_k4.py [--root DIR] [--tiles] [--trace] [--reps 20]
        [--out build/time_k2_k4.json]

``--root`` names the checkout whose ``seam_match_rcnn_tpu_torch`` is
imported (default: this one); its kernels build under ``DIR/build/``.  On
seeded inputs, each timed as a CUDA-event median after a warm-up:

* K2 ``cuda_roi_align.roi_align`` at the shapes of ``chip_smoke.py``: 11 x
  4000 rois 7x7 and 11 x 100 14x14 (serving), 8 x 512 7x7 and 8 x 128
  14x14 (training), over bf16 channels_last pyramids of 800x1344 canvases;
* K4 ``cuda_kernels.pairwise_scores`` at 1 x 16, 1 x 1000 and 1000 x 1000,
  with ``torch.mm`` of the same operands (the cuBLAS GEMM of the matmul
  expansion) beside it;
* with ``--tiles`` (a tree whose K4 takes its tile rows), K4 at each tile
  at every Q it can take among 1, 16, 64, 100, 300 and 1000 (against 1000
  gallery rows), through the library's entry point (with
  ``--trace``, each with its device time per call from a profiler trace);
* with ``--trace``, at each K4 shape and K2's first: the device time per
  call of each CUDA kernel that a torch.profiler trace of 20 calls shows
  (K4 beside ``torch.mm``), and the host's time to enqueue one call (host
  clock over 200 calls, before the synchronize) of the wrapper, of
  ``torch.mm`` and of ``torch.empty`` of the output, and, with ``--tiles``,
  of the library's entry point called with ready arguments.

Each kernel's output is held against its plain version first.  Prints one
JSON object (with the card's name and power limit) and writes it to
``--out``.  Needs a CUDA device.
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

PYRAMID = ((200, 336), (100, 168), (50, 84), (25, 42))  # P2..P5 of an 800x1344 canvas


def median_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rois_for(rng, b, n, h=800, w=1344):
    """Anchor-like boxes (16..800 px, aspect 1:3..3:1) inside an h x w image."""
    size = np.exp(rng.uniform(np.log(16), np.log(800), (b, n)))
    aspect = np.exp(rng.uniform(np.log(1 / 3), np.log(3), (b, n)))
    bw, bh = size * np.sqrt(aspect), size / np.sqrt(aspect)
    cx, cy = rng.uniform(0, w, (b, n)), rng.uniform(0, h, (b, n))
    boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    boxes[..., 0::2] = boxes[..., 0::2].clip(0, w)
    boxes[..., 1::2] = boxes[..., 1::2].clip(0, h)
    return torch.from_numpy(boxes.astype(np.float32))


def device_us(fn, n: int = 20) -> dict:
    """Device time per call of each CUDA kernel in a profiler trace of n calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / n for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0}


def host_us(fn, n: int = 200) -> float:
    """The host's time to enqueue one call (the device may still be busy)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="build/time_k2_k4.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_k2_k4: no CUDA device")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from seam_match_rcnn_tpu_torch.ops import cuda_kernels, cuda_roi_align, native
    from seam_match_rcnn_tpu_torch.ops.pairwise import pairwise_match_scores
    from seam_match_rcnn_tpu_torch.ops.roi_align import multilevel_roi_align

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {"root": str(Path(args.root).resolve()), "k2": [], "k4": [], "k4_tiles": [],
              "trace": []}

    for b, n, o in ((11, 4000, 7), (11, 100, 14), (8, 512, 7), (8, 128, 14)):
        feats = [torch.randn((b, 256, h, w), generator=gen, device=dev).to(torch.bfloat16)
                 .contiguous(memory_format=torch.channels_last) for h, w in PYRAMID]
        rois = rois_for(rng, b, n).to(dev)
        err = float((cuda_roi_align.roi_align(feats, rois, o).float()
                     - multilevel_roi_align(feats, rois, o).float()).abs().max())
        ms = median_ms(lambda: cuda_roi_align.roi_align(feats, rois, o), args.reps)
        report["k2"].append({"shape": f"{b}x{n} rois {o}x{o} bf16", "ms": ms,
                             "max_abs_err": err})
        if args.trace and not report["trace"]:
            report["trace"].append({"shape": report["k2"][-1]["shape"], "device_us": device_us(
                lambda: cuda_roi_align.roi_align(feats, rois, o), 5)})
        del feats

    w, bias = (torch.from_numpy((rng.randn(2, 256) * 0.05).astype(np.float32)).to(dev),
               torch.from_numpy(rng.randn(2).astype(np.float32)).to(dev))
    gallery = torch.from_numpy(rng.randn(1000, 256).astype(np.float32)).to(dev)
    for q, g in ((1, 16), (1, 1000), (1000, 1000)):
        x = torch.from_numpy(rng.randn(q, 256).astype(np.float32)).to(dev)
        y = gallery[:g].contiguous()
        err = float((cuda_kernels.pairwise_scores(x, y, w, bias)
                     - pairwise_match_scores(x, y, w, bias)).abs().max())
        ms = median_ms(lambda: cuda_kernels.pairwise_scores(x, y, w, bias), 5 * args.reps)
        yt = y.T.contiguous()
        mm = median_ms(lambda: torch.mm(x, yt), 5 * args.reps)
        report["k4"].append({"shape": f"{q}x{g}", "ms": ms, "mm_ms": mm, "max_abs_err": err})
        if args.trace:
            row = {"shape": f"{q}x{g}",
                   "device_us": device_us(lambda: cuda_kernels.pairwise_scores(x, y, w, bias)),
                   "mm_device_us": device_us(lambda: torch.mm(x, yt)),
                   "host_us": host_us(lambda: cuda_kernels.pairwise_scores(x, y, w, bias)),
                   "mm_host_us": host_us(lambda: torch.mm(x, yt)),
                   "empty_host_us": host_us(lambda: torch.empty((q, g), device=dev))}
            if args.tiles:
                lib, out = native.library(), torch.empty((q, g), device=dev)
                ptrs = [native.ptr(t) for t in (x, y, w, bias, out)]
                stream, rows = native.stream(dev), cuda_kernels.pairwise_tile_rows(q)
                row["entry_host_us"] = host_us(
                    lambda: lib.seam_pairwise_scores(*ptrs, q, g, 256, rows, stream))
            report["trace"].append(row)

    if args.tiles:
        lib = native.library()
        for q in (1, 16, 64, 100, 300, 1000):
            x = torch.from_numpy(rng.randn(q, 256).astype(np.float32)).to(dev)
            want = pairwise_match_scores(x, gallery, w, bias)
            row = {"q": q, "g": 1000, "picked": cuda_kernels.pairwise_tile_rows(q)}
            for rows in cuda_kernels.PAIRWISE_TILES:
                if (q + rows - 1) // rows > 65535:
                    continue
                out = torch.empty((q, 1000), device=dev)
                stream = native.stream(dev)

                def call():
                    native.check(lib.seam_pairwise_scores(
                        native.ptr(x), native.ptr(gallery), native.ptr(w), native.ptr(bias),
                        native.ptr(out), q, 1000, 256, rows, stream), "pairwise_scores")

                call()
                torch.cuda.synchronize()
                row[f"err_{rows}"] = float((out - want).abs().max())
                row[f"ms_{rows}"] = median_ms(call, 5 * args.reps)
                if args.trace:
                    row[f"device_us_{rows}"] = sum(device_us(call).values())
            report["k4_tiles"].append(row)

    report["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    line = json.dumps(report)
    print(line)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(line + "\n")


if __name__ == "__main__":
    main()
