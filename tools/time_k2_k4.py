"""Time kernels K1 (fused stem), K2 (exact RoIAlign), K3 (temporal
aggregation), K4 (pairwise scorer), K5 (RoIAlign adjoint), K6 and K7 (window
RoIAlign) of a tree of the PyTorch port on one GPU, so that two trees can be
compared in one call.

    python3 tools/time_k2_k4.py [--root DIR] [--tiles] [--trace] [--reps 20]
        [--only k1,k2,k3,k4,k5,k6,k7] [--out build/time_k2_k4.json]

``--root`` names the checkout whose ``seam_match_rcnn_tpu_torch`` is
imported (default: this one); its kernels build under ``DIR/build/``.  On
seeded inputs, each timed as a CUDA-event median after a warm-up, at the
shapes of ``chip_smoke.py``:

* K1 ``cuda_stem.fused_stem`` at [11, 3, 800, 1344] -> bf16, on bf16 input
  and on the f32 input the model hands it, with cuDNN's conv + relu +
  max_pool2d in bf16 beside it;
* K2 ``cuda_roi_align.roi_align`` at 11 x 4000 rois 7x7 and 11 x 100 14x14
  (serving), 8 x 512 7x7 and 8 x 128 14x14 (training), over bf16
  channels_last pyramids of 800x1344 canvases;
* K6 ``cuda_roi_align.roi_align_patch`` (bf16 at the four shapes, f32 at
  the two serving ones) and K7 ``roi_align_patch_int8`` (the bf16 pyramid
  quantized, bf16 out, at the serving shapes), 6 window-overflowing rois
  planted in each image, with the time of the window geometry as plain
  tensor ops (``roi_align_patch.patch_geometry`` and the casts the first
  wrapper made of it) beside them;
* K4 ``cuda_kernels.pairwise_scores`` at 1 x 16, 1 x 1000 and 1000 x 1000,
  with ``torch.mm`` of the same operands (the cuBLAS GEMM of the matmul
  expansion) beside it;
* K5 ``cuda_roi_align.roi_align_adjoint`` at the training shapes (f32
  cotangents of 8 x 512 rois at 7x7 and 8 x 128 at 14x14 -> the gradient of
  a bf16 pyramid of 800x1344 canvases), with whether two calls give equal
  bytes;
* K3 ``cuda_kernels.nlb_aggregate`` at S = 1 and S = 64 tracks of T = 10
  frames (the serving and eval calls) and at S = 7, T = 32;
* with ``--tiles`` (a tree whose K4 takes its tile rows), K4 at each tile
  at every Q it can take among 1, 16, 64, 100, 300 and 1000 (against 1000
  gallery rows), through the library's entry point (with
  ``--trace``, each with its device time per call from a profiler trace);
* with ``--trace``, at each K1 input, each K3, K4 and K5 shape, K2's first
  shape and each K6/K7 shape: the device time per call of each CUDA kernel that a
  torch.profiler trace shows (so a wrapper's own kernel stands apart from
  the casts or geometry ops it launches), and for K1, K4, K6 and K7 the
  host's time to enqueue one call (host clock over many calls, before the
  synchronize; not for K2); for K4 also that of ``torch.mm`` and of ``torch.empty`` of
  the output, and, with ``--tiles``, of the library's entry point called
  with ready arguments.

Each kernel's output is held against its plain version first (max |error|).
Prints one JSON object (with the card's name and power limit) and writes it
to ``--out``.  Needs a CUDA device.
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
import torch.nn.functional as F

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


def planted(rois):
    """Put 6 elongated rois at the head of each image's rois, which overflow
    the 40x48-cell window of K6 and K7 (``chip_smoke.planted_rois``)."""
    rows = [[x, 40.0, x + 62.0, 230.0] for x in (100.0, 400.0, 700.0, 1000.0)]
    rows += [[40.0, y, 245.0, y + 58.0] for y in (100.0, 500.0)]
    rois = rois.clone()
    rois[:, :len(rows)] = torch.tensor(rows)
    return rois


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


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
    ap.add_argument("--only", default="k1,k2,k3,k4,k5,k6,k7",
                    help="comma-separated kernels to time")
    ap.add_argument("--out", default="build/time_k2_k4.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_k2_k4: no CUDA device")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from seam_match_rcnn_tpu_torch.ops import cuda_kernels, cuda_roi_align, cuda_stem, native
    from seam_match_rcnn_tpu_torch.ops import roi_align_patch as patch
    from seam_match_rcnn_tpu_torch.ops.pairwise import pairwise_match_scores
    from seam_match_rcnn_tpu_torch.ops.roi_align import (multilevel_roi_align,
                                                          multilevel_roi_align_adjoint)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    only = set(args.only.split(","))
    rng = np.random.RandomState(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {"root": str(Path(args.root).resolve()), "k1": [], "k2": [], "k3": [], "k4": [],
              "k4_tiles": [], "k5": [], "k6": [], "k7": [], "trace": []}

    if "k1" in only:
        x = torch.from_numpy(rng.randn(11, 3, 800, 1344).astype(np.float32)).to(dev)
        cw = torch.from_numpy((rng.randn(64, 3, 7, 7) * 0.1).astype(np.float32)).to(dev)
        sc = torch.from_numpy((0.5 + rng.rand(64)).astype(np.float32)).to(dev)
        sh = torch.from_numpy((rng.randn(64) * 0.1).astype(np.float32)).to(dev)
        wb, bias = cuda_stem.fold_stem_weights(cw, sc, sh)
        bias = bias.to(torch.bfloat16)
        for dtype, label in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            xi = x.to(dtype)
            call = lambda: cuda_stem.fused_stem(xi, cw, sc, sh, torch.bfloat16)  # noqa: E731
            xb = x.to(torch.bfloat16)
            cudnn = lambda: F.max_pool2d(F.relu(F.conv2d(xb, wb, bias, 2, 3)), 3, 2, 1)  # noqa
            row = {"shape": f"[11,3,800,1344] {label} -> bf16",
                   "max_abs_err": max_err(call(), cuda_stem.stem_plain(xi, cw, sc, sh,
                                                                       torch.bfloat16)),
                   "ms": median_ms(call, args.reps), "cudnn_ms": median_ms(cudnn, args.reps)}
            report["k1"].append(row)
            if args.trace:
                report["trace"].append({"kernel": "K1", "shape": row["shape"],
                                        "device_us": device_us(call, 5),
                                        "host_us": host_us(call, 20)})
            del xi
        del x, xb

    for b, n, o in ((11, 4000, 7), (11, 100, 14), (8, 512, 7), (8, 128, 14)):
        if "k2" not in only:
            break
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

    for b, n, o in ((11, 4000, 7), (11, 100, 14), (8, 512, 7), (8, 128, 14)):
        if not only & {"k6", "k7"}:
            break
        serving = b == 11
        rois = planted(rois_for(rng, b, n)).to(dev)
        base = [torch.randn((b, 256, h, w), generator=gen, device=dev) for h, w in PYRAMID]
        shapes = [(h, w) for h, w in PYRAMID]

        def geometry():  # what the first K6/K7 wrapper launched before its kernel
            lvl, y0, x0, geom = patch.patch_geometry(rois.reshape(-1, 4), shapes,
                                                     (0.25, 0.125, 0.0625, 0.03125), o)
            return (lvl.to(torch.int32).contiguous(),
                    torch.stack([y0, x0], dim=1).to(torch.int32).contiguous(), geom.contiguous())

        geometry_ms = median_ms(geometry, args.reps)
        cases = []
        if "k6" in only:
            cases += [("k6", dt) for dt in ((torch.bfloat16, torch.float32) if serving
                                            else (torch.bfloat16,))]
        if "k7" in only and serving:
            cases.append(("k7", torch.int8))
        for kind, dtype in cases:
            feats = [f.to(torch.bfloat16 if kind == "k7" else dtype)
                     .contiguous(memory_format=torch.channels_last) for f in base]
            if kind == "k7":
                q, scales = patch.quantize_features_int8(feats)
                call = lambda: cuda_roi_align.roi_align_patch_int8(  # noqa: E731
                    q, scales, rois, o, torch.bfloat16)
                plain = patch.roi_align_patch(q, rois, o, scales=scales,
                                              out_dtype=torch.bfloat16)
                label = "int8 -> bf16"
            else:
                call = lambda: cuda_roi_align.roi_align_patch(feats, rois, o)  # noqa: E731
                plain = patch.roi_align_patch(feats, rois, o)
                label = "bf16" if dtype == torch.bfloat16 else "f32"
            row = {"shape": f"{b}x{n} rois {o}x{o} {label}", "max_abs_err": max_err(call(), plain),
                   "ms": median_ms(call, args.reps), "geometry_ms": geometry_ms}
            del plain
            report[kind].append(row)
            if args.trace:
                report["trace"].append({"kernel": kind.upper(), "shape": row["shape"],
                                        "device_us": device_us(call, 5),
                                        "host_us": host_us(call, 20)})
            del feats
            if kind == "k7":
                del q, scales
        del base

    for b, n, o in ((8, 512, 7), (8, 128, 14)):
        if "k5" not in only:
            break
        rois = rois_for(rng, b, n).to(dev)
        g = torch.randn((b, n, o, o, 256), generator=gen, device=dev)
        call = lambda: cuda_roi_align.roi_align_adjoint(  # noqa: E731
            g, rois, PYRAMID, torch.bfloat16)
        got, again = call(), call()
        err = max(max_err(a.permute(0, 2, 3, 1), w)
                  for a, w in zip(got, multilevel_roi_align_adjoint(g, rois, PYRAMID)))
        row = {"shape": f"{b}x{n} rois {o}x{o} -> bf16 pyramid", "max_abs_err": err,
               "deterministic": all(torch.equal(a, z) for a, z in zip(got, again)),
               "ms": median_ms(call, args.reps)}
        del got, again
        report["k5"].append(row)
        if args.trace:
            report["trace"].append({"kernel": "K5", "shape": row["shape"],
                                    "device_us": device_us(call, 5),
                                    "host_us": host_us(call, 20)})
        del g

    if "k3" in only:
        d = lambda i, o: torch.from_numpy(  # noqa: E731
            (rng.randn(i, o) / np.sqrt(i)).astype(np.float32)).to(dev)
        v = lambda o: torch.from_numpy((rng.randn(o) * 0.1).astype(np.float32)).to(dev)  # noqa
        p = {"theta_w": d(256, 128), "theta_b": v(128), "phi_w": d(256, 128), "phi_b": v(128),
             "g_w": d(256, 128), "g_b": v(128), "wcat": v(256), "wz_w": d(128, 256),
             "wz_b": v(256), "att_w": v(256), "att_b": v(1)}
        for s, t in ((1, 10), (64, 10), (7, 32)):
            mask = torch.from_numpy(np.arange(t)[None] < rng.randint(1, t + 1, (s, 1))).to(dev)
            seqs = torch.from_numpy(rng.randn(s, t, 256).astype(np.float32)).to(dev)
            seqs = seqs * mask[..., None]
            call = lambda: cuda_kernels.nlb_aggregate(seqs, mask, p)  # noqa: E731
            row = {"shape": f"S={s} T={t}", "ms": median_ms(call, 5 * args.reps),
                   "max_abs_err": max_err(call(), cuda_kernels.nlb_aggregate_plain(seqs, mask, p))}
            report["k3"].append(row)
            if args.trace:
                report["trace"].append({"kernel": "K3", "shape": row["shape"],
                                        "device_us": device_us(call), "host_us": host_us(call)})

    w, bias = (torch.from_numpy((rng.randn(2, 256) * 0.05).astype(np.float32)).to(dev),
               torch.from_numpy(rng.randn(2).astype(np.float32)).to(dev))
    gallery = torch.from_numpy(rng.randn(1000, 256).astype(np.float32)).to(dev)
    for q, g in ((1, 16), (1, 1000), (1000, 1000)):
        if "k4" not in only:
            break
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
