"""Smoke run of the PyTorch port on one NVIDIA GPU (built for Hopper, sm_90a).

    python3 chip_smoke.py

Phases, one line each:
  1. build   - compile seam_match_rcnn_tpu_torch/csrc/*.cu with nvcc into
               build/seam_torch_kernels/ (skipped when the source hash is
               unchanged);
  2. kernels - each hand-written kernel against its plain PyTorch version on
               the card at the serving shapes, with the max error against a
               stated tolerance and the median time of each side (CUDA
               events);
  3. slice   - the serving path at full width (ResNet-50-FPN, 4000
               proposals, 800x1344 canvases, chunk 11) with seeded random
               weights: a gallery of 16 synthetic shop images, then
               retrieve(k=5) for 3 query videos of 10 frames.  Launch
               counters are zeroed right before and read right after; every
               kernel must have run.
Then the card's name and power limit, a JSON line of per-kernel results, and
last the JSON line {"ok": true, "device": {...}}.  Any failure exits non-zero
without that line.  There is no CPU fallback.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from seam_match_rcnn_tpu.config import serving_model_config
from seam_match_rcnn_tpu_torch.eval.gallery import score_matrix
from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model
from seam_match_rcnn_tpu_torch.ops import cuda_kernels, cuda_roi_align, cuda_stem, native
from seam_match_rcnn_tpu_torch.ops.pairwise import pairwise_match_scores
from seam_match_rcnn_tpu_torch.ops.roi_align import multilevel_roi_align
from seam_match_rcnn_tpu_torch.serving import SeamRetrieval

KERNELS = {
    "fused_stem": ("seam_match_rcnn_tpu_torch/csrc/stem.cu",
                   "seam_match_rcnn_tpu/ops/pallas_stem.py:123", cuda_stem.fused_stem),
    "roi_align": ("seam_match_rcnn_tpu_torch/csrc/roi_align.cu",
                  "seam_match_rcnn_tpu/ops/pallas_roi_align_resident.py:295",
                  cuda_roi_align.roi_align),
    "nlb_aggregate": ("seam_match_rcnn_tpu_torch/csrc/nlb.cu",
                      "seam_match_rcnn_tpu/ops/pallas_kernels.py:136",
                      cuda_kernels.nlb_aggregate),
    "pairwise_scores": ("seam_match_rcnn_tpu_torch/csrc/pairwise.cu",
                        "seam_match_rcnn_tpu/ops/pallas_kernels.py:56",
                        cuda_kernels.pairwise_scores),
}


def log(msg: str) -> None:
    print(msg, flush=True)


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


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp(min=1e-30))) - 7)


def check_bf16(got, want):
    """Both sides sum in f32 and round to bf16 once: elements may differ by
    one bf16 ulp (a rounding boundary crossed by a different summation
    order), in at most 0.1% of the elements."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= bf16_ulp(want) + 1e-6).all()) and float((err > 0).float().mean()) < 1e-3
    return float(err.max()), "1 bf16 ulp in <0.1% of elements", ok


def check_f32(got, want, tol=1e-5):
    err = (got.float() - want.float()).abs()
    ok = bool((err <= tol + tol * want.float().abs()).all())
    return float(err.max()), f"rtol=atol={tol:g}", ok


def serving_rois(rng, b, n, h=800, w=1344):
    """Anchor-like boxes (16..800 px, aspect 1:3..3:1) inside an h x w image."""
    size = np.exp(rng.uniform(np.log(16), np.log(800), (b, n)))
    aspect = np.exp(rng.uniform(np.log(1 / 3), np.log(3), (b, n)))
    bw, bh = size * np.sqrt(aspect), size / np.sqrt(aspect)
    cx, cy = rng.uniform(0, w, (b, n)), rng.uniform(0, h, (b, n))
    boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    boxes[..., 0::2] = boxes[..., 0::2].clip(0, w)
    boxes[..., 1::2] = boxes[..., 1::2].clip(0, h)
    return torch.from_numpy(boxes.astype(np.float32))


def phase_kernels(dev, results):
    rng = np.random.RandomState(0)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    # K1 at the serving batch: [11, 3, 800, 1344] bf16 -> [11, 64, 200, 336]
    x = t(rng.randn(11, 3, 800, 1344), torch.bfloat16)
    cw, sc = t(rng.randn(64, 3, 7, 7) * 0.1), t(0.5 + rng.rand(64))
    sh = t(rng.randn(64) * 0.1)
    got = cuda_stem.fused_stem(x, cw, sc, sh, torch.bfloat16)
    want = cuda_stem.stem_plain(x, cw, sc, sh, torch.bfloat16)
    err, tol, ok = check_bf16(got, want)
    ms = median_ms(lambda: cuda_stem.fused_stem(x, cw, sc, sh, torch.bfloat16), 10)
    pms = median_ms(lambda: cuda_stem.stem_plain(x, cw, sc, sh, torch.bfloat16), 10)
    results["fused_stem"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, ok=ok, cases=[dict(
        shape="[11,3,800,1344] bf16", max_abs_err=err, tol=tol, ms=ms, plain_ms=pms)])
    del x, got, want

    # K2: box branch 11 x 4000 rois at 7x7 and match branch 11 x 100 at 14x14,
    # over a bf16 channels_last P2..P5 pyramid of an 800x1344 canvas
    feats = [t(rng.randn(11, 256, h, w), torch.bfloat16).contiguous(memory_format=torch.channels_last)
             for h, w in ((200, 336), (100, 168), (50, 84), (25, 42))]
    cases, all_ok, worst = [], True, 0.0
    for n, o, reps in ((4000, 7, 10), (100, 14, 20)):
        rois = serving_rois(rng, 11, n).to(dev)
        got = cuda_roi_align.roi_align(feats, rois, o)
        want = multilevel_roi_align(feats, rois, o)
        err, tol, ok = check_bf16(got, want)
        ms = median_ms(lambda: cuda_roi_align.roi_align(feats, rois, o), reps)
        pms = median_ms(lambda: multilevel_roi_align(feats, rois, o), 3)
        cases.append(dict(shape=f"11x{n} rois {o}x{o} bf16", max_abs_err=err, tol=tol,
                          ms=ms, plain_ms=pms))
        all_ok &= ok
        worst = max(worst, err)
        del got, want
    results["roi_align"] = dict(max_abs_err=worst, ms=cases[0]["ms"],
                                plain_ms=cases[0]["plain_ms"], ok=all_ok, cases=cases)
    del feats

    # K3 at S in {1, 64}, T = 10, with a non-zero W_z
    d = lambda i, o: t(rng.randn(i, o) / np.sqrt(i))
    v = lambda o: t(rng.randn(o) * 0.1)
    p = {"theta_w": d(256, 128), "theta_b": v(128), "phi_w": d(256, 128), "phi_b": v(128),
         "g_w": d(256, 128), "g_b": v(128), "wcat": v(256), "wz_w": d(128, 256),
         "wz_b": v(256), "att_w": v(256), "att_b": v(1)}
    cases, all_ok, worst = [], True, 0.0
    for s in (1, 64):
        mask = torch.from_numpy(np.arange(10)[None] < rng.randint(1, 11, (s, 1))).to(dev)
        seqs = t(rng.randn(s, 10, 256)) * mask[..., None]
        got = cuda_kernels.nlb_aggregate(seqs, mask, p)
        want = cuda_kernels.nlb_aggregate_plain(seqs, mask, p)
        err, tol, ok = check_f32(got, want)
        ms = median_ms(lambda: cuda_kernels.nlb_aggregate(seqs, mask, p), 50)
        pms = median_ms(lambda: cuda_kernels.nlb_aggregate_plain(seqs, mask, p), 50)
        cases.append(dict(shape=f"S={s} T=10", max_abs_err=err, tol=tol, ms=ms, plain_ms=pms))
        all_ok &= ok
        worst = max(worst, err)
    results["nlb_aggregate"] = dict(max_abs_err=worst, ms=cases[0]["ms"],
                                    plain_ms=cases[0]["plain_ms"], ok=all_ok, cases=cases)

    # K4: one query against a gallery, and the N x N frame self-similarity
    cases, all_ok, worst = [], True, 0.0
    w, b = t(rng.randn(2, 256) * 0.05), t(rng.randn(2))
    for q, g in ((1, 1000), (1000, 1000)):
        xq = t(rng.randn(q, 256))
        yg = t(rng.randn(g, 256))
        yg[:q] = xq + 1e-3 * t(rng.randn(q, 256))  # near-duplicate descriptors
        got = cuda_kernels.pairwise_scores(xq, yg, w, b)
        want = pairwise_match_scores(xq, yg, w, b)
        err, tol, ok = check_f32(got, want)
        ms = median_ms(lambda: cuda_kernels.pairwise_scores(xq, yg, w, b), 50)
        pms = median_ms(lambda: pairwise_match_scores(xq, yg, w, b), 50)
        cases.append(dict(shape=f"{q}x{g}", max_abs_err=err, tol=tol, ms=ms, plain_ms=pms))
        all_ok &= ok
        worst = max(worst, err)
    results["pairwise_scores"] = dict(max_abs_err=worst, ms=cases[-1]["ms"],
                                      plain_ms=cases[-1]["plain_ms"], ok=all_ok, cases=cases)

    for name, r in results.items():
        for c in r["cases"]:
            log(f"kernels: {name} {c['shape']}: max_abs_err={c['max_abs_err']:.3g} "
                f"({c['tol']}) kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms")
        if not r["ok"]:
            raise SystemExit(f"kernels: {name} disagrees with its plain version")


def synthetic_image(rng, h, w):
    """A garment-like colored rectangle on noise, HWC float in [0, 1]."""
    img = rng.uniform(0.0, 0.25, (h, w, 3)).astype(np.float32)
    bh, bw = int(h * rng.uniform(0.3, 0.7)), int(w * rng.uniform(0.3, 0.7))
    y, x = rng.randint(0, h - bh), rng.randint(0, w - bw)
    img[y:y + bh, x:x + bw] = rng.uniform(0.3, 1.0, 3) + rng.uniform(-0.05, 0.05, (bh, bw, 3))
    return img.clip(0, 1)


def phase_slice(dev):
    cfg = serving_model_config()
    t0 = time.perf_counter()
    model = init_model(cfg, video=True, seed=0, device=dev)
    gen = torch.Generator().manual_seed(1)
    nlb = model.roi_heads["temporal_aggregator"].newnlb
    with torch.no_grad():  # non-zero W_z, so the NLB is not an identity
        nlb.W.weight.copy_(torch.randn(nlb.W.weight.shape, generator=gen) * 0.05)
        nlb.W.bias.copy_(torch.randn(nlb.W.bias.shape, generator=gen) * 0.05)
    retr = SeamRetrieval(model, chunk=11)
    log(f"slice: model on {dev} in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters())} parameters)")

    rng = np.random.RandomState(1)
    shop_sizes = [(600, 800), (800, 600), (480, 640), (1024, 768), (720, 1280), (900, 700),
                  (500, 500), (640, 480)] * 2
    shops = [synthetic_image(rng, h, w) for h, w in shop_sizes]
    videos = [[synthetic_image(rng, *hw) for _ in range(10)]
              for hw in ((720, 1280), (1280, 720), (540, 960))]

    retr.retrieve(videos[0], retr.build_gallery(shops[:2]), k=1)  # warm-up (cuDNN, lazy init)
    torch.cuda.synchronize()
    for _, _, fn in KERNELS.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    gallery = retr.build_gallery(shops, keys=[f"shop{i}" for i in range(len(shops))])
    torch.cuda.synchronize()
    gallery_s = time.perf_counter() - t0
    latencies, answers = [], []
    for frames in videos:
        t0 = time.perf_counter()
        answers.append(retr.retrieve(frames, gallery, k=5))
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, (_, _, fn) in KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30

    log(f"slice: gallery of {len(gallery.keys)} shop images in {gallery_s * 1e3:.1f} ms; "
        f"retrieve latency per 10-frame request (ms): "
        + ", ".join(f"{x * 1e3:.1f}" for x in latencies)
        + f"; peak memory {peak_gb:.2f} GiB; launches {launches}")
    for i, a in enumerate(answers):
        log(f"slice: query {i}: track of {a.track_length} frames -> top-5 "
            + ", ".join(f"{k}:{s:.4f}" for k, s in zip(a.keys, a.scores)))

    # what came out is right: finite, shaped, sorted, and equal to the plain
    # versions on this run's own data
    if gallery.aggr_feats.shape != (len(gallery.keys), 256) or not np.isfinite(
            gallery.aggr_feats).all() or not np.isfinite(gallery.match_feats).all():
        raise SystemExit("slice: gallery descriptors are not finite [G, 256]")
    for a in answers:
        if len(a.indices) != min(5, len(gallery.keys)) or not np.isfinite(a.scores).all() \
                or np.any(np.diff(a.scores) > 0):
            raise SystemExit("slice: a retrieval answer is not a finite, sorted top-5")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise SystemExit(f"slice: the serving path never launched {missing}")
    # the kernels agree with their plain versions on this run's own data
    # (one more forward of the last video, after the counters were read)
    outs = retr.runner(videos[-1])
    d = cfg.roi_heads.detections_per_img
    for o in outs:
        if o["boxes"].shape != (d, 4) or o["aggr_features"].shape != (d, 256) \
                or not all(np.isfinite(o[k]).all() for k in ("boxes", "scores",
                                                             "match_features", "aggr_features")):
            raise SystemExit(f"slice: per-frame detections are not finite [{d}, ...]")
    aggr = np.concatenate([o["aggr_features"][o["valid"]] for o in outs])[:10]
    seqs = torch.as_tensor(aggr[None], device=dev)
    mask = torch.ones(seqs.shape[:2], dtype=torch.bool, device=dev)
    with torch.no_grad():
        video = model.aggregate_sequences(seqs, mask)
        video_plain = cuda_kernels.nlb_aggregate_plain(
            seqs, mask, model.roi_heads["temporal_aggregator"].nlb_weights())
        scores = score_matrix(video, gallery.aggr_feats, retr._aw, retr._ab, device=dev)
        scores_plain = pairwise_match_scores(
            video_plain, torch.as_tensor(gallery.aggr_feats, device=dev),
            retr._aw, retr._ab).cpu().numpy()
    if not torch.allclose(video, video_plain, rtol=1e-5, atol=1e-5) or not np.allclose(
            scores, scores_plain, rtol=1e-5, atol=1e-5):
        raise SystemExit("slice: the video descriptor or its gallery scores disagree with "
                         "the plain versions")
    log("slice: outputs finite and sorted; video descriptor and gallery scores agree "
        "with the plain versions (rtol=atol=1e-5)")
    return launches, latencies, gallery_s, peak_gb


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible")

    t0 = time.perf_counter()
    lib = native.build()
    log(f"build: {time.perf_counter() - t0:.1f} s ({lib.name})")
    native.library()

    results = {}
    phase_kernels(dev, results)
    launches, latencies, gallery_s, peak_gb = phase_slice(dev)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"],
         "cases": results[name]["cases"]}
        for name, (src, rep, _) in KERNELS.items()],
        "retrieve_ms": [x * 1e3 for x in latencies], "gallery_ms": gallery_s * 1e3,
        "peak_gib": peak_gb}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
