"""Smoke run of the PyTorch port on one NVIDIA GPU (built for Hopper, sm_90a).

    python3 chip_smoke.py

Phases, one line each:
  1. build   - compile seam_match_rcnn_tpu_torch/csrc/*.cu with nvcc, one
               process per source, into build/seam_torch_kernels/ (skipped
               when the source hash is unchanged);
  2. kernels - each hand-written kernel against its plain PyTorch version on
               the card at the shapes the serving and training paths give
               it, with the max error against a stated tolerance, the median
               time of each side (CUDA events), the time of one library call
               computing the same function where PyTorch has one, and the
               least time the card could take (bytes over 3.35 TB/s or
               operations over the peak rate of their type, the larger);
               K1 also on a canvas of mixed-size images from the port's
               batching, with a zero and a drawn FrozenBN shift (its time
               within 1.5x of dense input, and the values it recomputes),
               and K5 called twice on the same inputs (equal bytes);
  3. slice   - the serving path at full width (ResNet-50-FPN, 4000
               proposals, 800x1344 canvases, chunk 11) with seeded random
               weights: a gallery of 16 synthetic shop images, then
               retrieve(k=5) for 3 query videos of 10 frames;
  3b. eval   - both retrieval harnesses (MovingFashion, all 7 strategies:
               8 products of 1 shop image + 10 frames; MultiDF2: 8 products
               of 1 shop + 3 street images) at the same width, once per
               RoIAlign backend: pallas_resident (K2, the control), pallas
               (K6) and pallas_int8 (K7), with per-strategy top-1, seconds
               per product and the descriptor drift against the control;
  4. train   - phase-1 Match R-CNN training at full width (bf16
               ResNet-50-FPN with the fused stem frozen, 2000/8000 RPN
               proposals, 512 sampled RoIs per image, batch 8) through
               train_one_epoch_matchrcnn and Phase1Trainer on synthetic
               street/shop batches: two warm-up steps, then 4 timed steps,
               alternating mixed orientations (the two-bucket path) and a
               single orientation (the fused path); then one step with the
               "pallas" RoIAlign backend (K6 forward, K5 backward);
  5. seam    - phase-2 SEAM training at full width: the video serving model
               (seeded random weights, its aggregator warm-started from the
               match predictor) through train_one_epoch_movingfashion (16
               products x (1 shop + 10 frames), epoch 1) and
               train_one_epoch_multidf2 (8 x (1 + 10)), one warm-up and 3
               timed product batches each: the frozen detector's inference
               (K1, K2) with the RoI features kept on the card, the host
               selection, one head step per batch; inference and head-step
               ms, rows, peak memory, losses; one head step of each redone
               on the CPU and held against the card's update; the MultiDF2
               loop must leave the match predictor bit-equal.
For phases 3, 3b, 4 and 5 the launch counters are zeroed right before each
path and read right after; every kernel of the path must have run (and on
the seam paths K3, K4 and K5 must not).  Then the card's name
and power limit, a JSON line of per-kernel results, and last the JSON line
{"ok": true, "device": {...}}.  Any failure exits non-zero without that
line.  There is no CPU fallback.
"""

from __future__ import annotations

import contextlib
import copy
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import torch.nn.functional as F

from seam_match_rcnn_tpu_torch.ckpt.torch_convert import clone_match_to_aggregator
from seam_match_rcnn_tpu_torch.config import (EvalConfig, RoIHeadsConfig, SEAMTrainConfig,
                                              TrainConfig, TransformConfig,
                                              serving_model_config)
from seam_match_rcnn_tpu_torch.eval import movingfashion, multidf2
from seam_match_rcnn_tpu_torch.eval.gallery import score_matrix
from seam_match_rcnn_tpu_torch.eval.runner import InferenceRunner
from seam_match_rcnn_tpu_torch.models.layers import FrozenBatchNorm2d
from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model
from seam_match_rcnn_tpu_torch.models.transform import batch_images, normalize
from seam_match_rcnn_tpu_torch.ops import cuda_kernels, cuda_roi_align, cuda_stem, native
from seam_match_rcnn_tpu_torch.ops.pairwise import pairwise_match_scores
from seam_match_rcnn_tpu_torch.ops import roi_align_patch as patch
from seam_match_rcnn_tpu_torch.ops.roi_align import (SPATIAL_SCALES, multilevel_roi_align,
                                                      multilevel_roi_align_adjoint)
from seam_match_rcnn_tpu_torch.serving import SeamRetrieval
from seam_match_rcnn_tpu_torch.train.engine import (train_one_epoch_matchrcnn,
                                                     train_one_epoch_movingfashion,
                                                     train_one_epoch_multidf2)
from seam_match_rcnn_tpu_torch.train.optim import SGD, multistep_warmup_schedule, sgd
from seam_match_rcnn_tpu_torch.train.seam import (compare_head_updates, make_mdf2_head_step,
                                                  make_seam_head_step)
from seam_match_rcnn_tpu_torch.train.steps import Phase1Trainer

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
    "roi_align_adjoint": ("seam_match_rcnn_tpu_torch/csrc/roi_adjoint.cu",
                          "seam_match_rcnn_tpu/ops/pallas_roi_adjoint.py:254",
                          cuda_roi_align.roi_align_adjoint),
    "roi_align_patch": ("seam_match_rcnn_tpu_torch/csrc/roi_align_patch.cu",
                        "seam_match_rcnn_tpu/ops/pallas_roi_align.py:387",
                        cuda_roi_align.roi_align_patch),
    "roi_align_patch_int8": ("seam_match_rcnn_tpu_torch/csrc/roi_align_patch.cu",
                             "seam_match_rcnn_tpu/ops/pallas_roi_align.py:387",
                             cuda_roi_align.roi_align_patch_int8),
}
SERVING_PATH = ("fused_stem", "roi_align", "nlb_aggregate", "pairwise_scores")
TRAIN_PATH = ("fused_stem", "roi_align", "roi_align_adjoint")
EVAL_ROI_KERNEL = {"pallas_resident": "roi_align", "pallas": "roi_align_patch",
                   "pallas_int8": "roi_align_patch_int8"}
EVAL_PATH = ("fused_stem", "nlb_aggregate", "pairwise_scores")
TRAIN_PALLAS_PATH = ("fused_stem", "roi_align_patch", "roi_align_adjoint")
SEAM_PATH = ("fused_stem", "roi_align")  # the frozen detector's inference
SEAM_IDLE = ("nlb_aggregate", "pairwise_scores", "roi_align_adjoint")  # no K3, K4, K5 there

# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
PYRAMID = ((200, 336), (100, 168), (50, 84), (25, 42))  # P2..P5 of an 800x1344 canvas


def bound(nbytes: float, ops: float, op_type: str):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate and
    the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def planted_rois(rois):
    """Put 6 elongated rois at the head of each image's rois: slivers at
    the top of P2's level band, 47-51 cells long there, which overflow the
    40x48-cell window of kernels K6 and K7."""
    planted = [[x, 40.0, x + 62.0, 230.0] for x in (100.0, 400.0, 700.0, 1000.0)]
    planted += [[40.0, y, 245.0, y + 58.0] for y in (100.0, 500.0)]
    rois = rois.clone()
    rois[:, :len(planted)] = torch.tensor(planted)
    return rois


def patch_work(rois, o):
    """The work of the patch-window RoIAlign on these [B, R, 4] rois, per
    channel: (multiply-adds, the (y tap, x tap) pairs with weight in each
    output bin; the distinct (image, level, row, column) cells that carry
    a non-zero tap, which is all of the pyramid that it must read)."""
    b, r = rois.shape[:2]
    dev = rois.device
    lvl, y0, x0, g = patch.patch_geometry(rois.reshape(-1, 4), PYRAMID, SPATIAL_SCALES, o)
    wy = patch.interp_matrix(g[:, 0], g[:, 2], g[:, 4], g[:, 5], o, 2, patch.PATCH) != 0
    wx = patch.interp_matrix(g[:, 1], g[:, 3], g[:, 6], g[:, 7], o, 2, patch.PATCH_W) != 0
    ny, nx = wy.sum(dim=(1, 2)).double(), wx.sum(dim=(1, 2)).double()
    # window cell (i, j) is level cell (y0 + i, x0 + j) and carries a tap
    # when some bin's y taps hold row i and some bin's x taps column j
    img = torch.arange(b, device=dev).repeat_interleave(r)
    cells = 0
    for level, (h, w) in enumerate(PYRAMID):
        at = lvl == level
        rows = torch.zeros((int(at.sum()), h + 1 + patch.PATCH), device=dev)
        rows.scatter_(1, y0[at, None] + 1 + torch.arange(patch.PATCH, device=dev),
                      wy[at].any(1).float())
        cols = torch.zeros((int(at.sum()), w + 1 + patch.PATCH_W), device=dev)
        cols.scatter_(1, x0[at, None] + 1 + torch.arange(patch.PATCH_W, device=dev),
                      wx[at].any(1).float())
        rows, cols = rows[:, 1:h + 1], cols[:, 1:w + 1]
        for i in range(b):
            mine = img[at] == i
            cells += int(((rows[mine].T @ cols[mine]) > 0).sum())
    return float((ny * nx).sum()), cells


def exact_cells(rois, o):
    """The distinct (image, level, row, column) cells that carry a non-zero
    bilinear weight of the exact RoIAlign on these [B, R, 4] rois: where the
    plain adjoint of a cotangent of ones is non-zero (the weights are >= 0)."""
    ones = torch.ones(tuple(rois.shape[:2]) + (o, o, 1), device=rois.device)
    return sum(int((g != 0).sum()) for g in multilevel_roi_align_adjoint(ones, rois, PYRAMID))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def stem_recomputes(x, cw, sc, sh):
    """How many conv values K1 recomputes on these inputs, by its own rule
    (``csrc/stem.cu``, tile and exponent from ``cuda_stem.stem_tile``)
    applied to the plain conv's f32 sums: per tile of tph x tpw pooled
    outputs, each of the tile's (2 tph + 1) x (2 tpw + 1) conv positions
    inside the conv output (a position in two tiles' halos counts for each)
    whose |sum + shift| < 2^e x max |x| of the tile's (4 tph + 7) x (4 tpw +
    7) x 3 input patch x sum |w| of its channel, and whose sum is not
    exactly 0."""
    tph, tpw, e = cuda_stem.stem_tile()
    ch, cw_, ih, iw = 2 * tph + 1, 2 * tpw + 1, 4 * tph + 7, 4 * tpw + 7
    wb, bias = cuda_stem.fold_stem_weights(cw, sc, sh)
    w = wb.float()
    w1 = w.abs().sum(dim=(1, 2, 3))
    h, wd = x.shape[2:]
    ty, tx = -(-h // (4 * tph)), -(-wd // (4 * tpw))
    count = 0
    for i in range(x.shape[0]):
        xb = x[i:i + 1].to(torch.bfloat16).float()
        a = F.conv2d(xb, w, stride=2, padding=3)
        u = torch.where(a == 0, torch.inf, (a + bias[None, :, None, None]).abs())
        # tile (ty, tx)'s patch: input rows 4 tph ty - 5 .. + ih - 1, columns
        # 4 tpw tx - 5 .. + iw - 1
        ax = F.pad(xb.abs().amax(dim=1, keepdim=True),
                   (5, 4 * tpw * tx + 2 - wd, 5, 4 * tph * ty + 2 - h))
        lim = F.max_pool2d(ax, (ih, iw), (4 * tph, 4 * tpw)) * 2.0 ** e * w1[None, :, None, None]
        # its conv positions: rows 2 tph ty - 1 .. + 2 tph - 1, columns
        # 2 tpw tx - 1 .. + 2 tpw - 1
        u = F.pad(u, (1, 2 * tpw * tx - u.shape[3], 1, 2 * tph * ty - u.shape[2]),
                  value=float("inf"))
        u = F.unfold(u, (ch, cw_), stride=(2 * tph, 2 * tpw)).view(64, ch * cw_, ty * tx)
        count += int((u < lim.reshape(64, 1, ty * tx)).sum())
    return count


def stem_canvas_cases(dev, rng, cw, sc, dense_ms):
    """K1 on real canvases: 11 images of mixed sizes placed by the port's own
    batching (``models/transform.batch_images``) on one 800x1344 canvas and
    normalized, so that the padding at the canvas's edges is 0; once with a
    zero FrozenBN shift (as a random-weight model has) and once with a drawn
    one.  Each case holds K1 against its plain version, and fails when K1
    takes more than 1.5x its time on dense input of the same shape
    (``dense_ms``): a recompute list that overflows over the padding shows
    as time (an earlier K1 took 2.5 ms on such canvases against 0.9)."""
    cfg = TransformConfig()
    sizes = [(600, 800), (720, 1280), (480, 640), (768, 1024), (540, 960), (500, 900),
             (640, 960), (450, 800), (375, 500), (600, 1000), (427, 640)]
    (batch,) = batch_images([synthetic_image(rng, h, w)[0] for h, w in sizes], cfg, dev)
    x = normalize(batch.pixels, cfg)
    padding = float((x == 0).all(dim=1).float().mean())
    cases, all_ok = [], True
    for label, sh in (("zero shift", torch.zeros(64, device=dev)),
                      ("drawn shift", torch.from_numpy(rng.randn(64).astype(np.float32) * 0.1)
                       .to(dev))):
        got = cuda_stem.fused_stem(x, cw, sc, sh, torch.bfloat16)
        err, tol, ok = check_bf16(got, cuda_stem.stem_plain(x, cw, sc, sh, torch.bfloat16))
        ms = median_ms(lambda: cuda_stem.fused_stem(x, cw, sc, sh, torch.bfloat16), 10)
        redo = stem_recomputes(x, cw, sc, sh)
        fast = ms <= 1.5 * dense_ms
        cases.append(dict(shape=f"[11,3,800,1344] canvas f32, {label} -> bf16", max_abs_err=err,
                          tol=tol, ms=ms, dense_ms=dense_ms, recomputed=redo,
                          padding_share=padding, ok=ok and fast))
        values = x.shape[0] * 64 * x[0, 0].numel() // 4  # conv outputs
        log(f"k1 canvas: {label}: {redo} conv values recomputed (of {values}), "
            f"{padding:.3f} of the canvas is padding; kernel {ms:.4f} ms against {dense_ms:.4f} "
            f"ms on dense input (limit 1.5x); max_abs_err={err:.3g} ({tol})")
        all_ok &= ok and fast
    return cases, all_ok


def check_adjoint(got, want, mass, dtype):
    """K5 and its plain version add the same f32 summands in another order
    (the kernel's is fixed: each cell summed by one thread, roi by roi):
    |error| <= 1e-5 x the sum of |summands| (the adjoint of |g|), plus one
    bf16 ulp for the final rounding of a bf16 gradient."""
    err, ok = 0.0, True
    for a, w, m in zip(got, want, mass):
        a = a.permute(0, 2, 3, 1).float()
        d = (a - w).abs()
        tol = 1e-5 * m + 1e-7
        if dtype == torch.bfloat16:
            tol = tol + bf16_ulp(w)
        ok &= bool((d <= tol).all())
        err = max(err, float(d.max()))
    return err, "1e-5 x sum|summands| (+1 bf16 ulp)", ok


def phase_kernels(dev, results):
    rng = np.random.RandomState(0)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    # K1 at the serving batch: [11, 3, 800, 1344] -> [11, 64, 200, 336] bf16,
    # on bf16 input and on the f32 input the model hands it (the kernel
    # rounds it as it loads it); cuDNN's conv + relu + max_pool2d in bf16 (of
    # the input cast to bf16) is the library yardstick
    x32 = t(rng.randn(11, 3, 800, 1344))
    cw, sc = t(rng.randn(64, 3, 7, 7) * 0.1), t(0.5 + rng.rand(64))
    sh = t(rng.randn(64) * 0.1)
    wb, bias = cuda_stem.fold_stem_weights(cw, sc, sh)
    bias = bias.to(torch.bfloat16)
    cases, all_ok = [], True
    for dtype, label in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        x = x32.to(dtype)
        got = cuda_stem.fused_stem(x, cw, sc, sh, torch.bfloat16)
        want = cuda_stem.stem_plain(x, cw, sc, sh, torch.bfloat16)
        err, tol, ok = check_bf16(got, want)
        ms = median_ms(lambda: cuda_stem.fused_stem(x, cw, sc, sh, torch.bfloat16), 10)
        pms = median_ms(lambda: cuda_stem.stem_plain(x, cw, sc, sh, torch.bfloat16), 10)
        lms = median_ms(lambda: F.max_pool2d(F.relu(F.conv2d(x.to(torch.bfloat16), wb, bias, 2,
                                                             3)), 3, 2, 1), 10)
        b_ms, b_by = bound(nbytes(x, wb, got) + 64 * 4, 2 * 11 * 400 * 672 * 64 * 147, "bf16")
        cases.append(dict(shape=f"[11,3,800,1344] {label} -> bf16", max_abs_err=err, tol=tol,
                          ms=ms, plain_ms=pms, library_ms=lms, bound_ms=b_ms, bound_by=b_by))
        all_ok &= ok
        del x, got, want
    del x32
    canvas, canvas_ok = stem_canvas_cases(dev, rng, cw, sc, cases[1]["ms"])
    results["fused_stem"] = dict(max_abs_err=max(c["max_abs_err"] for c in cases + canvas),
                                 ms=cases[0]["ms"], plain_ms=cases[0]["plain_ms"],
                                 ok=all_ok and canvas_ok, bound_ms=cases[0]["bound_ms"],
                                 bound_by=cases[0]["bound_by"],
                                 library_ms=cases[0]["library_ms"], cases=cases,
                                 canvas_cases=canvas)

    # K2: serving box branch 11 x 4000 rois at 7x7 and match branch 11 x 100
    # at 14x14; training box branch 8 x 512 at 7x7 and mask branch 8 x 128 at
    # 14x14; over bf16 channels_last P2..P5 pyramids of 800x1344 canvases
    cases, all_ok, worst = [], True, 0.0
    gen = torch.Generator(device=dev).manual_seed(0)
    for b, n, o, reps in ((11, 4000, 7, 10), (11, 100, 14, 20), (8, 512, 7, 10),
                          (8, 128, 14, 20)):
        feats = [torch.randn((b, 256, h, w), generator=gen, device=dev).to(torch.bfloat16)
                 .contiguous(memory_format=torch.channels_last) for h, w in PYRAMID]
        rois = serving_rois(rng, b, n).to(dev)
        got = cuda_roi_align.roi_align(feats, rois, o)
        want = multilevel_roi_align(feats, rois, o)
        err, tol, ok = check_bf16(got, want)
        ms = median_ms(lambda: cuda_roi_align.roi_align(feats, rois, o), reps)
        pms = median_ms(lambda: multilevel_roi_align(feats, rois, o), 3)
        # the cells with a weight, once; 4 corners x ratio^2 samples, a
        # multiply and an add each, per output
        b_ms, b_by = bound(exact_cells(rois, o) * 256 * 2 + nbytes(rois, got),
                           got.numel() * 4 * 4 * 2, "f32")
        cases.append(dict(shape=f"{b}x{n} rois {o}x{o} bf16", max_abs_err=err, tol=tol,
                          ms=ms, plain_ms=pms, library_ms=None, bound_ms=b_ms,
                          bound_by=b_by))
        all_ok &= ok
        worst = max(worst, err)
        del got, want, feats
    results["roi_align"] = dict(max_abs_err=worst, ms=cases[0]["ms"],
                                plain_ms=cases[0]["plain_ms"], ok=all_ok,
                                bound_ms=cases[0]["bound_ms"], bound_by=cases[0]["bound_by"],
                                library_ms=None, cases=cases)

    # K5 at the training shapes: f32 cotangents of 8 x 512 rois at 7x7 and
    # 8 x 128 at 14x14 -> the gradient of an 8-image bf16 pyramid; two calls
    # on the same inputs must give the same bytes
    cases, all_ok, worst, deterministic = [], True, 0.0, True
    for b, n, o, reps in ((8, 512, 7, 10), (8, 128, 14, 10)):
        rois = serving_rois(rng, b, n).to(dev)
        g = torch.randn((b, n, o, o, 256), generator=gen, device=dev)
        got = cuda_roi_align.roi_align_adjoint(g, rois, PYRAMID, torch.bfloat16)
        again = cuda_roi_align.roi_align_adjoint(g, rois, PYRAMID, torch.bfloat16)
        same = all(torch.equal(a.view(torch.int16), z.view(torch.int16))
                   for a, z in zip(got, again))
        deterministic &= same
        del again
        want = multilevel_roi_align_adjoint(g, rois, PYRAMID)
        mass = multilevel_roi_align_adjoint(g.abs(), rois, PYRAMID)
        err, tol, ok = check_adjoint(got, want, mass, torch.bfloat16)
        ok &= same
        del want, mass
        ms = median_ms(lambda: cuda_roi_align.roi_align_adjoint(g, rois, PYRAMID,
                                                                torch.bfloat16), reps)
        pms = median_ms(lambda: multilevel_roi_align_adjoint(g, rois, PYRAMID), 3)
        # every sample adds to 4 corners: a multiply and an add each
        ops = b * n * (o * 2) ** 2 * 256 * 4 * 2
        b_ms, b_by = bound(nbytes(g, rois, *got), ops, "f32")
        cases.append(dict(shape=f"{b}x{n} rois {o}x{o} -> bf16 pyramid", max_abs_err=err,
                          tol=tol, ms=ms, plain_ms=pms, library_ms=None, bound_ms=b_ms,
                          bound_by=b_by, deterministic=same))
        all_ok &= ok
        worst = max(worst, err)
        del got, g
    results["roi_align_adjoint"] = dict(
        max_abs_err=worst, ms=cases[0]["ms"], plain_ms=cases[0]["plain_ms"], ok=all_ok,
        bound_ms=cases[0]["bound_ms"], bound_by=cases[0]["bound_by"], library_ms=None,
        cases=cases, deterministic=deterministic)
    log(f"kernels: roi_align_adjoint deterministic={deterministic} (two calls, equal bytes)")
    if not deterministic:
        raise SystemExit("kernels: roi_align_adjoint gave different bytes on the same inputs")

    phase_kernels_patch(dev, rng, gen, results)

    # K3 at S in {1, 64}, T = 10, and S = 7, T = 32 with a track that has no
    # valid frame, with a non-zero W_z
    d = lambda i, o: t(rng.randn(i, o) / np.sqrt(i))
    v = lambda o: t(rng.randn(o) * 0.1)
    p = {"theta_w": d(256, 128), "theta_b": v(128), "phi_w": d(256, 128), "phi_b": v(128),
         "g_w": d(256, 128), "g_b": v(128), "wcat": v(256), "wz_w": d(128, 256),
         "wz_b": v(256), "att_w": v(256), "att_b": v(1)}
    cases, all_ok, worst = [], True, 0.0
    for s, tt in ((1, 10), (64, 10), (7, 32)):
        lengths = rng.randint(1, tt + 1, (s, 1))
        if s == 7:
            lengths[0] = 0  # a track with no valid frame
        mask = torch.from_numpy(np.arange(tt)[None] < lengths).to(dev)
        seqs = t(rng.randn(s, tt, 256)) * mask[..., None]
        got = cuda_kernels.nlb_aggregate(seqs, mask, p)
        want = cuda_kernels.nlb_aggregate_plain(seqs, mask, p)
        err, tol, ok = check_f32(got, want)
        ms = median_ms(lambda: cuda_kernels.nlb_aggregate(seqs, mask, p), 50)
        pms = median_ms(lambda: cuda_kernels.nlb_aggregate_plain(seqs, mask, p), 50)
        ops = s * (3 * 2 * tt * 256 * 128 + 2 * tt * tt * 128 + 2 * tt * 128 * 256
                   + 4 * tt * 256 + 2 * 2 * tt * 128)
        b_ms, b_by = bound(nbytes(seqs, mask, got, *p.values()), ops, "f32")
        cases.append(dict(shape=f"S={s} T={tt}", max_abs_err=err, tol=tol, ms=ms, plain_ms=pms,
                          library_ms=None, bound_ms=b_ms, bound_by=b_by))
        all_ok &= ok
        worst = max(worst, err)
    results["nlb_aggregate"] = dict(max_abs_err=worst, ms=cases[0]["ms"],
                                    plain_ms=cases[0]["plain_ms"], ok=all_ok,
                                    bound_ms=cases[0]["bound_ms"],
                                    bound_by=cases[0]["bound_by"], library_ms=None,
                                    cases=cases)

    # K4: one query against the smoke gallery (16 shop images) and against a
    # gallery of 1000, and the N x N frame self-similarity; the library
    # yardstick is the cuBLAS GEMM of the matmul expansion
    cases, all_ok, worst = [], True, 0.0
    w, b = t(rng.randn(2, 256) * 0.05), t(rng.randn(2))
    for q, g in ((1, 16), (1, 1000), (1000, 1000)):
        xq = t(rng.randn(q, 256))
        yg = t(rng.randn(g, 256))
        yg[:q] = xq + 1e-3 * t(rng.randn(q, 256))  # near-duplicate descriptors
        got = cuda_kernels.pairwise_scores(xq, yg, w, b)
        want = pairwise_match_scores(xq, yg, w, b)
        err, tol, ok = check_f32(got, want)
        ms = median_ms(lambda: cuda_kernels.pairwise_scores(xq, yg, w, b), 50)
        pms = median_ms(lambda: pairwise_match_scores(xq, yg, w, b), 50)
        yt = yg.T.contiguous()
        lms = median_ms(lambda: torch.mm(xq, yt), 50)
        b_ms, b_by = bound(nbytes(xq, yg, w, b, got), 2 * q * g * 256, "f32")
        cases.append(dict(shape=f"{q}x{g}", max_abs_err=err, tol=tol, ms=ms, plain_ms=pms,
                          library_ms=lms, bound_ms=b_ms, bound_by=b_by))
        all_ok &= ok
        worst = max(worst, err)
    results["pairwise_scores"] = dict(max_abs_err=worst, ms=cases[-1]["ms"],
                                      plain_ms=cases[-1]["plain_ms"], ok=all_ok,
                                      bound_ms=cases[-1]["bound_ms"],
                                      bound_by=cases[-1]["bound_by"],
                                      library_ms=cases[-1]["library_ms"], cases=cases)

    for name, r in results.items():
        for c in r["cases"]:
            lib = "none" if c["library_ms"] is None else f"{c['library_ms']:.4f} ms"
            quant = (f", plain int8 quantization of the pyramid {c['quantize_ms']:.4f} ms"
                     if "quantize_ms" in c else "")
            log(f"kernels: {name} {c['shape']}: max_abs_err={c['max_abs_err']:.3g} "
                f"({c['tol']}) kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
                f"library {lib}, bound {c['bound_ms']:.4f} ms{quant}")
        if not r["ok"]:
            raise SystemExit(f"kernels: {name} disagrees with its plain version")


def phase_kernels_patch(dev, rng, gen, results):
    """K6 (bf16 and f32 features) and K7 (the bf16 pyramid quantized to
    int8, bf16 out) at K2's serving shapes, and K6 (bf16) at the training
    shapes of the "pallas" step, 6 window-overflowing rois planted in each
    image; the plain int8 quantization is timed beside K7.  The kernels
    compute the window geometry themselves from the rois, so their times
    include it.  Bytes count the cells with a tap, the rois, the scales and
    the output."""
    k6, k7 = [], []
    for b, n, o, reps, serving in ((11, 4000, 7, 10, True), (11, 100, 14, 20, True),
                                   (8, 512, 7, 10, False), (8, 128, 14, 20, False)):
        rois = planted_rois(serving_rois(rng, b, n)).to(dev)
        clamped = int(patch.footprint_clamp_mask(rois, PYRAMID, output_size=o).sum())
        taps, cells = patch_work(rois, o)
        taps *= 256
        small = nbytes(rois)
        base = [torch.randn((b, 256, h, w), generator=gen, device=dev) for h, w in PYRAMID]
        dtypes = (((torch.bfloat16, "bf16"), (torch.float32, "f32")) if serving
                  else ((torch.bfloat16, "bf16"),))
        for dtype, op_type in dtypes:
            feats = [f.to(dtype).contiguous(memory_format=torch.channels_last) for f in base]
            got = cuda_roi_align.roi_align_patch(feats, rois, o)
            want = patch.roi_align_patch(feats, rois, o)
            err, tol, ok = (check_bf16 if dtype == torch.bfloat16 else check_f32)(got, want)
            ms = median_ms(lambda: cuda_roi_align.roi_align_patch(feats, rois, o), reps)
            pms = median_ms(lambda: patch.roi_align_patch(feats, rois, o), 3)
            b_ms, b_by = bound(cells * 256 * got.element_size() + small + nbytes(got),
                               2 * taps, op_type)
            k6.append(dict(shape=f"{b}x{n} rois {o}x{o} {op_type} ({clamped} clamped)",
                           max_abs_err=err, tol=tol, ok=ok, ms=ms, plain_ms=pms,
                           library_ms=None, bound_ms=b_ms, bound_by=b_by))
            del got, want, feats
        if not serving:
            del base
            continue
        feats = [f.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
                 for f in base]
        del base
        q, scales = patch.quantize_features_int8(feats)
        qms = median_ms(lambda: patch.quantize_features_int8(feats), 5)
        got = cuda_roi_align.roi_align_patch_int8(q, scales, rois, o, torch.bfloat16)
        want = patch.roi_align_patch(q, rois, o, scales=scales, out_dtype=torch.bfloat16)
        # exact integer sums and the same f32 dequantization on both sides
        err = float((got.float() - want.float()).abs().max())
        ok = torch.equal(got, want)
        ms = median_ms(lambda: cuda_roi_align.roi_align_patch_int8(q, scales, rois, o,
                                                                   torch.bfloat16), reps)
        pms = median_ms(lambda: patch.roi_align_patch(q, rois, o, scales=scales,
                                                      out_dtype=torch.bfloat16), 3)
        b_ms, b_by = bound(cells * 256 + small + nbytes(scales, got), 2 * taps, "int8")
        k7.append(dict(shape=f"{b}x{n} rois {o}x{o} int8 -> bf16 ({clamped} clamped)",
                       max_abs_err=err, tol="0 (bit-equal)", ok=ok, ms=ms, plain_ms=pms,
                       library_ms=None, bound_ms=b_ms, bound_by=b_by, quantize_ms=qms))
        del got, want, feats, q
    for name, cases in (("roi_align_patch", k6), ("roi_align_patch_int8", k7)):
        results[name] = dict(max_abs_err=max(c["max_abs_err"] for c in cases),
                             ms=cases[0]["ms"], plain_ms=cases[0]["plain_ms"],
                             ok=all(c.pop("ok") for c in cases),
                             bound_ms=cases[0]["bound_ms"], bound_by=cases[0]["bound_by"],
                             library_ms=None, cases=cases)
    torch.cuda.empty_cache()


def synthetic_image(rng, h, w, color=None):
    """A garment-like rectangle of ``color`` (random when None) on noise:
    the HWC float image in [0, 1] and the rectangle's xyxy box."""
    img = rng.uniform(0.0, 0.25, (h, w, 3)).astype(np.float32)
    bh, bw = int(h * rng.uniform(0.3, 0.7)), int(w * rng.uniform(0.3, 0.7))
    y, x = rng.randint(0, h - bh), rng.randint(0, w - bw)
    if color is None:
        color = rng.uniform(0.3, 1.0, 3)
    img[y:y + bh, x:x + bw] = np.clip(color + rng.uniform(-0.05, 0.05, (bh, bw, 3)), 0, 1)
    return img, np.asarray([x, y, x + bw, y + bh], np.float32)


def serving_model(dev, roi_align_backend="pallas_resident"):
    """The full-width serving model with seeded random weights and a
    non-zero W_z, so that the NLB is not an identity."""
    cfg = serving_model_config(roi_heads=RoIHeadsConfig(roi_align_backend=roi_align_backend))
    model = init_model(cfg, video=True, seed=0, device=dev)
    gen = torch.Generator().manual_seed(1)
    nlb = model.roi_heads["temporal_aggregator"].newnlb
    with torch.no_grad():
        nlb.W.weight.copy_(torch.randn(nlb.W.weight.shape, generator=gen) * 0.05)
        nlb.W.bias.copy_(torch.randn(nlb.W.bias.shape, generator=gen) * 0.05)
    return model


def phase_slice(dev):
    t0 = time.perf_counter()
    model = serving_model(dev)
    cfg = model.cfg
    retr = SeamRetrieval(model, chunk=11)
    log(f"slice: model on {dev} in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters())} parameters)")

    rng = np.random.RandomState(1)
    shop_sizes = [(600, 800), (800, 600), (480, 640), (1024, 768), (720, 1280), (900, 700),
                  (500, 500), (640, 480)] * 2
    shops = [synthetic_image(rng, h, w)[0] for h, w in shop_sizes]
    videos = [[synthetic_image(rng, *hw)[0] for _ in range(10)]
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
    missing = [name for name in SERVING_PATH if launches[name] == 0]
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


def eval_sets(rng, n=8):
    """In-memory MovingFashion products (1 shop image + 10 frames of a
    720x1280 video, the garment's box per frame as the GT tracklet) and
    MultiDF2 products (1 shop + 3 street images with each image's GT box)."""
    shop_sizes = [(600, 800), (800, 600), (1024, 768), (640, 480)]
    mf, mdf2 = [], []
    for p in range(n):
        color = rng.uniform(0.3, 1.0, 3)
        shop, _ = synthetic_image(rng, *shop_sizes[p % 4], color)
        frames = [synthetic_image(rng, 720, 1280, color) for _ in range(10)]
        mf.append({"images": [shop] + [im for im, _ in frames],
                   "tracklet_gt": np.stack([box for _, box in frames]),
                   "source": 1 if p % 2 else 0, "key": f"product{p}"})
        shots = [synthetic_image(rng, *shop_sizes[(p + 1) % 4], color)] + [
            synthetic_image(rng, *hw, color) for hw in ((720, 1280), (1280, 720), (720, 1280))]
        mdf2.append({"images": [im for im, _ in shots],
                     "targets": [{"boxes": box[None], "styles": np.asarray([1]),
                                  "pair_ids": np.asarray([p])} for _, box in shots],
                     "key": f"1_{p}"})
    return mf, mdf2


def descriptor_drift(control, other):
    """The backend-drift probe of tools/validate_int8.py on the same images:
    |difference| of the match and aggregator descriptors of the detections
    both backends make (valid boxes paired at IoU >= 0.9)."""
    xywh = lambda b: np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]], 1)  # noqa: E731
    diffs, total = [], 0
    for a, b in zip(control, other):
        ia, ib = np.nonzero(a["valid"])[0], np.nonzero(b["valid"])[0]
        total += len(ia)
        if not len(ia) or not len(ib):
            continue
        iou = multidf2.box_iou_xywh(xywh(a["boxes"][ia]), xywh(b["boxes"][ib]))
        j = iou.argmax(1)
        keep = iou[np.arange(len(ia)), j] >= 0.9
        for k in ("match_features", "aggr_features"):
            diffs.append((k, np.abs(a[k][ia[keep]] - b[k][ib[j[keep]]])))
    out = {"paired": int(sum(len(d) for k, d in diffs if k == "match_features")),
           "detections": total}
    for k in ("match_features", "aggr_features"):
        d = np.concatenate([x for kk, x in diffs if kk == k] or [np.zeros((0, 256))])
        out[k] = {"max_abs": float(d.max()) if d.size else 0.0,
                  "mean_abs": float(d.mean()) if d.size else 0.0}
    return out


def phase_eval(dev, backends=("pallas_resident", "pallas", "pallas_int8")):
    mf, mdf2 = eval_sets(np.random.RandomState(3))
    probe = [p["images"][0] for p in mf] + [p["images"][5] for p in mf]
    out_root = Path("build") / "chip_smoke_eval"
    shutil.rmtree(out_root, ignore_errors=True)
    mf_cfg = EvalConfig(ingest="device")
    mdf2_cfg = EvalConfig(score_threshold=0.0, tracking_threshold=0.7, ingest="device")
    launches, report, probes = {}, {}, {}
    for backend in backends:
        model = serving_model(dev, backend)
        runner = InferenceRunner(model, chunk=mf_cfg.infer_chunk)
        probes[backend] = runner(probe)  # also the warm-up of both canvases
        torch.cuda.synchronize()
        for _, _, fn in KERNELS.values():
            fn.launches = 0
        seconds, top1 = {}, {}
        for name, harness, products, cfg in (("movingfashion", movingfashion, mf, mf_cfg),
                                             ("multidf2", multidf2, mdf2, mdf2_cfg)):
            out_dir = out_root / backend / name
            out_dir.mkdir(parents=True)
            t0 = time.perf_counter()
            with open(out_dir / "log.txt", "w") as f, contextlib.redirect_stdout(f):
                harness.evaluate(model, products, cfg, runner=runner, out_dir=str(out_dir))
            torch.cuda.synchronize()
            seconds[name] = (time.perf_counter() - t0) / len(products)
            metrics = json.loads((out_dir / "metrics.json").read_text())["all"]
            top1[name] = {s: m["1"] for s, m in metrics.items()}
            ks = [[m[k] for k in sorted(m, key=int)] for m in metrics.values()]
            if len(metrics) != 7 or not all(
                    0 <= a <= b <= 1 for row in ks for a, b in zip(row, row[1:])):
                raise SystemExit(f"eval: {backend} {name}: metrics are not 7 strategies of "
                                 f"rising top-k rates in [0, 1]: {metrics}")
        launches[backend] = {n: fn.launches for n, (_, _, fn) in KERNELS.items()}
        missing = [n for n in EVAL_PATH + (EVAL_ROI_KERNEL[backend],)
                   if launches[backend][n] == 0]
        if missing:
            raise SystemExit(f"eval: the {backend} path never launched {missing}")
        report[backend] = {"top1": top1, "s_per_product": seconds}
        log(f"eval: {backend}: seconds per product: movingfashion "
            f"{seconds['movingfashion']:.3f}, multidf2 {seconds['multidf2']:.3f}; "
            f"launches {launches[backend]}")
        for name in top1:
            log(f"eval: {backend} {name} top-1 (random weights: no accuracy meaning): "
                + ", ".join(f"{s}={v:.4f}" for s, v in top1[name].items()))
        del model, runner
        torch.cuda.empty_cache()
    for backend in backends[1:]:
        drift = descriptor_drift(probes[backends[0]], probes[backend])
        report[backend]["drift_vs_control"] = drift
        log(f"eval: descriptor drift {backend} vs {backends[0]} on {len(probe)} images "
            f"({drift['paired']} of {drift['detections']} detections paired): match max "
            f"{drift['match_features']['max_abs']:.4g} mean "
            f"{drift['match_features']['mean_abs']:.4g}, aggregator max "
            f"{drift['aggr_features']['max_abs']:.4g} mean "
            f"{drift['aggr_features']['mean_abs']:.4g}")
    return launches, report


def garment_crop(rng, s=56):
    """A filled ellipse mask crop [s, s] uint8, as a garment's mask in its box."""
    yy, xx = np.mgrid[:s, :s] / (s - 1) * 2 - 1
    ry, rx = rng.uniform(0.6, 1.0, 2)
    return ((yy / ry) ** 2 + (xx / rx) ** 2 <= 1.0).astype(np.uint8)


def train_batch(rng, sizes):
    """One phase-1 batch: images [0, len/2) are street photos (source 0),
    the rest shop photos (source 1); street image i and shop image i + len/2
    show the same 1-3 garments (pair ids shared, styles >= 1).  Each garment
    is a coloured rectangle with its box (in the image's pixels) and a 56x56
    mask crop."""
    half = len(sizes) // 2
    garments = [[(rng.randint(1, 14), 1000 * k + j, 1 + j % 2) for j in range(1 + k % 3)]
                for k in range(half)]
    images, targets = [], []
    for i, (h, w) in enumerate(sizes):
        img = rng.uniform(0.0, 0.25, (h, w, 3)).astype(np.float32)
        boxes = []
        for _ in garments[i % half]:
            bw, bh = w * rng.uniform(0.2, 0.6), h * rng.uniform(0.2, 0.6)
            x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            img[int(y1):int(y1 + bh), int(x1):int(x1 + bw)] = rng.uniform(0.3, 1.0, 3)
            boxes.append([x1, y1, x1 + bw, y1 + bh])
        g = garments[i % half]
        targets.append({"boxes": np.asarray(boxes, np.float32),
                        "labels": np.asarray([x[0] for x in g]),
                        "pair_ids": np.asarray([x[1] for x in g]),
                        "styles": np.asarray([x[2] for x in g]),
                        "sources": np.full(len(g), 0 if i < half else 1),
                        "mask_crops": np.stack([garment_crop(rng) for _ in g])})
        images.append(img)
    return images, targets


class TimedTrainer:
    """Phase1Trainer with a synchronised host clock around each step."""

    def __init__(self, trainer):
        self.trainer, self.optimizer = trainer, trainer.optimizer
        self.times, self.losses, self.buckets = [], [], []

    def step(self, batches, generator=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.trainer.step(batches, generator)
        torch.cuda.synchronize()
        self.times.append(time.perf_counter() - t0)
        self.losses.append({k: float(v) for k, v in out.items()})
        self.buckets.append(len(batches))
        return out


def train_model(dev, roi_align_backend):
    """The full-width phase-1 model (seeded random weights, the stem and
    layer1 frozen) and its timed trainer with the phase-1 optimizer."""
    tc = TrainConfig()
    cfg = serving_model_config(roi_heads=RoIHeadsConfig(roi_align_backend=roi_align_backend),
                               freeze_backbone_stages=True)
    model = init_model(cfg, video=False, seed=0, device=dev)
    schedule = multistep_warmup_schedule(tc.lr, tc.milestones, tc.gamma, 1000,
                                         tc.warmup_iters, tc.warmup_factor)
    return model, TimedTrainer(Phase1Trainer(model, sgd(model, schedule, tc.momentum,
                                                        tc.weight_decay, tc.clip_grad_norm)))


def phase_train(dev):
    tc = TrainConfig()
    model, timed = train_model(dev, "pallas_resident")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.RandomState(2)
    mixed = [(600, 800), (720, 1280), (480, 640), (800, 600), (768, 1024),  # 4 street
             (1280, 720), (500, 900), (640, 480)]                           # 4 shop
    single = [(600, 800), (720, 1280), (480, 640), (768, 1024), (540, 960), (500, 900),
              (640, 960), (450, 800)]
    # the first step of each path meets new shapes (cuDNN plans, allocator
    # growth), so both paths warm up before the timed steps
    data = [train_batch(rng, sizes) + ([i],) for i, sizes in
            enumerate((mixed, single, mixed, single, mixed, single))]
    n_warm = 2
    assert tc.batch_size == 8 and all(len(d[0]) == tc.batch_size for d in data)

    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    for name, mod in model.named_modules():
        if isinstance(mod, FrozenBatchNorm2d):
            frozen.update({f"{name}.{b}": v.clone() for b, v in mod.named_buffers()})
    train_one_epoch_matchrcnn(model, timed, data[:n_warm], epoch=0, generator=gen,
                              print_freq=100)
    trainable = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    for _, _, fn in KERNELS.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    train_one_epoch_matchrcnn(model, timed, data[n_warm:], epoch=0, generator=gen,
                              print_freq=100)
    launches = {name: fn.launches for name, (_, _, fn) in KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    step_ms = [x * 1e3 for x in timed.times[n_warm:]]
    buckets = timed.buckets[n_warm:]

    log(f"train: full-width phase-1 steps (batch 8, buckets {buckets}) in ms: "
        + ", ".join(f"{x:.1f}" for x in step_ms) + f"; median {statistics.median(step_ms):.1f}"
        " ms; warm-up steps " + ", ".join(f"{x * 1e3:.1f}" for x in timed.times[:n_warm])
        + f" ms; peak memory {peak_gb:.2f} GiB; launches {launches}")
    for i, lf in enumerate(timed.losses):
        log(f"train: step {i}: " + ", ".join(f"{k}={v:.4f}" for k, v in lf.items()))
    if not all(np.isfinite(v) for lf in timed.losses for v in lf.values()):
        raise SystemExit("train: a loss is not finite")
    if 1 not in buckets or 2 not in buckets:
        raise SystemExit(f"train: the fused and the two-bucket paths did not both run "
                         f"({timed.buckets})")
    params = dict(model.named_parameters())
    still = [n for n, v in trainable.items() if torch.equal(v, params[n])]
    if still:
        raise SystemExit(f"train: trainable parameters did not move: {still[:5]}")
    state = dict(model.named_parameters())
    state.update(dict(model.named_buffers()))
    changed = [n for n, v in frozen.items() if not torch.equal(v, state[n])]
    if changed:
        raise SystemExit(f"train: frozen tensors changed: {changed[:5]}")
    missing = [name for name in TRAIN_PATH if launches[name] == 0]
    if missing:
        raise SystemExit(f"train: the training path never launched {missing}")
    log(f"train: every loss finite; all {len(trainable)} trainable tensors moved; all "
        f"{len(frozen)} frozen tensors (stem, layer1, FrozenBN) bit-identical")
    return launches, step_ms, buckets, peak_gb, timed.losses[n_warm:]


def phase_train_pallas(dev):
    """One full-width phase-1 step (single orientation, batch 8) with the
    "pallas" RoIAlign backend: K6 forward, K5 backward."""
    model, timed = train_model(dev, "pallas")
    sizes = [(600, 800), (720, 1280), (480, 640), (768, 1024), (540, 960), (500, 900),
             (640, 960), (450, 800)]
    data = [train_batch(np.random.RandomState(5), sizes) + ([0],)]
    trainable = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    for _, _, fn in KERNELS.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    train_one_epoch_matchrcnn(model, timed, data, epoch=0,
                              generator=torch.Generator(device=dev).manual_seed(0),
                              print_freq=100)
    launches = {name: fn.launches for name, (_, _, fn) in KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    losses = timed.losses[0]
    log(f"train (pallas): one full-width phase-1 step (batch 8, one bucket, the first with "
        f"its shapes) in {timed.times[0] * 1e3:.1f} ms; peak memory {peak_gb:.2f} GiB; "
        f"launches {launches}; " + ", ".join(f"{k}={v:.4f}" for k, v in losses.items()))
    if not all(np.isfinite(v) for v in losses.values()):
        raise SystemExit("train (pallas): a loss is not finite")
    params = dict(model.named_parameters())
    still = [n for n, v in trainable.items() if torch.equal(v, params[n])]
    if still:
        raise SystemExit(f"train (pallas): trainable parameters did not move: {still[:5]}")
    missing = [name for name in TRAIN_PALLAS_PATH if launches[name] == 0]
    if missing:
        raise SystemExit(f"train (pallas): the training path never launched {missing}")
    log(f"train (pallas): every loss finite; all {len(trainable)} trainable tensors moved")
    return launches, timed.times[0] * 1e3, peak_gb, losses


class Timed:
    """A phase-2 runner and head step with a synchronised host clock around
    each call; it also keeps the bytes of the RoI features each inference
    hands the step and the boxes that pass ``score_thresh``; ``capture`` (a
    step index) keeps that step's batch and the heads' and optimizer's
    state before it, for the CPU redo."""

    def __init__(self, runner, step, heads, capture, score_thresh):
        self.runner, self.step, self.heads, self.capture = runner, step, heads, capture
        self.optimizer, self.score_thresh = step.optimizer, score_thresh
        self.infer_s, self.step_s, self.losses, self.rows, self.shops = [], [], [], [], []
        self.roi_bytes, self.candidates = [], []
        self.captured = None

    def run(self, images, device_keys=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, dev = self.runner.run(images, device_keys)
        torch.cuda.synchronize()
        self.infer_s.append(time.perf_counter() - t0)
        self.roi_bytes.append(nbytes(dev["roi_features"]))
        self.candidates.append(sum(int(((o["scores"] >= self.score_thresh) & o["valid"]).sum())
                                   for o in outs))
        return outs, dev

    def __call__(self, batch):
        if len(self.step_s) == self.capture:
            rows = batch["roi_src"][batch["row_img"].long(), batch["row_det"].long()]
            host = {k: v.cpu() for k, v in batch.items() if k != "roi_src"}
            host["roi_src"] = rows.cpu()[None]  # the gathered rows, as one image
            host["row_img"] = torch.zeros_like(host["row_img"])
            host["row_det"] = torch.arange(rows.shape[0], dtype=host["row_det"].dtype)
            self.captured = dict(batch=host, before=[head_state(m) for m in self.heads],
                                 opt=copy.deepcopy(self.optimizer.optimizer.state_dict()),
                                 count=self.optimizer.count)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.step(batch)
        torch.cuda.synchronize()
        self.step_s.append(time.perf_counter() - t0)
        self.losses.append({k: float(v) for k, v in out.items()})
        self.rows.append(int(batch["valid"].sum()) if "valid" in batch else
                         int(batch["seq_mask"].sum() + (batch["shop_row"] >= 0).sum()))
        self.shops.append(int((batch["shop_row"] >= 0).sum()))
        if self.captured is not None and "after" not in self.captured:
            self.captured["after"] = [head_state(m) for m in self.heads]
        return out


def head_state(module):
    """Every parameter and buffer of a head, copied to the host."""
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


def cpu_redo(captured, make_step, heads, schedule):
    """The captured head step again on the CPU in f32, from the same heads,
    optimizer state and rows; the card's update against it by
    ``compare_head_updates`` (the rule of the CPU step tests).  Returns (the
    parameters and statistics outside their limit, the worst parameter
    update's error over its size, the CPU losses, the seconds it took)."""
    t0 = time.perf_counter()
    mods = []
    for m, before in zip(heads, captured["before"]):
        c = copy.deepcopy(m).cpu()
        c.load_state_dict(before)
        mods.append(c)
    opt = SGD([p for c in mods for p in c.parameters()], schedule, SEAMTrainConfig().momentum,
              SEAMTrainConfig().weight_decay)
    opt.optimizer.load_state_dict(captured["opt"])
    opt.count = captured["count"]
    losses = {k: float(v) for k, v in make_step(mods, opt)(captured["batch"]).items()}

    def flat(sds):
        return {f"{i}.{k}": v for i, sd in enumerate(sds) for k, v in sd.items()}

    bad, worst = compare_head_updates(flat(captured["before"]), flat(m.state_dict() for m in mods),
                                      flat(captured["after"]))
    return bad, worst, losses, time.perf_counter() - t0


def seam_items(rng, n_products, frames, mdf2, first_id, noise):
    """One product batch as the phase-2 samplers give it: per product a shop
    image (sizes of both orientations) and ``frames`` frames of one video
    (landscape or portrait), uint8, a garment of the product's colour on
    noise (one noise image per size, kept in ``noise``); MultiDF2 items
    carry their GT key, styles, pair ids and box."""
    shop_sizes = [(600, 800), (800, 600), (1024, 768), (640, 480), (720, 960)]
    video_sizes = [(720, 1280), (1280, 720), (540, 960)]
    items = []
    for j in range(n_products):
        p = first_id + j
        color = rng.randint(80, 255, 3)
        for tag, (h, w) in [(1, shop_sizes[p % 5])] + [(0, video_sizes[p % 3])] * frames:
            if (h, w) not in noise:
                noise[(h, w)] = rng.randint(0, 64, (h, w, 3)).astype(np.uint8)
            img = noise[(h, w)].copy()
            bh, bw = int(h * rng.uniform(0.3, 0.7)), int(w * rng.uniform(0.3, 0.7))
            y, x = rng.randint(0, h - bh), rng.randint(0, w - bw)
            img[y:y + bh, x:x + bw] = color
            item = {"image": img, "tag": tag, "i": p}
            if mdf2:
                item.update(key=f"1_{p}", styles=np.asarray([1]), pair_ids=np.asarray([p]),
                            boxes=np.asarray([[x, y, x + bw, y + bh]], np.float32))
            items.append(item)
    return items


def phase_seam(dev):
    """Phase-2 SEAM training at full width: the video serving model (seeded
    random weights, warm-started through ``clone_match_to_aggregator``),
    ``train_one_epoch_movingfashion`` over 16 products x (1 shop + 10
    frames) and ``train_one_epoch_multidf2`` over 8 x (1 + 10), each one
    warm-up batch and two drives:

    * 3 timed batches in the one-row-per-image regime (the background logit
      raised, see below) at the CLIs' learning rates / 40, checked for a
      step each, finite losses, an MF aggregation loss > 0, and one step
      redone on the CPU;
    * one batch as the random detector scores it, at the CLIs' own learning
      rates: many boxes an image, so the shop's largest-box pick, MultiDF2's
      best-IoU pick and (MovingFashion) the cut at max_rows run; checked
      for a step, finite losses and finite updated heads, which are then
      put back."""
    tc = SEAMTrainConfig()
    model = serving_model(dev)
    bias = model.roi_heads["box_predictor"].cls_score.bias
    # the background logit raised by 10: no random box scores 0.1 any more,
    # so each image's one row is the video model's whole-image fallback
    # (score 0.1, which passes score_thresh) and all products reach the
    # aggregation loss.  Unbiased, the random predictor scored many boxes
    # a frame >= 0.1: 256 rows came from the first 1-2 products and their
    # one-pair aggregation loss underflowed to 0 (H100, 16 x (1 + 10) images)
    with torch.no_grad():
        bias[0] += 10.0
    clone_match_to_aggregator(model)
    mp, ta = model.roi_heads["match_predictor"], model.roi_heads["temporal_aggregator"]
    runner = InferenceRunner(model, chunk=tc.infer_chunk, with_match=False,
                             with_aggr_features=False, with_roi_features=True)
    steps, max_rows = 4, 256
    n_frames = model.cfg.match.n_frames
    rng, noise = np.random.RandomState(6), {}
    launches, report = {}, {}
    # the CLIs' batches (MultiDF2: 8 shops) and learning rates (0.04, 0.02);
    # the timed batches run them / 40: from random heads the CLIs' own swing
    # the scorers so far in a step that the next one's logits fall below the
    # match threshold (no weak positive, an aggregation loss of exactly 0)
    # or overflow
    for name, n_products, mdf2, cli_lr in (("seam_mf", tc.n_shops, False, tc.lr),
                                           ("seam_mdf2", 8, True, 0.02)):
        heads = (ta,) if mdf2 else (mp, ta)

        def optimizer(lr):
            # the CLI's schedule at epoch 1 (the optimizer has taken an
            # epoch's steps): no warmup
            schedule = multistep_warmup_schedule(lr, tc.milestones, tc.gamma, steps,
                                                 tc.warmup_iters, tc.warmup_factor)
            opt = SGD([p for h in heads for p in h.parameters()], schedule, tc.momentum,
                      tc.weight_decay)
            opt.count = steps
            return opt, schedule

        if mdf2:
            make_step = lambda mods, o: make_mdf2_head_step(mods[-1], o)  # noqa: E731
            loop = train_one_epoch_multidf2
            mp_before = head_state(mp)
        else:
            make_step = lambda mods, o: make_seam_head_step(  # noqa: E731
                mods[0], mods[1], o, tc.frames_per_shop, n_frames)
            loop = train_one_epoch_movingfashion
        opt, schedule = optimizer(cli_lr / 40)
        timed = Timed(runner, make_step(heads, opt), heads, 1, tc.score_thresh)
        cli = Timed(runner, make_step(heads, optimizer(cli_lr)[0]), heads, None, tc.score_thresh)
        data = [seam_items(rng, n_products, tc.frames_per_shop, mdf2, 100 * b, noise)
                for b in range(5)]
        kw = dict(n_products=n_products, frames_per_product=tc.frames_per_shop,
                  score_thresh=tc.score_thresh, max_rows=max_rows, print_freq=100)
        loop(timed, timed, data[:1], epoch=1, **kw)  # warm-up: cuDNN plans, allocator
        for _, _, fn in KERNELS.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        loop(timed, timed, data[1:4], epoch=1, **kw)
        saved = [head_state(h) for h in heads]
        with torch.no_grad():
            bias[0] -= 10.0
        loop(cli, cli, data[4:], epoch=1, **kw)
        with torch.no_grad():
            bias[0] += 10.0
        launches[name] = {n: fn.launches for n, (_, _, fn) in KERNELS.items()}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
        cli_finite = all(bool(torch.isfinite(p).all()) for h in heads for p in h.parameters())
        cli_moved = [not torch.equal(p.detach().cpu(), saved[i][k]) for i, h in enumerate(heads)
                     for k, p in h.named_parameters()]
        for h, sd in zip(heads, saved):
            h.load_state_dict(sd)
        # what the batching of one product batch holds at once: every
        # image's f32 canvas, and the per-bucket torch.cat of them
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        canvases = runner.batches([it["image"] for it in data[-1]])
        batching_gb = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        canvas_gb = sum(nbytes(b.pixels) for b in canvases) / 2**30
        del canvases
        infer_ms = [x * 1e3 for x in timed.infer_s[1:]]
        step_ms = [x * 1e3 for x in timed.step_s[1:]]
        losses = timed.losses[1:]
        n_images = len(data[0])
        roi_gb = max(timed.roi_bytes + cli.roi_bytes) / 2**30  # measured, this run
        log(f"seam: {name}: {n_images} images a product batch; ms per batch (inference + head "
            f"step): " + ", ".join(f"{a:.1f} + {b:.1f}" for a, b in zip(infer_ms, step_ms))
            + f"; warm-up {timed.infer_s[0] * 1e3:.1f} + "
            + (f"{timed.step_s[0] * 1e3:.1f}" if timed.step_s else "no step")
            + f"; rows {timed.rows[1:]}, products with a shop row {timed.shops[1:]}; "
            f"peak memory {peak_gb:.2f} GiB (RoI features {roi_gb:.2f} GiB; batching alone "
            f"{batching_gb:.2f} GiB above the rest, canvases {canvas_gb:.2f} GiB); "
            f"launches {launches[name]}")
        for i, lf in enumerate(losses):
            log(f"seam: {name} step {i}: " + ", ".join(f"{k}={v:.4f}" for k, v in lf.items()))
        log(f"seam: {name}: the unbiased batch at lr {cli_lr}: "
            + (f"{cli.infer_s[0] * 1e3:.1f} + {cli.step_s[0] * 1e3:.1f} ms, "
               f"{cli.candidates[0]} boxes >= {tc.score_thresh}, rows {cli.rows[0]} "
               f"(max_rows {max_rows}), products with a shop row {cli.shops[0]}; "
               + ", ".join(f"{k}={v:.4f}" for k, v in cli.losses[0].items())
               if cli.step_s else "no step"))
        # the video model's whole-image fallback (score 0.1) is what passes
        # score_thresh (the background bias above): every image has a row,
        # so every batch must take a step
        if len(step_ms) != 3 or len(infer_ms) != 3:
            raise SystemExit(f"seam: {name}: {len(step_ms)} of 3 timed batches took a step")
        if not all(np.isfinite(v) for lf in losses for v in lf.values()):
            raise SystemExit(f"seam: {name}: a loss is not finite")
        if not mdf2 and not all(lf["aggregation_loss"] > 0 for lf in losses):
            raise SystemExit(f"seam: {name}: the aggregation loss is not > 0")
        # unbiased, the random detector passes many boxes an image: the
        # multi-box picks run, and MovingFashion's rows are cut at max_rows
        if len(cli.step_s) != 1:
            raise SystemExit(f"seam: {name}: the unbiased batch took no step")
        if not all(np.isfinite(v) for v in cli.losses[0].values()) or not cli_finite:
            raise SystemExit(f"seam: {name}: the unbiased batch's losses or heads are not finite")
        if not any(cli_moved):
            raise SystemExit(f"seam: {name}: the unbiased batch's step moved no parameter")
        if cli.candidates[0] <= len(data[4]):
            raise SystemExit(f"seam: {name}: the unbiased batch passed {cli.candidates[0]} boxes "
                             f"for {len(data[4])} images: no multi-box selection ran")
        if not mdf2 and cli.rows[0] != max_rows:
            raise SystemExit(f"seam: {name}: the unbiased batch's {cli.rows[0]} rows were not "
                             f"cut at max_rows {max_rows}")
        missing = [n for n in SEAM_PATH if launches[name][n] == 0]
        idle = [n for n in SEAM_IDLE if launches[name][n] != 0]
        if missing or idle:
            raise SystemExit(f"seam: {name}: never launched {missing}; launched {idle}")
        if mdf2:
            after = head_state(mp)
            changed = [k for k, v in mp_before.items() if not torch.equal(v, after[k])]
            if changed:
                raise SystemExit(f"seam: {name}: the frozen match predictor changed: {changed}")
        bad, worst, cpu_losses, cpu_s = cpu_redo(timed.captured, make_step, heads, schedule)
        gpu_losses = losses[0]
        bad += [k for k in gpu_losses
                if abs(cpu_losses[k] - gpu_losses[k]) > 1e-4 * abs(cpu_losses[k]) + 1e-7]
        log(f"seam: {name}: the first timed head step redone on the CPU in f32 ({cpu_s:.1f} s): "
            f"worst parameter update {worst:.3g} of its norm (limit 5e-3), losses "
            + ", ".join(f"{k} {gpu_losses[k]:.6f} / {cpu_losses[k]:.6f}" for k in gpu_losses)
            + (" (card / CPU); the match predictor bit-equal" if mdf2 else " (card / CPU)"))
        if bad:
            raise SystemExit(f"seam: {name}: the card's head update disagrees with the CPU's: "
                             f"{bad[:5]}")
        report[name] = {"images_per_batch": n_images, "inference_ms": infer_ms,
                        "head_step_ms": step_ms, "rows": timed.rows[1:],
                        "products": timed.shops[1:], "peak_gib": peak_gb,
                        "batching_gib": batching_gb, "roi_features_gib": roi_gb,
                        "losses": losses, "cpu_worst_update_err": worst,
                        "unbiased": {"inference_ms": cli.infer_s[0] * 1e3,
                                     "head_step_ms": cli.step_s[0] * 1e3,
                                     "boxes": cli.candidates[0], "rows": cli.rows[0],
                                     "products": cli.shops[0], "losses": cli.losses[0]}}
        del timed, cli
        torch.cuda.empty_cache()
    return launches, report


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
    paths = {}
    paths["serving"], latencies, gallery_s, serve_peak_gb = phase_slice(dev)
    torch.cuda.empty_cache()
    eval_launches, eval_report = phase_eval(dev)
    paths.update({f"eval_{b}": v for b, v in eval_launches.items()})
    paths["train"], step_ms, step_buckets, train_peak_gb, train_losses = phase_train(dev)
    torch.cuda.empty_cache()
    paths["train_pallas"], pallas_step_ms, pallas_peak_gb, pallas_losses = phase_train_pallas(
        dev)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    seam_launches, seam_report = phase_seam(dev)
    log(f"seam: phase 5 took {time.perf_counter() - t0:.1f} s")
    paths.update(seam_launches)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "cases",
            "canvas_cases", "deterministic")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(counts[name] for counts in paths.values()),
         "launches_by_path": {path: counts[name] for path, counts in paths.items()},
         **{k: results[name][k] for k in keys if k in results[name]}}
        for name, (src, rep, _) in KERNELS.items()],
        "retrieve_ms": [x * 1e3 for x in latencies], "gallery_ms": gallery_s * 1e3,
        "serving_peak_gib": serve_peak_gb, "eval": eval_report, "train_step_ms": step_ms,
        "train_step_buckets": step_buckets, "train_peak_gib": train_peak_gb,
        "train_losses": train_losses, "train_pallas_step_ms": pallas_step_ms,
        "train_pallas_peak_gib": pallas_peak_gb, "train_pallas_losses": pallas_losses,
        "seam": seam_report}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
