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
               and K5 called twice on the same inputs (equal bytes), and
               K8 at each distinct call of a batch-11 forward of the body,
               forward and backward, bit-equal to the op chain, with the
               totals of a forward's 48 calls;
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
               loop must leave the match predictor bit-equal;
  6. serve   - the serving entry points at full width (the model of phase
               3): SeamRetrieval.detect with masks on 4 frames of 720x1280
               and 1 of 1280x720 (masks pasted at the original size on the
               card, [D, H, W] f32 on the host), timed as a whole and step
               by step (forward, paste, copy), 8 rows a frame repasted on
               the CPU from the card's own 28x28 probabilities and boxes
               (within 1e-5), every mask 0 outside its box, the RLE of
               detections_json decoded back; then cli.serve.main in process
               on a synthetic MovingFashion fixture (--synthetic with the
               host ingest and with --device_ingest, --detect on its
               video) and its HTTP server (/healthz, /v1/products, twice
               each of /v1/query and /v1/detect);
  7. cli     - the training and evaluation CLIs in process at full width
               (their own model configs, seeded random weights) on
               synthetic fixtures in a temporary directory: deepf_to_coco
               on 48 DF2 images of 600x800; train_matchrcnn (batch 8, 2
               epochs of 12 steps, --save_steps 4, --clip_grad_norm 5.0)
               under torch.use_deterministic_algorithms, with step times,
               checkpoint sizes and save/read times; the same command
               stopped once epoch 1's mid slot exists and rerun with
               --auto_resume, held bit-equal to the first run (items
               loaded, epoch, optimizer_count, every tensor and momentum
               buffer); one epoch with --roi_backend pallas; then
               train_movingfashion (16 products x (1 + 10), 2 epochs, eval
               every epoch) and train_multidf2 (8 x (1 + 10), 1 epoch) from
               the phase-1 final.pt, each checked for a frozen detector
               (and, MultiDF2, match predictor) and moved heads; the two
               eval CLIs on their final.pt (seconds a product, top-1); and
               SeamRetrieval.from_checkpoint on the MovingFashion file
               answering one query;
  8. dist    - the distributed paths on two ranks (torch.multiprocessing
               spawn) that share the one card over Gloo, since NCCL refuses
               two ranks on one device: the full-width phase-1 DP step
               (Phase1Trainer over a data mesh, 4 images a rank, 3 steps
               bit-equal across ranks; one "pallas" step; one step in f32
               held against the one-process step on the 8 images), the
               MovingFashion and MultiDF2 head steps over both ranks' rows
               against the one-process step (one rank without rows; none on
               any rank skips), InferenceRunner(mesh) at chunk 8 against one
               process at chunk 4 (bit-equal), score_matrix_sharded
               1000x1000 over model=2, and cli/train_matchrcnn under
               torchrun's environment (stopped after a mid save, resumed
               with --auto_resume: rank 0 alone writes, the ranks agree on
               the file and end bit-equal), then cli/train_movingfashion
               and cli/train_multidf2 the same way from its final.pt (8
               products, 2 a batch a rank: each rank takes its 2 batches,
               rank 0 alone writes the checkpoints and the in-loop
               evaluation's artifacts, the ranks end bit-equal); then a
               one-rank NCCL group running two phase-1 steps and a gather
               on the card.  A rank that fails, or runs past 600 s, fails
               the phase;
  9. ablate  - the phase-1 ablation paths at full width on phase 4's batch
               of 8 at 800x1344: remat_backbone off and on (1 + 3 steps
               each under deterministic algorithms, median step, peak
               memory, the updates bit-equal); roi_adjoint_backend "xla"
               against K5 (a captured cotangent within K5's tolerance of
               the f32 plain adjoint, the first step's update within 1e-3,
               step times, the adjoint alone with and without
               deterministic algorithms, one step with the K6 forward);
               the grad/accum/apply triple (at weight 1 bit-equal to
               Phase1Trainer.step, then a mixed batch of 4 + 4 beside it);
               each stage of profile_losses (forward and step ms, "full"
               equal to the step's loss) and the optimizer alone; then
               inference(gt=) on the serving model at batch 11 (the GT rows
               first, the detections as without gt), one retrieve request
               traced with utils.profiling.trace into
               build/chip_smoke_trace/ (the trace names the annotation and
               the CUDA kernels of K1-K4), and visualize_matches on the
               detector's CUDA outputs where matplotlib is importable;
 10. export  - the AOT serving export (tools/export_serving_torch.py):
               serving_model_config() exported with torch.export from CUDA
               fake tensors at batch 11 on 800x1344, saved to a temporary
               .pt2, loaded and replayed on seeded synthetic images (bit-
               equal to the eager forward; K1 once and K2 twice a replayed
               forward, the graph calling seam::fused_stem and
               seam::roi_align), the same at batch 1 under "pallas" (K6)
               and "pallas_int8" (K7), with export, save and load seconds,
               MB, and replay against eager ms; the CLI's --out at its
               defaults (ModelConfig()) and --check on the file; then the
               retrieval parity gate (tools/validate_parity_torch.py
               --synthetic) at full geometry for the exact, serving and
               fast profiles: three top-1 values in [0, 1] a profile, the
               deltas and the verdict printed, not asserted (random
               weights);
 11. gates   - the serving-profile validation tools in process: the int8,
               fast-profile and trunk-dtype gates
               (tools/validate_{int8,fast_profile,trunk_dtype}_torch.py
               --products 8 --epochs 3 --confusable, fixtures and logs in a
               temporary directory), each training phase-1 Match R-CNN from
               scratch at full geometry in f32 (ModelConfig(compute_dtype=
               "float32"), as the JAX tools: the plain stem and RoIAlign) and
               evaluating its arms on that one model, one model on the card
               at a time (each arm must find no earlier model held), with
               seconds and peak memory per training and arm and the
               INT8VAL/FASTVAL/TRUNKVAL_JSON line parsed (the JAX tools'
               keys, top-1 values in [0, 1]); then
               tools/measure_roi_clamp_torch.py --detector.
For phases 3 to 11 the launch counters are zeroed right before each path
and read right after (in phase 8 in each rank's process, reported per
rank); every kernel of the path must have run (on the seam
paths K3, K4 and K5 must not; on the serve paths K5-K7 must not, nor K3
and K4 on a detect path; on the phase-1 CLI paths K3, K4 and K7 must not,
on the phase-2 training epochs K3-K7 must not, and the CLIs' evaluations
run K1-K4 and never K5-K7; K5 must not run under the "xla" adjoint; a
replayed export runs exactly K1 once and its RoIAlign kernel twice; the
parity gate's exact profile runs K4 alone, the others K1-K4, none K5-K7; a gate's training
runs no kernel, each gate arm K1, its RoIAlign kernel (K2, K6 or K7), K3 and K4 and no other,
the clamp tool's detector K1 and K2 alone).  Then the card's name
and power limit, a JSON line of per-kernel results, and last the JSON line
{"ok": true, "device": {...}}.  Any failure exits non-zero without that
line.  There is no CPU fallback.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
from pathlib import Path

# phase 7 runs the phase-1 CLI under torch.use_deterministic_algorithms, whose
# cuBLAS calls need this workspace setting before the first handle exists
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch.nn.functional as F  # noqa: E402

from seam_match_rcnn_tpu_torch.ckpt import io as ckpt_io  # noqa: E402
from seam_match_rcnn_tpu_torch.ckpt.torch_convert import clone_match_to_aggregator
from seam_match_rcnn_tpu_torch.cli import (deepf_to_coco, evaluate_movingfashion,
                                           evaluate_multidf2, serve, train_matchrcnn,
                                           train_movingfashion, train_multidf2)
from seam_match_rcnn_tpu_torch.config import (EvalConfig, RoIHeadsConfig, SEAMTrainConfig,
                                              TrainConfig, TransformConfig,
                                              serving_model_config)
from seam_match_rcnn_tpu_torch.data import df2
from seam_match_rcnn_tpu_torch.data.synthetic import (make_synthetic_df2,
                                                      make_synthetic_movingfashion)
from seam_match_rcnn_tpu_torch.eval import movingfashion, multidf2
from seam_match_rcnn_tpu_torch.eval.gallery import score_matrix
from seam_match_rcnn_tpu_torch.eval.runner import InferenceRunner
from seam_match_rcnn_tpu_torch.models.layers import FrozenBatchNorm2d
from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model
from seam_match_rcnn_tpu_torch.models.transform import batch_images, normalize
from seam_match_rcnn_tpu_torch.ops import (cuda_epilogue, cuda_kernels, cuda_roi_align, cuda_stem,
                                           native, rle, vit_attention)
from seam_match_rcnn_tpu_torch.ops.masks import paste_masks
from seam_match_rcnn_tpu_torch.ops.pairwise import pairwise_match_scores
from seam_match_rcnn_tpu_torch.ops import roi_align_patch as patch
from seam_match_rcnn_tpu_torch.ops.roi_align import (SPATIAL_SCALES, multilevel_roi_align,
                                                      multilevel_roi_align_adjoint)
from seam_match_rcnn_tpu_torch.serving import (Gallery, RetrievalResult, SeamRetrieval,
                                                decode_video_frames, load_image_frames)
from seam_match_rcnn_tpu_torch.train.engine import (bucket_batches, train_one_epoch_matchrcnn,
                                                     train_one_epoch_movingfashion,
                                                     train_one_epoch_multidf2)
from seam_match_rcnn_tpu_torch.train.optim import SGD, multistep_warmup_schedule, sgd
from seam_match_rcnn_tpu_torch.train.seam import (compare_head_updates, make_mdf2_head_step,
                                                  make_seam_head_step, select_rows_host)
from seam_match_rcnn_tpu_torch.train.steps import Phase1Trainer, make_phase1_grad_apply
from seam_match_rcnn_tpu_torch.utils import profiling, visualize

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
    # K8 replaces no TPU kernel: XLA fused these elementwise ops into the conv there
    "bn_epilogue": ("seam_match_rcnn_tpu_torch/csrc/conv_epilogue.cu", "none",
                    cuda_epilogue.bn_epilogue),
    "bn_epilogue_grad": ("seam_match_rcnn_tpu_torch/csrc/conv_epilogue.cu", "none",
                         cuda_epilogue.bn_epilogue_grad),
    # K9 replaces no TPU kernel: the JAX package has no vision transformer
    "vit_attention": ("seam_match_rcnn_tpu_torch/ops/vit_attention.py", "none",
                      vit_attention.vit_attention),
}
K8 = ("bn_epilogue", "bn_epilogue_grad")  # every path through the backbone on the card
SERVING_PATH = ("fused_stem", "roi_align", "nlb_aggregate", "pairwise_scores", "bn_epilogue")
TRAIN_PATH = ("fused_stem", "roi_align", "roi_align_adjoint") + K8
EVAL_ROI_KERNEL = {"pallas_resident": "roi_align", "pallas": "roi_align_patch",
                   "pallas_int8": "roi_align_patch_int8"}
EVAL_PATH = ("fused_stem", "nlb_aggregate", "pairwise_scores", "bn_epilogue")
TRAIN_PALLAS_PATH = ("fused_stem", "roi_align_patch", "roi_align_adjoint") + K8
SEAM_PATH = ("fused_stem", "roi_align", "bn_epilogue")  # the frozen detector's inference
SEAM_IDLE = ("nlb_aggregate", "pairwise_scores", "roi_align_adjoint")  # no K3, K4, K5 there
SERVE_DETECT_PATH = ("fused_stem", "roi_align", "bn_epilogue")  # no descriptors: no K3 or K4
SERVE_IDLE = ("roi_align_adjoint", "roi_align_patch", "roi_align_patch_int8")  # no K5-K7

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


# K9's two calls in a chunk of 11 ViTDet-L canvases of 1024x1024 (a 64x64 token
# grid, 16 heads of 64): (name, padded grid side, window side)
VIT_ATTENTION_CASES = (("windowed", 70, 14), ("global", 64, 64))


def vit_attention_case(gen, dev, grid: int, s: int, b: int = 11, heads: int = 16,
                       d: int = 64):
    """Inputs of one K9 call: qkv [b, grid, grid, 3*heads*d] and the rel
    terms, bf16, drawn N(0, 1) (the cell's logits are O(1) too)."""
    nw = b * (grid // s) ** 2
    randn = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(torch.bfloat16)  # noqa
    return randn(b, grid, grid, 3 * heads * d), randn(nw, heads, s * s, s), \
        randn(nw, heads, s * s, s)


def check_vit_attention(got, want, v):
    """K9 rounds the softmax weights to bf16 for the PV product (a relative
    2^-9 each), sums in its own order and rounds once to bf16: an output may
    differ from the f32 plain version by one bf16 ulp plus 2^-8 of the
    largest |v|, twice the weights' rounding."""
    err = (got.float() - want.float()).abs()
    tol = bf16_ulp(want.float()) + 2.0 ** -8 * float(v.float().abs().max())
    return float(err.max()), "1 bf16 ulp + 2^-8 max|v|", bool((err <= tol).all())


def phase_kernels_vit(dev, gen, results):
    """K9 at the ViTDet-L indexing cell's two attention calls (a chunk of 11
    canvases): against its plain version, with its time, the plain time, its
    bound and the library's (PyTorch's fused attention over a materialised
    bias, as a yardstick only; the port never calls it)."""
    import torch.nn.functional as F

    cases, all_ok = [], True
    for name, grid, s in VIT_ATTENTION_CASES:
        qkv, rh, rw = vit_attention_case(gen, dev, grid, s)
        args = (qkv, rh, rw, s)
        got = vit_attention.vit_attention(*args)
        v = qkv.view(11, grid, grid, 3, 16, 64)[:, :, :, 2]
        err, tol, ok = check_vit_attention(got, vit_attention.vit_attention_plain(*args), v)
        ms = median_ms(lambda: vit_attention.vit_attention(*args), 10)
        pms = median_ms(lambda: vit_attention.vit_attention_plain(*args), 2)
        n, t = rh.shape[0], s * s
        x = qkv.view(11, grid // s, s, grid // s, s, 3, 16, 64).permute(5, 0, 1, 3, 6, 2, 4, 7)
        q, k, vv = x.reshape(3, n, 16, t, 64).unbind(0)

        def library():
            bias = (rh[..., :, None] + rw[..., None, :]).reshape(n, 16, t, t)
            return F.scaled_dot_product_attention(q, k, vv, attn_mask=bias)

        lms = median_ms(library, 5)
        flops = 4 * n * 16 * t * t * 64
        b_ms, b_by = bound(nbytes(qkv, rh, rw, got), flops, "bf16")
        cases.append(dict(shape=f"{name}: {n} windows x 16 heads x {t} tokens, bf16",
                          max_abs_err=err, tol=tol, ms=ms, plain_ms=pms, library_ms=lms,
                          bound_ms=b_ms, bound_by=b_by))
        log(f"kernels: vit_attention {name}: err {err:.3g} ok={ok}, {ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), plain {pms:.4f} ms, library {lms:.4f} ms")
        all_ok &= ok
        del qkv, rh, rw, got, q, k, vv, x, v
        torch.cuda.empty_cache()
    results["vit_attention"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in cases), ms=cases[0]["ms"],
        plain_ms=cases[0]["plain_ms"], ok=all_ok, bound_ms=cases[0]["bound_ms"],
        bound_by=cases[0]["bound_by"], library_ms=cases[0]["library_ms"], cases=cases)


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
    phase_kernels_epilogue(dev, gen, results)
    phase_kernels_vit(dev, gen, results)

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


# K8's distinct calls in a forward of the body on an 800x1344 canvas:
# (C, H, W, residual kind, calls), 48 calls in all (every one with ReLU)
BODY_EPILOGUES = (
    (64, 200, 336, "none", 6), (256, 200, 336, "raw", 1), (256, 200, 336, "identity", 2),
    (128, 200, 336, "none", 1), (128, 100, 168, "none", 7), (512, 100, 168, "raw", 1),
    (512, 100, 168, "identity", 3), (256, 100, 168, "none", 1), (256, 50, 84, "none", 11),
    (1024, 50, 84, "raw", 1), (1024, 50, 84, "identity", 5), (512, 50, 84, "none", 1),
    (512, 25, 42, "none", 5), (2048, 25, 42, "raw", 1), (2048, 25, 42, "identity", 2))
RESIDUAL_KIND = {"none": cuda_epilogue.NONE, "identity": cuda_epilogue.IDENTITY,
                 "raw": cuda_epilogue.RAW}


def bits_equal(got, want) -> bool:
    as_int = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[want.dtype]
    return got.dtype == want.dtype and torch.equal(got.view(as_int), want.view(as_int))


def phase_kernels_epilogue(dev, gen, results):
    """K8 at every distinct call of a batch-11 bf16 serving forward of the
    body (layer1 to layer4), forward and backward, each held bit for bit to
    the plain chain, with times, the chain's time and the byte bound (each
    tensor read or written once); the totals weight each call by how often a
    forward makes it."""
    fwd, bwd, all_ok = [], [], True
    for c, h, w, kind, calls in BODY_EPILOGUES:
        mode = RESIDUAL_KIND[kind]
        randn = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)  # noqa
        y = randn(11, c, h, w)
        sc, sh = (0.5 + torch.rand(c, generator=gen, device=dev)).to(torch.bfloat16), randn(c)
        res = randn(11, c, h, w) if mode != cuda_epilogue.NONE else None
        sr, hr = (sc.flip(0), sh.flip(0)) if mode == cuda_epilogue.RAW else (None, None)
        args = (y, sc, sh, res, sr, hr, True)
        out = cuda_epilogue.bn_epilogue(*args)
        ok = bits_equal(out, cuda_epilogue.bn_epilogue_plain(*args))
        ms = median_ms(lambda: cuda_epilogue.bn_epilogue(*args), 20)
        pms = median_ms(lambda: cuda_epilogue.bn_epilogue_plain(*args), 20)
        b_ms, b_by = bound(nbytes(*[t for t in args[:6] if t is not None], out), 0, "bf16")
        shape = f"[11,{c},{h},{w}] bf16 {kind}"
        fwd.append(dict(shape=shape, calls=calls, max_abs_err=0.0 if ok else float("inf"),
                        tol="bit-equal", ms=ms, plain_ms=pms, library_ms=None, bound_ms=b_ms,
                        bound_by=b_by))
        all_ok &= ok
        # the backward from out's gradient
        g = randn(11, c, h, w)
        gargs = (g, out, sc, sr, mode, True)
        got = cuda_epilogue.bn_epilogue_grad(*gargs)
        want = cuda_epilogue.bn_epilogue_grad_plain(*gargs)
        ok = bits_equal(got[0], want[0]) and (mode == cuda_epilogue.NONE
                                              or bits_equal(got[1], want[1]))
        ms = median_ms(lambda: cuda_epilogue.bn_epilogue_grad(*gargs), 20)
        pms = median_ms(lambda: cuda_epilogue.bn_epilogue_grad_plain(*gargs), 20)
        outs = got if mode != cuda_epilogue.NONE else got[:1]
        b_ms, b_by = bound(nbytes(g, out, sc, *[t for t in (sr,) if t is not None], *outs), 0,
                           "bf16")
        bwd.append(dict(shape=shape, calls=calls, max_abs_err=0.0 if ok else float("inf"),
                        tol="bit-equal", ms=ms, plain_ms=pms, library_ms=None, bound_ms=b_ms,
                        bound_by=b_by))
        all_ok &= ok
        del y, res, out, g, got, want, args, gargs
    for name, cases in (("bn_epilogue", fwd), ("bn_epilogue_grad", bwd)):
        total = {k: sum(c[k] * c["calls"] for c in cases) for k in ("ms", "plain_ms", "bound_ms")}
        log(f"kernels: {name}: a batch-11 forward's 48 calls: kernel {total['ms']:.4f} ms, "
            f"plain {total['plain_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms "
            f"({100 * total['bound_ms'] / total['ms']:.1f}% of 3.35 TB/s)")
        results[name] = dict(max_abs_err=max(c["max_abs_err"] for c in cases),
                             ms=total["ms"], plain_ms=total["plain_ms"], ok=all_ok,
                             bound_ms=total["bound_ms"], bound_by="bytes", library_ms=None,
                             cases=cases)


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
        self.trainer, self.optimizer, self.group = trainer, trainer.optimizer, trainer.group
        self.times, self.losses, self.buckets = [], [], []

    def step(self, batches, generator=None, draws=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.trainer.step(batches, generator, draws)
        torch.cuda.synchronize()
        self.times.append(time.perf_counter() - t0)
        self.losses.append({k: float(v) for k, v in out.items()})
        self.buckets.append(len(batches))
        return out


def train_model(dev, roi_align_backend, mesh=None, compute_dtype=None,
                roi_adjoint_backend="pallas", remat=False):
    """The full-width phase-1 model (seeded random weights, the stem and
    layer1 frozen; bf16 unless ``compute_dtype`` says otherwise) and its
    timed trainer with the phase-1 optimizer (over ``mesh``'s data axis when
    given)."""
    tc = TrainConfig()
    cfg = serving_model_config(roi_heads=RoIHeadsConfig(roi_align_backend=roi_align_backend,
                                                        roi_adjoint_backend=roi_adjoint_backend),
                               freeze_backbone_stages=True, remat_backbone=remat)
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    model = init_model(cfg, video=False, seed=0, device=dev)
    schedule = multistep_warmup_schedule(tc.lr, tc.milestones, tc.gamma, 1000,
                                         tc.warmup_iters, tc.warmup_factor)
    return model, TimedTrainer(Phase1Trainer(model, sgd(model, schedule, tc.momentum,
                                                        tc.weight_decay, tc.clip_grad_norm),
                                             mesh))


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
        self.group = getattr(step, "group", None)
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

def launch_counts(zero: bool = False):
    """Every kernel's launch count (and, with ``zero``, reset them to 0)."""
    counts = {name: fn.launches for name, (_, _, fn) in KERNELS.items()}
    if zero:
        for _, _, fn in KERNELS.values():
            fn.launches = 0
    return counts


def check_serve_path(path: str, counts, detect: bool) -> None:
    need = SERVE_DETECT_PATH if detect else SERVING_PATH
    idle = SERVE_IDLE + (("nlb_aggregate", "pairwise_scores") if detect else ())
    missing = [n for n in need if counts[n] == 0]
    launched = [n for n in idle if counts[n] != 0]
    if missing or launched:
        raise SystemExit(f"serve: {path}: never launched {missing}; launched {launched}")


def check_detections(outs, frames, d, where):
    """Every image's masks are [D, H, W] f32 probabilities, and each valid
    row's are 0 outside its box widened by half a mask cell (the paste
    interpolates the mask's edge cells against the zero ring around them)
    and one pixel; detections_json's RLE decodes to the masks above 0.5."""
    for f, o in zip(frames, outs):
        m = o["masks"]
        if m.shape != (d,) + f.shape[:2] or m.dtype != np.float32 or not np.isfinite(m).all() \
                or m.min() < 0 or m.max() > 1:
            raise SystemExit(f"serve: {where}: masks are not [{d}, H, W] probabilities in [0, 1]")
        for i in np.nonzero(o["valid"])[0]:
            ys, xs = np.nonzero(m[i])
            if not ys.size:
                continue
            x1, y1, x2, y2 = (float(v) for v in o["boxes"][i])
            mx, my = (x2 - x1) / 56 + 1, (y2 - y1) / 56 + 1
            if xs.min() + 0.5 < x1 - mx or xs.max() + 0.5 > x2 + mx \
                    or ys.min() + 0.5 < y1 - my or ys.max() + 0.5 > y2 + my:
                raise SystemExit(f"serve: {where}: row {i}'s mask reaches outside its box")
    payload = serve.detections_json(outs)
    n_rle = 0
    for o, fr in zip(outs, payload["frames"]):
        keep = np.nonzero(o["valid"] & (o["scores"] >= 0.0))[0]
        if len(fr["masks_rle"]) != len(keep):
            raise SystemExit(f"serve: {where}: {len(fr['masks_rle'])} RLE masks for "
                             f"{len(keep)} detections")
        for i, r in zip(keep, fr["masks_rle"]):
            if not np.array_equal(rle.decode(r), (o["masks"][i] > 0.5).astype(np.uint8)):
                raise SystemExit(f"serve: {where}: row {i}'s RLE does not decode to its mask "
                                 "above 0.5")
            n_rle += 1
    return n_rle


def http_json(url: str, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.load(resp)


def phase_serve(dev):
    """Phase 6: the serving entry points at full width.  (a) detect with
    masks on 4 frames of 720x1280 and 1 of 1280x720, split into the
    forward, the paste on the card and the copy to the host; (b) the CLI in
    process (host ingest, its default, and --device_ingest once; --detect)
    and its HTTP server on a synthetic MovingFashion fixture."""
    t_phase = time.perf_counter()
    model = serving_model(dev)
    d = model.cfg.roi_heads.detections_per_img
    retr = SeamRetrieval(model, chunk=11)
    rng = np.random.RandomState(6)
    frames = ([synthetic_image(rng, 720, 1280)[0] for _ in range(4)]
              + [synthetic_image(rng, 1280, 720)[0]])
    retr.detect([frames[0], frames[4]])  # warm-up of both canvases and the mask head
    torch.cuda.synchronize()
    paths, report = {}, {}

    # (a) detect on in-memory frames, the JAX contract: [D, H, W] f32 on the host
    launch_counts(zero=True)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    outs = retr.detect(frames)
    detect_s = time.perf_counter() - t0
    paths["serve_detect"] = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    check_serve_path("serve_detect", paths["serve_detect"], detect=True)
    host_gb = sum(o["masks"].nbytes for o in outs) / 2**30

    # the same work step by step: the forward (28x28 probabilities), the
    # paste on the card, the copy to the host
    fwd = InferenceRunner(model, chunk=11, with_masks=True, with_match=False,
                          with_aggr_features=False, paste_full_masks=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = fwd(frames)
    forward_s = time.perf_counter() - t0
    # frame by frame as detect does (the paste freed before the next one), the
    # copies kept as detect keeps them; the checks after the timed loop
    paste_ms, copy_ms, hosts = [], [], []
    for f, o, r in zip(frames, outs, raw):
        if not np.array_equal(r["boxes"], o["boxes"]):
            raise SystemExit("serve: the forward-only run's boxes differ from detect's")
        m28, boxes = torch.as_tensor(r["masks"], device=dev), torch.as_tensor(r["boxes"],
                                                                              device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pasted = paste_masks(m28, boxes, *f.shape[:2])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        hosts.append(pasted.cpu().numpy())
        t2 = time.perf_counter()
        paste_ms.append((t1 - t0) * 1e3)
        copy_ms.append((t2 - t1) * 1e3)
        del pasted
    paste_s, copy_s = sum(paste_ms) / 1e3, sum(copy_ms) / 1e3
    err_cpu = err_detect = 0.0
    for f, o, r, host in zip(frames, outs, raw, hosts):
        err_detect = max(err_detect, float(np.abs(host - o["masks"]).max()))
        rows = np.nonzero(o["valid"])[0][:8]
        cpu = paste_masks(torch.from_numpy(r["masks"][rows]), torch.from_numpy(r["boxes"][rows]),
                          *f.shape[:2]).numpy()
        err_cpu = max(err_cpu, float(np.abs(cpu - host[rows]).max()))
    n = len(frames)
    n_rle = check_detections(outs, frames, d, "detect")
    above = sum(int((o["masks"][o["valid"]] > 0.5).any(axis=(1, 2)).sum()) for o in outs)
    log(f"serve: detect of {n} frames (4 x 720x1280, 1 x 1280x720, {d} rows each) in "
        f"{detect_s * 1e3:.1f} ms = {detect_s / n * 1e3:.1f} ms a frame; step by step, a frame: "
        f"forward {forward_s / n * 1e3:.1f} ms, paste on the card {paste_s / n * 1e3:.1f} ms, "
        f"copy to the host {copy_s / n * 1e3:.1f} ms (by frame: "
        + ", ".join(f"{t:.1f}" for t in copy_ms) + f"); peak card memory {peak_gb:.2f} GiB; "
        f"masks on the host {host_gb:.2f} GiB; launches {paths['serve_detect']}")
    log(f"serve: the card's paste of 8 rows a frame against the CPU's on the same 28x28 "
        f"probabilities and boxes: max abs err {err_cpu:.3g} (tolerance 1e-5); detect's masks "
        f"against the step-by-step paste: {err_detect:.3g}; {n_rle} RLE masks decode to the "
        f"masks above 0.5 ({above} rows with a pixel above 0.5); every mask 0 outside its box")
    if err_cpu > 1e-5 or err_detect > 1e-5:
        raise SystemExit("serve: the card's pasted masks disagree with the CPU paste")
    report["detect"] = {"frames": n, "ms_per_frame": detect_s / n * 1e3,
                        "forward_ms_per_frame": forward_s / n * 1e3,
                        "paste_ms_per_frame": paste_s / n * 1e3,
                        "copy_ms_per_frame": copy_s / n * 1e3, "copy_ms": copy_ms,
                        "paste_ms": paste_ms, "peak_gib": peak_gb,
                        "host_masks_gib": host_gb, "paste_max_abs_err_vs_cpu": err_cpu}
    del outs, raw, fwd, hosts
    torch.cuda.empty_cache()

    # (b) the CLI in process, then its HTTP server, on a synthetic fixture
    out_dir = Path("build") / "chip_smoke_serve"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    annots = make_synthetic_movingfashion(str(out_dir / "fixture"), n_products=3)
    data = json.loads(Path(annots).read_text())
    video = str(out_dir / "fixture" / data[sorted(data)[0]]["video_paths"][0])
    cli_s = {}
    old_tmp, tempfile.tempdir = tempfile.tempdir, str(out_dir)  # --synthetic's fixture
    try:
        for path, argv in (("serve_cli_query", ["--synthetic", "--topk", "2"]),
                           ("serve_cli_query_device_ingest",
                            ["--synthetic", "--topk", "2", "--device_ingest"]),
                           ("serve_cli_detect", ["--detect", video, "--n_frames", "4"])):
            buf = io.StringIO()
            launch_counts(zero=True)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                result = serve.main(argv)
            cli_s[path] = time.perf_counter() - t0
            paths[path] = launch_counts()
            lines = buf.getvalue().strip().splitlines()
            printed = json.loads(lines[-1])
            if path == "serve_cli_detect":
                check_serve_path(path, paths[path], detect=True)
                if printed != result or len(result["frames"]) != 4 or any(
                        r["size"] != [160, 200] for fr in result["frames"]
                        for r in fr["masks_rle"]):
                    raise SystemExit(f"serve: {path}: not 4 frames of 160x200 RLE masks")
                summary = f"{sum(len(fr['boxes']) for fr in result['frames'])} detections"
            else:
                check_serve_path(path, paths[path], detect=False)
                if not isinstance(result, RetrievalResult) or not 1 <= len(result.keys) <= 2 \
                        or printed["keys"] != list(result.keys) \
                        or not np.isfinite(result.scores).all() \
                        or not any("gallery index" in line for line in lines):
                    raise SystemExit(f"serve: {path}: no top-2 answer or no gallery index")
                summary = (f"top-2 {list(result.keys)}, track of {result.track_length} frames")
            log(f"serve: cli {' '.join(argv)}: {cli_s[path]:.1f} s (model, fixture, gallery and "
                f"request); {summary}; "
                f"launches {paths[path]}")
            del result
            torch.cuda.empty_cache()
    finally:
        tempfile.tempdir = old_tmp

    hretr = SeamRetrieval(model, chunk=11, ingest="host")  # the CLI's default ingest
    gallery = Gallery.load(serve.build_gallery_from_json(hretr, annots, str(out_dir / "fixture"))
                           .save(str(out_dir / "gallery")))
    server = serve.make_http_server(hretr, gallery, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    http_ms = {}
    try:
        health = http_json(base + "/healthz")
        products = http_json(base + "/v1/products")
        if health != {"status": "ok", "gallery_size": 3, "backend": "gpu"} \
                or products["keys"] != sorted(data):
            raise SystemExit(f"serve: http: /healthz or /v1/products: {health} {products}")
        for path, url, body in (
                ("serve_http_query", "/v1/query", {"video": video, "topk": 2, "n_frames": 4}),
                ("serve_http_detect", "/v1/detect", {"video": video, "n_frames": 4})):
            launch_counts(zero=True)
            times, answers = [], []
            for _ in range(2):
                t0 = time.perf_counter()
                answers.append(http_json(base + url, body))
                times.append((time.perf_counter() - t0) * 1e3)
            paths[path] = launch_counts()
            http_ms[path] = times
            check_serve_path(path, paths[path], detect=path == "serve_http_detect")
            if answers[0] != answers[1]:
                raise SystemExit(f"serve: http {url}: two requests gave different answers")
            a = answers[0]
            ok = (len(a.get("keys", ())) == 2 and a["track_length"] >= 1
                  if url == "/v1/query" else len(a.get("frames", ())) == 4)
            if not ok:
                raise SystemExit(f"serve: http {url}: unexpected answer {str(a)[:200]}")
            log(f"serve: http {url} (4 frames of 160x200, host ingest): "
                + ", ".join(f"{t:.1f}" for t in times) + f" ms; launches {paths[path]}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    report["cli_s"] = cli_s
    report["http_ms"] = http_ms
    report["seconds"] = time.perf_counter() - t_phase
    log(f"serve: phase 6 took {report['seconds']:.1f} s")
    return paths, report



# ---- phase 7: the training and evaluation command lines ----------------------------------

P1_CLI_NEVER = ("nlb_aggregate", "pairwise_scores", "roi_align_patch_int8")  # no K3, K4, K7
SEAM_STEP_NEVER = ("roi_align_adjoint", "roi_align_patch", "roi_align_patch_int8")  # no K5-K7
CLI_EVAL_PATH = ("fused_stem", "roi_align", "nlb_aggregate", "pairwise_scores")


class StopRun(Exception):
    """Raised by the resume check's hook once the mid slot of epoch 1 exists."""


def check_launches(path: str, counts, need, never) -> None:
    missing = [n for n in need if counts[n] == 0]
    launched = [n for n in never if counts[n] != 0]
    if missing or launched:
        raise SystemExit(f"cli: {path}: never launched {missing}; launched {launched}")


@contextlib.contextmanager
def patched(obj, name, make):
    """``obj.name`` replaced by ``make(original)`` for the block."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield orig
    finally:
        setattr(obj, name, orig)


def run_cli(main_fn, argv):
    """A CLI's ``main`` in process, its standard output kept; returns (what
    ``main`` returned, the output's lines, seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = main_fn(argv)
    return result, buf.getvalue().splitlines(), time.perf_counter() - t0


class CliRecorder:
    """The hooks phase 7 puts around the CLIs it calls: each checkpoint
    write (file, bytes, ms) and read (ms), each phase-1 step (a
    ``TimedTrainer``), each DF2 item loaded (index and the sums of its
    left and right 8-pixel strips, so a flip shows), each phase-2 epoch
    (a ``Timed`` runner and head step, and the launches of the epoch alone)
    and each evaluation (seconds, products, top-1), and optionally a stop
    once a mid slot of ``stop_epoch`` is written."""

    def __init__(self):
        self.reset()

    def reset(self, stop_epoch=None):
        self.saves, self.loads, self.trainers, self.items = [], [], [], []
        self.epochs, self.evals, self.ingest, self.stop_epoch = [], [], [], stop_epoch

    def install(self, stack: contextlib.ExitStack):
        rec = self

        def maybe_save(orig):
            def save(self, epoch, payload, final=False):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                orig(self, epoch, payload, final)
                ms = (time.perf_counter() - t0) * 1e3
                if final or (self.save_epochs > 0 and epoch % self.save_epochs == 0):
                    p = Path(self.directory) / ("final.pt" if final else f"epoch{epoch:03d}.pt")
                    rec.saves.append((p.name, p.stat().st_size, ms))
            return save

        def save_mid(orig):
            def save(self, payload):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                path = orig(self, payload)
                rec.saves.append(("mid.pt", Path(path).stat().st_size,
                                  (time.perf_counter() - t0) * 1e3))
                if payload["epoch"] == rec.stop_epoch:
                    raise StopRun
                return path
            return save

        def restore(orig):
            def load(path):
                t0 = time.perf_counter()
                out = orig(path)
                rec.loads.append((Path(path).name, (time.perf_counter() - t0) * 1e3))
                return out
            return load

        def getitem(orig):
            def item(self, idx):
                out = orig(self, idx)
                img = out[0]
                rec.items.append((int(idx), float(img[:, :8].sum()), float(img[:, -8:].sum())))
                return out
            return item

        def trainer(orig):
            def make(model, optimizer, mesh=None):
                t = TimedTrainer(orig(model, optimizer, mesh))
                rec.trainers.append(t)
                return t
            return make

        def phase2_epoch(orig):
            def epoch(runner, head_step, data, ep, *args, **kw):
                timed = Timed(runner, head_step, (), None, kw.get("score_thresh", 0.1))
                before, n_ingest = launch_counts(), len(rec.ingest)
                t0 = time.perf_counter()
                out = orig(timed, timed, data, ep, *args, **kw)
                after = launch_counts()
                rec.epochs.append({"timed": timed, "s": time.perf_counter() - t0,
                                   "ingest_s": rec.ingest[n_ingest:],
                                   "launches": {k: after[k] - before[k] for k in after}})
                return out
            return epoch

        def batches(orig):  # the runner's ingest: resize, canvases, upload
            def ingest(self, images):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = orig(self, images)
                torch.cuda.synchronize()
                rec.ingest.append(time.perf_counter() - t0)
                return out
            return ingest

        def evaluate(orig):
            def run(model, products, *args, **kw):
                n = [0]

                def counted(ps):
                    for p in ps:
                        n[0] += 1
                        yield p

                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = orig(model, counted(products), *args, **kw)
                rec.evals.append({"s": time.perf_counter() - t0, "products": n[0],
                                  "top1": [float(x) for x in out]})
                return out
            return run

        stack.enter_context(patched(ckpt_io.CheckpointManager, "maybe_save", maybe_save))
        stack.enter_context(patched(ckpt_io.CheckpointManager, "save_mid", save_mid))
        stack.enter_context(patched(ckpt_io, "restore_training_checkpoint", restore))
        stack.enter_context(patched(df2.DeepFashion2Dataset, "__getitem__", getitem))
        stack.enter_context(patched(train_matchrcnn, "Phase1Trainer", trainer))
        stack.enter_context(patched(InferenceRunner, "batches", batches))
        for mod, name in ((train_movingfashion, "train_one_epoch_movingfashion"),
                          (train_multidf2, "train_one_epoch_multidf2")):
            stack.enter_context(patched(mod, name, phase2_epoch))
        for mod in (train_movingfashion, train_multidf2, evaluate_movingfashion,
                    evaluate_multidf2):
            stack.enter_context(patched(mod, "evaluate", evaluate))


def mf_fixture(root: Path, n_train: int = 16, n_test: int = 4):
    """Two synthetic MovingFashion fixtures under one root: ``n_train``
    training and ``n_test`` test products, 12 frames of 360x640 each, other
    seeds so that the test products are not the training ones; returns the
    two JSON paths (``train.json``, ``test.json``)."""
    out = []
    for name, n, seed in (("train", n_train, 0), ("test", n_test, 1)):
        data = json.loads(Path(make_synthetic_movingfashion(
            str(root / name), n_products=n, n_frames=12, frame_size=(360, 640),
            seed=seed)).read_text())
        for entry in data.values():
            entry["img_path"] = f"{name}/{entry['img_path']}"
            entry["video_paths"] = [f"{name}/{v}" for v in entry["video_paths"]]
        path = root / f"{name}.json"
        path.write_text(json.dumps(data))
        out.append(str(path))
    return out


def state_of(path, reads=None):
    """A checkpoint file's payload on the host; with ``reads``, the file's
    name, size and read ms are appended to it."""
    t0 = time.perf_counter()
    out = torch.load(path, map_location="cpu", weights_only=True)
    if reads is not None:
        reads.append({"file": f"{Path(path).parent.name}/{Path(path).name}",
                      "bytes": Path(path).stat().st_size,
                      "read_ms": (time.perf_counter() - t0) * 1e3})
    return out


def phase_cli(dev):
    """Phase 7: the port's training and evaluation CLIs in process, on the
    card, at full width (their own model configs: 800x1344 canvases, bf16,
    seeded random weights), on synthetic DF2 and MovingFashion fixtures, in
    a temporary directory deleted at the end."""
    t_phase = time.perf_counter()
    paths, report = {}, {}
    rec = CliRecorder()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    cwd = os.getcwd()
    os.chdir(root)  # the in-loop evaluations write logs_mf/ and logs_mdf2/ to the cwd
    try:
        with contextlib.ExitStack() as stack:
            rec.install(stack)
            _phase_cli(dev, root, rec, paths, report)
    finally:
        os.chdir(cwd)
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    report["seconds"] = time.perf_counter() - t_phase
    log(f"cli: phase 7 took {report['seconds']:.1f} s")
    return paths, report


def _phase_cli(dev, root, rec, paths, report):
    t0 = time.perf_counter()
    img_dir, ann_dir = make_synthetic_df2(str(root / "df2"), n_products=8, views_per_side=3,
                                          image_size=(600, 800))
    ann = str(root / "df2" / "annots.json")
    _, lines, _ = run_cli(deepf_to_coco.main, ["--image_dir", img_dir, "--annos_dir", ann_dir,
                                               "--out", ann])
    mf_train, mf_test = mf_fixture(root / "mf")
    log(f"cli: fixtures in {time.perf_counter() - t0:.1f} s: DF2 {lines[-1]} (8 products x 3 "
        f"street + 3 shop views of 600x800), MovingFashion 16 + 4 products x 12 frames of "
        f"360x640")

    # (2) phase 1, bit-reproducible: deterministic algorithms for steps 2 and 3
    p1 = ["--root_train", img_dir, "--train_annots", ann, "--batch_size", "8", "--epochs", "2",
          "--save_epochs", "1", "--save_steps", "4", "--clip_grad_norm", "5.0",
          "--log_dir", str(root / "runs")]
    with warnings.catch_warnings(record=True) as nondet:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        rec.reset()
        launch_counts(zero=True)
        torch.cuda.reset_peak_memory_stats(dev)
        _, lines, full_s = run_cli(train_matchrcnn.main, p1 + ["--save_dir", str(root / "full")])
        paths["cli_train_matchrcnn"] = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
        (timed,) = rec.trainers
        full_items, full_saves = list(rec.items), list(rec.saves)
        # (3) the same command stopped once epoch 1's mid slot exists, then resumed
        rec.reset(stop_epoch=1)
        try:
            run_cli(train_matchrcnn.main, p1 + ["--save_dir", str(root / "res")])
            raise SystemExit("cli: the resume check's run was not stopped at epoch 1's mid slot")
        except StopRun:
            pass
        stopped_items = list(rec.items)
        rec.reset()
        launch_counts(zero=True)
        _, res_lines, res_s = run_cli(train_matchrcnn.main,
                                      p1 + ["--save_dir", str(root / "res"), "--auto_resume"])
        paths["cli_train_matchrcnn_resume"] = launch_counts()
        res_items, res_loads = list(rec.items), list(rec.loads)
        torch.use_deterministic_algorithms(False)
    for path in ("cli_train_matchrcnn", "cli_train_matchrcnn_resume"):
        check_launches(path, paths[path], TRAIN_PATH, P1_CLI_NEVER + ("roi_align_patch",))
    step_ms = [x * 1e3 for x in timed.times]
    n_steps, per_epoch = len(step_ms), len(step_ms) // 2
    steady = step_ms[1:per_epoch] + step_ms[per_epoch + 1:]  # each epoch's first step meets the
    # prefetcher starting up; the very first meets new shapes
    med = statistics.median(steady)
    losses = timed.losses
    if not all(np.isfinite(v) for lf in losses for v in lf.values()):
        raise SystemExit("cli: train_matchrcnn: a loss is not finite")
    reads = report.setdefault("reads", [])
    full = state_of(root / "full" / "matchrcnn" / "final.pt", reads)
    res = state_of(root / "res" / "matchrcnn" / "final.pt")
    init = init_model(serving_model_config(), video=False, seed=0, device="cpu")
    trainable = {n for n, p in init.named_parameters() if p.requires_grad}
    ref = init.state_dict()
    del init
    sd = full["model_state_dict"]
    still = [k for k in trainable if torch.equal(sd[k], ref[k])]
    frozen = [k for k in ref if k not in trainable and not k.startswith("roi_heads.")
              and k.startswith("backbone.body.")]
    changed = [k for k in frozen if not torch.equal(sd[k], ref[k])]
    if still or changed:
        raise SystemExit(f"cli: train_matchrcnn: trainable tensors that did not move {still[:5]}; "
                         f"frozen tensors that changed {changed[:5]}")
    log(f"cli: train_matchrcnn (the fixture's paths, batch 8, 2 epochs of {per_epoch} steps, "
        f"pallas_resident, deterministic algorithms) in {full_s:.1f} s: step ms median "
        f"{med:.1f} (steady steps), each " + ", ".join(f"{x:.1f}" for x in step_ms)
        + f"; {8e3 / med:.1f} images/s a step, {8 * n_steps / full_s:.1f} images/s over the "
        f"command; peak memory {peak_gb:.2f} GiB; losses first {losses[0]['loss']:.4f} last "
        f"{losses[-1]['loss']:.4f}, all finite; all {len(trainable)} trainable tensors moved, "
        f"all {len(frozen)} frozen backbone tensors (stem, layer1, FrozenBN) bit-equal; "
        f"launches {paths['cli_train_matchrcnn']}")
    log("cli: checkpoints written by train_matchrcnn: " + ", ".join(
        f"{n} {b / 1e9:.3f} GB in {ms:.0f} ms" for n, b, ms in full_saves)
        + "; read on resume: " + ", ".join(f"{n} in {ms:.0f} ms" for n, ms in res_loads))
    nondet = [w for w in nondet if "determinis" in str(w.message)]
    log(f"cli: warnings of torch.use_deterministic_algorithms: "
        f"{sorted({str(w.message)[:160] for w in nondet}) or 'none'}")

    # the resume check: the items loaded, the file's counters and every tensor
    skip = 4 * 8  # epoch 1's mid slot after its 4th batch
    want_items = full_items[12 * 8 + skip:]
    if res_items != want_items or stopped_items[:12 * 8 + skip] != full_items[:12 * 8 + skip]:
        raise SystemExit(f"cli: resume: the items loaded differ from the uninterrupted run's "
                         f"({len(res_items)} vs {len(want_items)})")
    if (res["epoch"], res["optimizer_count"]) != (full["epoch"], full["optimizer_count"]) \
            or full["optimizer_count"] != n_steps:
        raise SystemExit(f"cli: resume: epoch/optimizer_count {res['epoch']}/"
                         f"{res['optimizer_count']} against {full['epoch']}/"
                         f"{full['optimizer_count']} ({n_steps} steps)")
    if not any("mid-epoch resume: epoch 1, skipping 4 batches" in l for l in res_lines):
        raise SystemExit("cli: resume: the rerun did not resume inside epoch 1")
    diff = [k for k, v in sd.items() if not torch.equal(v, res["model_state_dict"][k])]
    mom = full["optimizer_state_dict"]["state"]
    mom_diff = [k for k, v in mom.items() if not torch.equal(
        v["momentum_buffer"], res["optimizer_state_dict"]["state"][k]["momentum_buffer"])]
    rel = max((float((v.float() - res["model_state_dict"][k].float()).abs().max()
                     / max(float((v.float() - ref[k].float()).abs().max()), 1e-30))
               for k, v in sd.items() if k in trainable), default=0.0)
    log(f"cli: resume check (bit-equality under torch.use_deterministic_algorithms): stopped at "
        f"epoch 1's mid slot, resumed with --auto_resume in {res_s:.1f} s; {len(res_items)} "
        f"items loaded after the skip, equal to the uninterrupted run's (indices and flips); "
        f"epoch {res['epoch']}, optimizer_count {res['optimizer_count']} equal; tensors that "
        f"differ: {len(diff)} of {len(sd)} (max difference over the update {rel:.3g}), momentum "
        f"buffers that differ: {len(mom_diff)}")
    if diff or mom_diff:
        raise SystemExit(f"cli: resume: the resumed run is not bit-equal: {diff[:5]}")
    report["train_matchrcnn"] = {
        "step_ms": step_ms, "step_ms_median_steady": med, "images_per_s_step": 8e3 / med,
        "images_per_s_command": 8 * n_steps / full_s, "command_s": full_s, "peak_gib": peak_gb,
        "loss_first": losses[0], "loss_last": losses[-1],
        "checkpoints": [{"file": n, "bytes": b, "save_ms": ms} for n, b, ms in full_saves],
        "loads": [{"file": n, "ms": ms} for n, ms in res_loads],
        "resume": {"bit_equal": True, "resumed_s": res_s, "items": len(res_items),
                   "optimizer_count": res["optimizer_count"],
                   "nondeterministic_warnings": len(nondet)}}
    del res

    # (4) one epoch on the window RoIAlign (K6 forward, K5 backward)
    rec.reset()
    launch_counts(zero=True)
    _, _, pallas_s = run_cli(train_matchrcnn.main, [
        "--root_train", img_dir, "--train_annots", ann, "--epochs", "1", "--clip_grad_norm",
        "5.0", "--roi_backend", "pallas", "--save_dir", str(root / "pallas"), "--log_dir",
        str(root / "runs")])
    paths["cli_train_matchrcnn_pallas"] = launch_counts()
    check_launches("cli_train_matchrcnn_pallas", paths["cli_train_matchrcnn_pallas"],
                   TRAIN_PALLAS_PATH, P1_CLI_NEVER)
    (ptimed,) = rec.trainers
    pms = [x * 1e3 for x in ptimed.times]
    if not all(np.isfinite(v) for lf in ptimed.losses for v in lf.values()):
        raise SystemExit("cli: train_matchrcnn --roi_backend pallas: a loss is not finite")
    log(f"cli: train_matchrcnn --roi_backend pallas, 1 epoch in {pallas_s:.1f} s: step ms median "
        f"{statistics.median(pms[1:]):.1f}, each " + ", ".join(f"{x:.1f}" for x in pms)
        + f"; launches {paths['cli_train_matchrcnn_pallas']}")
    report["train_matchrcnn_pallas"] = {"step_ms": pms, "command_s": pallas_s}
    shutil.rmtree(root / "pallas")

    # (5), (6) phase 2 from the phase-1 final.pt, then (7) both evaluations
    p1_final = str(root / "full" / "matchrcnn" / "final.pt")
    p1_sd = full["model_state_dict"]
    mp_keys = [k for k in p1_sd if k.startswith("roi_heads.match_predictor.")]
    for name, main_fn, argv, eval_fn, eval_argv in (
            ("movingfashion", train_movingfashion.main,
             ["--root", str(root / "mf"), "--train_annots", mf_train, "--test_annots", mf_test,
              "--epochs", "2", "--eval_freq", "1"],
             evaluate_movingfashion.main,
             ["--root", str(root / "mf"), "--test_annots", mf_test]),
            ("multidf2", train_multidf2.main,
             ["--root_train", img_dir, "--train_annots", ann, "--root_test", img_dir,
              "--test_annots", ann, "--epochs", "1", "--n_shops", "8"],
             evaluate_multidf2.main,
             ["--root_test", img_dir, "--test_annots", ann])):
        rec.reset()
        launch_counts(zero=True)
        torch.cuda.reset_peak_memory_stats(dev)
        _, lines, cmd_s = run_cli(main_fn, argv + [
            "--pretrained_path", p1_final, "--save_dir", str(root / name), "--log_dir",
            str(root / "runs")])
        path = f"cli_train_{name}"
        paths[path] = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
        check_launches(path, paths[path], CLI_EVAL_PATH, SEAM_STEP_NEVER)
        for i, ep in enumerate(rec.epochs):  # the epochs' own launches: no K3, K4 there
            check_launches(f"{path} epoch {i}", ep["launches"], SEAM_PATH,
                           SEAM_IDLE + SEAM_STEP_NEVER)
        tag = "seam_mf" if name == "movingfashion" else "seam_mdf2"
        final_path = root / name / tag / "final.pt"
        final = state_of(final_path, reads)
        fsd = final["model_state_dict"]
        det_diff = [k for k in p1_sd if not k.startswith("roi_heads.match_predictor.")
                    and not torch.equal(fsd[k], p1_sd[k])]
        mp_moved = [k for k in mp_keys if not torch.equal(fsd[k], p1_sd[k])]
        ta_moved = [k for k in mp_keys if not torch.equal(
            fsd[k.replace("match_predictor", "temporal_aggregator")], p1_sd[k])]
        steps = final["optimizer_count"]
        aggr = [lf.get("aggregation_loss") for ep in rec.epochs for lf in ep["timed"].losses]
        infer_ms = [x * 1e3 for ep in rec.epochs for x in ep["timed"].infer_s]
        head_ms = [x * 1e3 for ep in rec.epochs for x in ep["timed"].step_s]
        ingest_ms = [x * 1e3 for ep in rec.epochs for x in ep["ingest_s"]]
        rows = [r for ep in rec.epochs for r in ep["timed"].rows]
        n_images = 16 * 11 if name == "movingfashion" else 8 * 11
        if det_diff:
            raise SystemExit(f"cli: {path}: the frozen detector changed: {det_diff[:5]}")
        if name == "multidf2" and mp_moved:
            raise SystemExit(f"cli: {path}: the match predictor changed: {mp_moved[:5]}")
        if steps == 0 or not ta_moved or (name == "movingfashion" and not mp_moved):
            raise SystemExit(f"cli: {path}: {steps} head steps; heads moved: match predictor "
                             f"{len(mp_moved)}, aggregator trunk {len(ta_moved)}")
        if not all(np.isfinite(v) for ep in rec.epochs for lf in ep["timed"].losses
                   for v in lf.values()):
            raise SystemExit(f"cli: {path}: a loss is not finite")
        log(f"cli: train_{name} (warm start from the phase-1 final.pt, {n_images} images a "
            f"product batch) in {cmd_s:.1f} s: ms per product batch (inference + head step) "
            + ", ".join(f"{a:.1f} + {b:.1f}" for a, b in zip(infer_ms, head_ms))
            + "; of the inference, the host ingest (cv2 resize, canvas fill, one upload) "
            + ", ".join(f"{x:.1f}" for x in ingest_ms) + f" ms; rows {rows}; aggregation "
            f"losses {aggr}"
            + (" (a zero aggregation loss: no weak positive reached it)"
               if any(a == 0.0 for a in aggr) else "")
            + f"; {steps} head steps; in-loop evaluations "
            + ", ".join(f"{e['s']:.2f} s for {e['products']} products, top-1 {e['top1']}"
                        for e in rec.evals)
            + f"; peak memory {peak_gb:.2f} GiB; detector bit-equal, match predictor "
            + ("bit-equal" if not mp_moved else f"moved ({len(mp_moved)} tensors)")
            + f", aggregator trunk moved ({len(ta_moved)} tensors); launches {paths[path]}; "
            f"epochs' own launches {[ep['launches'] for ep in rec.epochs]}")
        log(f"cli: checkpoints written by train_{name}: " + ", ".join(
            f"{n} {b / 1e9:.3f} GB in {ms:.0f} ms" for n, b, ms in rec.saves))
        report[f"train_{name}"] = {
            "command_s": cmd_s, "inference_ms": infer_ms, "ingest_ms": ingest_ms,
            "head_step_ms": head_ms, "rows": rows,
            "aggregation_loss": aggr, "head_steps": steps, "peak_gib": peak_gb,
            "evals": list(rec.evals),
            "checkpoints": [{"file": n, "bytes": b, "save_ms": ms} for n, b, ms in rec.saves]}

        rec.reset()
        launch_counts(zero=True)
        top1, _, eval_s = run_cli(eval_fn, eval_argv + ["--ckpt_path", str(final_path)])
        path = f"cli_evaluate_{name}"
        paths[path] = launch_counts()
        check_launches(path, paths[path], CLI_EVAL_PATH, SEAM_STEP_NEVER)
        (ev,) = rec.evals
        if len(top1) != 3 or not all(0.0 <= float(x) <= 1.0 for x in top1):
            raise SystemExit(f"cli: {path}: top-1 {top1}")
        log(f"cli: evaluate_{name} on its final.pt in {eval_s:.1f} s: {ev['products']} products "
            f"in {ev['s']:.2f} s = {ev['s'] / max(ev['products'], 1):.3f} s a product; top-1 "
            f"single/avg/aggr {[float(x) for x in top1]}; launches {paths[path]}")
        report[f"evaluate_{name}"] = {"command_s": eval_s, "eval_s": ev["s"],
                                      "products": ev["products"],
                                      "s_per_product": ev["s"] / max(ev["products"], 1),
                                      "top1": [float(x) for x in top1]}
        if name == "movingfashion":
            mf_final = str(final_path)
        torch.cuda.empty_cache()

    # (8) the port's own phase-2 file behind SeamRetrieval.from_checkpoint
    t0 = time.perf_counter()
    retr = SeamRetrieval.from_checkpoint(mf_final, device=dev)
    load_s = time.perf_counter() - t0
    data = json.loads(Path(mf_test).read_text())
    shops = load_image_frames([str(root / "mf" / data[k]["img_path"]) for k in sorted(data)])
    gallery = retr.build_gallery(shops, keys=sorted(data))
    launch_counts(zero=True)
    frames = decode_video_frames(str(root / "mf" / data[sorted(data)[0]]["video_paths"][0]), 10)
    result = retr.retrieve(frames, gallery, k=2)
    paths["cli_from_checkpoint_query"] = launch_counts()
    check_launches("cli_from_checkpoint_query", paths["cli_from_checkpoint_query"],
                   SERVING_PATH, SERVE_IDLE)
    if len(result.keys) != 2 or not np.isfinite(result.scores).all():
        raise SystemExit(f"cli: from_checkpoint: no top-2 answer ({result})")
    log(f"cli: SeamRetrieval.from_checkpoint(train_movingfashion's final.pt) in {load_s:.1f} s; "
        f"a query of 10 frames against its 4 test shops: top-2 {list(result.keys)} scores "
        f"{[round(float(s), 4) for s in result.scores]}; launches "
        f"{paths['cli_from_checkpoint_query']}")
    report["from_checkpoint"] = {"load_s": load_s, "keys": list(result.keys)}
    log("cli: checkpoint files read to the host (torch.load, weights_only): " + ", ".join(
        f"{r['file']} {r['bytes'] / 1e9:.3f} GB in {r['read_ms']:.0f} ms" for r in reads))



# ---- phase 8: the distributed paths, two ranks on the one card ---------------------------

DIST_WORLD = 2
DIST_TIMEOUT_S = 600
DIST_ORDER = (0, 1, 6, 7, 2, 3, 4, 5)  # the global batch: rank 0's images, then rank 1's
DIST_TRAIN_SIZES = [(600, 800), (720, 1280), (480, 640), (768, 1024), (540, 960), (500, 900),
                    (640, 960), (450, 800)]


def dist_draws(model, batch, n_images, seed, g_max=24):
    """The samplers' uniforms of ``n_images`` images on ``batch``'s canvas,
    drawn from ``seed`` (the same on every rank): "rpn" [n, anchors], "roi"
    [n, post_nms_top_n_train + g_max]."""
    from seam_match_rcnn_tpu_torch.models.anchors import grid_anchors

    cfg, dev = model.cfg, batch["images"].device
    canvas = h, w = tuple(batch["images"].shape[-2:])
    shapes = [(h // s, w // s) for s in (4, 8, 16, 32)]
    shapes.append(((shapes[-1][0] - 1) // 2 + 1, (shapes[-1][1] - 1) // 2 + 1))
    n_anchors = sum(len(a) for a in grid_anchors(canvas, tuple(shapes), tuple(cfg.anchors.sizes),
                                                  tuple(cfg.anchors.aspect_ratios)))
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {"rpn": torch.rand((n_images, n_anchors), generator=gen, device=dev),
            "roi": torch.rand((n_images, cfg.rpn.post_nms_top_n_train + g_max), generator=gen,
                              device=dev)}


def trained_state(model, optimizer=None):
    """The trainable parameters and BatchNorm statistics (and with
    ``optimizer`` the momentum buffers), cloned on the card."""
    out = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    out.update({n: b.detach().clone() for n, b in model.named_buffers() if "running_" in n})
    if optimizer is not None:
        for i, p in enumerate(optimizer.params):
            buf = optimizer.optimizer.state.get(p, {}).get("momentum_buffer")
            if buf is not None:
                out[f"momentum:{i}"] = buf.detach().clone()
    return out


def state_digest(state) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        t = state[k].detach().cpu().contiguous().reshape(-1)
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def timed_sync(optimizer, times):
    """``optimizer``'s gradient all-reduce, timed on a synchronised clock."""
    sync = optimizer._sync_gradients

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sync()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)

    optimizer._sync_gradients = run


def dist_train(rank, dev, mesh):
    """The phase-1 DP step at full width: 3 global steps of 8 images (4 a
    rank, one bucket, street and shop on both ranks, every pair across
    them) of the bf16 training model, bit-equal ranks; one step under the
    "pallas" backend; and one step of the model in f32, whose update rank 0
    holds against the one-process step on the 8 images with the same draws:
    the whole update (every trainable tensor and BatchNorm statistic, one
    L2 norm) within 1e-3 of the one-process update's norm, each tensor
    within 0.1 of its own update.  A forward over 4 images is not bit-equal
    to one over 8 (cuDNN's algorithms and sum orders differ; in bf16 the
    rounding of every activation), and near-tied proposals then rank apart
    before the samplers, which moves the small updates of layer2 by a few
    percent; a W-fold or 1/W gradient, or a rank-local BatchNorm, is off by
    half a tensor's update or more."""
    from seam_match_rcnn_tpu_torch.parallel.mesh import shard_batch
    from seam_match_rcnn_tpu_torch.train.engine import bucket_batches

    images, targets = train_batch(np.random.RandomState(11), DIST_TRAIN_SIZES)
    images, targets = [images[i] for i in DIST_ORDER], [targets[i] for i in DIST_ORDER]
    out = {}
    for name, backend, dtype, n_steps in (("pallas_resident", "pallas_resident", None, 3),
                                          ("pallas", "pallas", None, 1),
                                          ("f32", "pallas_resident", "float32", 1)):
        model, timed = train_model(dev, backend, mesh, dtype)
        opt = timed.optimizer
        ar_ms = []
        timed_sync(opt, ar_ms)
        glob = bucket_batches(model, images, targets, 24, dev)
        assert len(glob) == 1
        batches = shard_batch(glob, mesh)  # this rank's 4 images
        before = trained_state(model)
        launch_counts(zero=True)
        after1 = None
        for s in range(n_steps):
            timed.step(batches, draws=[shard_batch(dist_draws(model, glob[0], 8, 1000 + s),
                                                   mesh)])
            if s == 0:
                after1 = trained_state(model)
        counts = launch_counts()
        grad_bytes = 4 * (sum(p.numel() for p in opt.params) + len(opt.params))
        out[name] = {"step_ms": [t * 1e3 for t in timed.times], "allreduce_ms": ar_ms,
                     "grad_bytes": grad_bytes, "launches": counts, "losses": timed.losses,
                     "digest": state_digest(trained_state(model, opt))}
        log(f"dist rank {rank}: phase-1 DP steps ({name}, 4 images a rank, one bucket) "
            + ", ".join(f"{t:.1f}" for t in out[name]["step_ms"]) + " ms; gradient "
            f"all-reduce {', '.join(f'{t:.1f}' for t in ar_ms)} ms of {grad_bytes / 1e6:.1f} MB; "
            f"launches K1 {counts['fused_stem']}, K2 {counts['roi_align']}, K5 "
            f"{counts['roi_align_adjoint']}, K6 {counts['roi_align_patch']}")
        need = TRAIN_PATH if backend == "pallas_resident" else TRAIN_PALLAS_PATH
        missing = [n for n in need if counts[n] == 0]
        if missing:
            raise SystemExit(f"dist rank {rank}: the DP step ({name}) never launched {missing}")
        if name == "f32":
            dist.barrier()
            if rank == 0:  # the one-process step on the global batch, the same draws
                ref, ref_timed = train_model(dev, backend, compute_dtype=dtype)
                ref_timed.step(glob, draws=[dist_draws(ref, glob[0], 8, 1000)])
                want = trained_state(ref)
                bad, worst = compare_head_updates(before, want, after1, rtol=0.1)
                whole = float(torch.sqrt(sum(((after1[k] - want[k]).double() ** 2).sum()
                                             for k in want) / sum(
                    ((want[k] - before[k]).double() ** 2).sum() for k in want)))
                out["one_process"] = {"bad": bad[:5], "worst": worst, "whole": whole,
                                      "step_ms": ref_timed.times[0] * 1e3,
                                      "losses": ref_timed.losses[0]}
                log(f"dist rank 0: the f32 DP update against the one-process step on the 8 "
                    f"images: the whole update {whole:.3e} off (limit 1e-3); worst tensor "
                    f"{worst:.3e} of its update (limit 0.1), {len(bad)} outside; losses "
                    f"{timed.losses[0]['loss']:.6f} / {ref_timed.losses[0]['loss']:.6f}")
                if bad or not whole <= 1e-3:
                    raise SystemExit(f"dist: the DP update is off the one-process step by "
                                     f"{whole:.3e}: {bad[:5]}")
                del ref, ref_timed, want
            dist.barrier()
        del model, timed, opt, before, after1, glob, batches
        torch.cuda.empty_cache()
    return out


def dist_head_batches(kind, dev):
    """Both ranks' own product batches at phase 5's shapes (256 rows,
    MovingFashion 16 products x (1 shop + 10 frames), MultiDF2 8 x (1 + 10),
    2 detections an image), from seeds, the same on every rank."""
    out = []
    for r in range(DIST_WORLD):
        rng = np.random.RandomState(100 + r)
        gen = torch.Generator(device=dev).manual_seed(100 + r)
        p, t = (16, 10) if kind == "mf" else (8, 10)
        n, d = p * (1 + t), 2
        roi = (torch.randn((n, d, 256, 14, 14), generator=gen, device=dev)
               + 2.0 * torch.randn((n, d, 256, 1, 1), generator=gen, device=dev))
        if kind == "mf":
            outs = [{"scores": rng.uniform(0.2, 1.0, d).astype(np.float32),
                     "boxes": np.sort(rng.uniform(0, 500, (d, 2, 2)), 1).transpose(
                         0, 2, 1).reshape(d, 4).astype(np.float32),
                     "valid": np.ones(d, bool)} for _ in range(n)]
            sel = select_rows_host(outs, ([1] + [0] * t) * p, [i // (1 + t) for i in range(n)],
                                   0.1, p, t, 256)
            batch = {k: getattr(sel, k) for k in ("row_img", "row_det", "valid", "types",
                                                  "prod", "img_slot", "shop_row")}
            batch["aggr_weight"] = np.float32(1.0)
        else:
            rows = [(j * (1 + t) + f, 0) for j in range(p) for f in range(1 + t)]
            row_img = np.zeros(256, np.int32)
            row_det = np.zeros(256, np.int32)
            row_img[:len(rows)] = [r_[0] for r_ in rows]
            seq = np.asarray([[j * (1 + t) + 1 + f for f in range(t)] for j in range(p)], np.int32)
            batch = {"row_img": row_img, "row_det": row_det, "seq_gather": seq,
                     "seq_mask": np.ones((p, t), bool),
                     "shop_row": np.asarray([j * (1 + t) for j in range(p)], np.int32)}
        batch["roi_src"] = roi
        out.append(batch)
    return out


def dist_heads(rank, dev, mesh):
    """The MovingFashion and MultiDF2 head steps over both ranks' own product
    batches (``seam.global_products``), against the one-process step on the
    concatenated batch; a case where one rank selects no rows."""
    from seam_match_rcnn_tpu_torch.models.match_head import MatchPredictor, TemporalAggregator
    from seam_match_rcnn_tpu_torch.parallel.collectives import all_gather
    from seam_match_rcnn_tpu_torch.train.seam import global_products

    group = mesh.get_group("data")
    out = {}
    for kind, empty in (("mf", None), ("mf", 1), ("mdf2", None), ("mdf2", 0)):
        name = f"{kind}" + ("" if empty is None else f"_rank{empty}_empty")
        locals_ = dist_head_batches(kind, dev)
        p, t = (16, 10) if kind == "mf" else (8, 10)
        glob = []
        for r, b in enumerate(locals_):
            b = {k: (v if isinstance(v, torch.Tensor) else np.asarray(v).copy())
                 for k, v in b.items()}
            if r == empty:
                for key in ("valid", "seq_mask"):
                    if key in b:
                        b[key][:] = False
                b["shop_row"][:] = -1
            b["has_rows"] = np.asarray([r != empty])
            glob.append(b)
        mine = global_products({k: v for k, v in glob[rank].items() if k != "roi_src"}, rank,
                               DIST_WORLD, p, t, lambda a: all_gather(
                                   torch.as_tensor(a, device=dev), group).cpu().numpy())

        def heads():
            torch.manual_seed(7)
            return (MatchPredictor(torch.float32).to(dev),
                    TemporalAggregator(torch.float32, "xla").to(dev))

        def step(mp, ta, use_mesh):
            tc = SEAMTrainConfig()
            lr = tc.lr if kind == "mf" else 0.02
            params = list(ta.parameters()) + ([] if kind == "mdf2" else list(mp.parameters()))
            opt = SGD(params, lambda s: lr, tc.momentum, tc.weight_decay)
            m = mesh if use_mesh else None
            if kind == "mf":
                return make_seam_head_step(mp, ta, opt, frames_per_product=t, n_frames=3, mesh=m)
            return make_mdf2_head_step(ta, opt, mesh=m)

        mp, ta = heads()
        before = {f"mp.{k}": v.clone() for k, v in mp.state_dict().items()}
        before.update({f"ta.{k}": v.clone() for k, v in ta.state_dict().items()})
        batch = {k: torch.as_tensor(v, device=dev) for k, v in mine.items()}
        batch["roi_src"] = glob[rank]["roi_src"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = step(mp, ta, True)(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {f"mp.{k}": v for k, v in mp.state_dict().items()}
        got.update({f"ta.{k}": v for k, v in ta.state_dict().items()})
        # the one-process step on the concatenated batch (rank 0's rows and images first)
        n0 = glob[0]["roi_src"].shape[0]
        one = {"roi_src": torch.cat([g["roi_src"] for g in glob]),
               "row_img": np.concatenate([glob[0]["row_img"], glob[1]["row_img"] + n0]),
               "row_det": np.concatenate([g["row_det"] for g in glob])}
        for key in ("valid", "types"):
            if key in mine:
                one[key] = np.concatenate([g[key] for g in glob])
        if kind == "mf":
            one["prod"] = np.concatenate([glob[r]["prod"] + r * p for r in range(DIST_WORLD)])
            one["img_slot"] = np.concatenate([glob[r]["img_slot"] + r * p * t
                                              for r in range(DIST_WORLD)])
            one["aggr_weight"] = mine["aggr_weight"]
        for key in ("shop_row", "seq_gather", "seq_mask"):
            if key in mine:
                one[key] = mine[key]
        one = {k: torch.as_tensor(v, device=dev) for k, v in one.items()}
        rmp, rta = heads()
        want_losses = step(rmp, rta, False)(one)
        want = {f"mp.{k}": v for k, v in rmp.state_dict().items()}
        want.update({f"ta.{k}": v for k, v in rta.state_dict().items()})
        bad, worst = compare_head_updates(before, want, got, rtol=5e-3)
        own = glob[rank]
        rows = int(own["valid"].sum()) if "valid" in own else int(
            own["seq_mask"].sum() + (own["shop_row"] >= 0).sum())
        out[name] = {"ms": ms, "worst": worst, "bad": bad[:5], "digest": state_digest(got),
                     "losses": {k: float(v) for k, v in losses.items()},
                     "one_process_losses": {k: float(v) for k, v in want_losses.items()}}
        log(f"dist rank {rank}: {kind} head step over both ranks' rows ({name}; this rank "
            f"{rows} rows of its 256) {ms:.1f} ms; loss {out[name]['losses']['loss']:.6f}, "
            f"one process {out[name]['one_process_losses']['loss']:.6f}; worst parameter "
            f"{worst:.3e} of its update (limit 5e-3)")
        if bad:
            raise SystemExit(f"dist: the {name} head step is off the one-process step: {bad}")
    # no rows on any rank: every rank skips, nothing moves
    mp, ta = MatchPredictor(torch.float32).to(dev), TemporalAggregator(torch.float32, "xla").to(dev)
    sd = {k: v.clone() for k, v in ta.state_dict().items()}
    opt = SGD(list(mp.parameters()) + list(ta.parameters()), lambda s: 0.04, 0.9, 5e-4)
    b = {k: (v if isinstance(v, torch.Tensor) else np.asarray(v).copy())
         for k, v in dist_head_batches("mf", dev)[rank].items()}
    b["valid"][:] = False
    b["shop_row"][:] = -1
    b["has_rows"] = np.asarray([False])
    roi = b.pop("roi_src")
    b = {k: torch.as_tensor(v, device=dev) for k, v in global_products(
        b, rank, DIST_WORLD, 16, 10, lambda a: all_gather(torch.as_tensor(a, device=dev),
                                                         group).cpu().numpy()).items()}
    b["roi_src"] = roi
    skipped = make_seam_head_step(mp, ta, opt, frames_per_product=10, mesh=mesh)(b) is None
    if not skipped or any(not torch.equal(v, ta.state_dict()[k]) for k, v in sd.items()):
        raise SystemExit("dist: a head step with no rows on any rank did not skip")
    out["all_empty_skipped"] = skipped
    log(f"dist rank {rank}: no rows on any rank: the step skipped on every rank")
    return out


def dist_runner(rank, dev, mesh):
    """``InferenceRunner(mesh=...)`` at chunk 8 on the serving model against
    the one-process runner at chunk 4 (each rank's share of a chunk), on 8
    landscape and 8 portrait images: bit-equal."""
    model = serving_model(dev)
    rng = np.random.RandomState(21)
    images = [synthetic_image(rng, h, w)[0] for h, w in [(600, 800)] * 8 + [(800, 600)] * 8]
    launch_counts(zero=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        got = InferenceRunner(model, chunk=8, mesh=mesh).run(images, device_keys=())[0]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    with torch.no_grad():
        want = InferenceRunner(model, chunk=4)(images)
    diff = [f"{i}:{k}" for i, (a, b) in enumerate(zip(got, want)) for k in b
            if not np.array_equal(a[k], b[k])]
    log(f"dist rank {rank}: runner mesh (chunk 8 over 2 ranks, 16 images) {ms:.1f} ms; "
        f"against one process at chunk 4: {len(diff)} arrays differ; launches K1 "
        f"{counts['fused_stem']}, K2 {counts['roi_align']}")
    if diff or counts["fused_stem"] == 0 or counts["roi_align"] == 0:
        raise SystemExit(f"dist: runner mesh: differs at {diff[:5]}, launches {counts}")
    del model
    torch.cuda.empty_cache()
    return {"ms": ms, "launches": counts, "n_images": len(images)}


def dist_score(rank, dev):
    """``score_matrix_sharded`` 1000x1000 over ``model=2`` against
    ``score_matrix`` (K4 on the whole matrix), within K4's 1e-5."""
    from seam_match_rcnn_tpu_torch.eval.gallery import score_matrix_sharded
    from seam_match_rcnn_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data=1, model=DIST_WORLD)
    gen = torch.Generator(device=dev).manual_seed(5)
    x, y = (torch.randn((1000, 256), generator=gen, device=dev) for _ in range(2))
    w = torch.randn((2, 256), generator=gen, device=dev) * 0.05
    b = torch.randn((2,), generator=gen, device=dev)
    launch_counts(zero=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = score_matrix_sharded(x, y, w, b, mesh, axis="model")
    ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    err = float(np.abs(got - score_matrix(x, y, w, b)).max())
    log(f"dist rank {rank}: score_matrix_sharded 1000x1000 over model=2 {ms:.2f} ms (500 "
        f"queries a rank, one gather), max abs err {err:.3g} against score_matrix (limit "
        f"1e-5); launches K4 {counts['pairwise_scores']}")
    if err > 1e-5 or counts["pairwise_scores"] == 0:
        raise SystemExit(f"dist: score_matrix_sharded off by {err}, launches {counts}")
    return {"ms": ms, "max_abs_err": err, "launches": counts}


def dist_cli(rank, dev, root: Path, port: int):
    """``cli/train_matchrcnn.py`` under torchrun's environment
    (SEAM_MULTIHOST=1, the env rendezvous, SEAM_DIST_BACKEND=gloo) on the DF2
    fixture at full width, batch 8 a rank: stopped after its first mid save
    (step 1), rerun with ``--auto_resume``.  Returns the files this rank
    wrote, the file each rank resumed from, step times, launches and a
    digest of the trained model and momentum."""
    from seam_match_rcnn_tpu_torch.cli import train_matchrcnn as cli

    os.environ.update(SEAM_MULTIHOST="1", SEAM_DIST_BACKEND="gloo", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(DIST_WORLD),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(DIST_WORLD))
    wrote, resumed, trainers = [], [], []
    argv = ["--root_train", str(root / "df2" / "image"), "--train_annots",
            str(root / "df2" / "annots.json"), "--batch_size", "8", "--epochs", "1",
            "--save_epochs", "1", "--save_steps", "2", "--save_dir", str(root / "ckpt"),
            "--log_dir", str(root / "runs"), "--device", dev.type]

    class Trainer(cli.Phase1Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.times = []
            trainers.append(self)

        def step(self, batches, generator=None, draws=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super().step(batches, generator, draws)
            torch.cuda.synchronize()
            self.times.append(time.perf_counter() - t0)
            return out

    def stop_after(orig):
        def save_mid(self, payload):
            orig(self, payload)
            raise StopRun()
        return save_mid

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(os, "replace", lambda orig: lambda src, dst: (
            wrote.append(os.path.basename(dst)), orig(src, dst))[1]))
        stack.enter_context(patched(ckpt_io, "resolve_auto_resume", lambda orig: lambda *a: (
            resumed.append(orig(*a)), resumed[-1])[1]))
        stack.enter_context(patched(cli, "Phase1Trainer", lambda orig: Trainer))
        launch_counts(zero=True)
        t0 = time.perf_counter()
        with patched(ckpt_io.CheckpointManager, "save_mid", stop_after):
            try:
                cli.main(argv)
            except StopRun:
                pass
        cli.main(argv + ["--auto_resume"])
        seconds = time.perf_counter() - t0
        counts = launch_counts()
    model, opt = trainers[-1].model, trainers[-1].optimizer
    step_ms = [t * 1e3 for tr in trainers for t in tr.times]
    log(f"dist rank {rank}: train_matchrcnn under torchrun's environment (2 ranks, batch 8 a "
        f"rank): steps " + ", ".join(f"{t:.1f}" for t in step_ms) + f" ms, {seconds:.1f} s "
        f"with the stop and the resume; wrote {wrote}; resumed from {resumed}; launches K1 "
        f"{counts['fused_stem']}, K2 {counts['roi_align']}, K5 {counts['roi_align_adjoint']}")
    missing = [n for n in TRAIN_PATH if counts[n] == 0]
    if missing:
        raise SystemExit(f"dist: train_matchrcnn never launched {missing}")
    return {"wrote": wrote, "resumed": resumed, "step_ms": step_ms, "seconds": seconds,
            "count": opt.count, "launches": counts,
            "digest": state_digest(dict(trained_state(model, opt),
                                        **{f"all:{k}": v for k, v in
                                           model.state_dict().items()}))}


DIST_PHASE2 = {  # kind: (CLI module name, save tag, epoch loop, head-step maker, artifacts)
    "mf": ("train_movingfashion", "seam_mf", "train_one_epoch_movingfashion",
           "make_seam_head_step", "logs_mf/metrics.json"),
    "mdf2": ("train_multidf2", "seam_mdf2", "train_one_epoch_multidf2", "make_mdf2_head_step",
             "logs_mdf2/metrics.json"),
}


def dist_cli_phase2(rank, dev, root: Path, kind: str):
    """A phase-2 CLI under torchrun's environment (set by ``dist_cli``, whose
    process group it joins) at full width on phase 8's fixtures, 4 products a
    rank in product batches of 2 (2 steps a rank), warm-started from the
    two-rank phase-1 run's final.pt: stopped after its first mid save (step
    1), rerun with ``--auto_resume``.  Returns the files this rank wrote,
    the file each rank resumed from, the product batches each run's epoch
    loop took, whether this rank's working directory holds the in-loop
    evaluation's artifacts, the head steps' and their gradient all-reduce's
    ms, launches and a digest of the trained model and momentum."""
    import importlib

    name, tag, epoch_name, head_name, artifacts = DIST_PHASE2[kind]
    cli = importlib.import_module(f"seam_match_rcnn_tpu_torch.cli.{name}")
    work = root / f"{kind}_rank{rank}"
    work.mkdir(exist_ok=True)
    cwd = os.getcwd()
    os.chdir(work)  # the in-loop evaluation writes its artifacts to the cwd
    wrote, resumed, batches, models, optimizers, head_ms, ar_ms = [], [], [], [], [], [], []
    data = (["--root", str(root / "mf"), "--train_annots", str(root / "mf" / "train.json"),
             "--test_annots", str(root / "mf" / "test.json")] if kind == "mf" else
            ["--root_train", str(root / "mdf2" / "image"), "--train_annots",
             str(root / "mdf2" / "annots.json"), "--root_test", str(root / "mdf2" / "image"),
             "--test_annots", str(root / "mdf2" / "annots.json")])
    argv = data + ["--n_shops", "2", "--epochs", "1", "--eval_freq", "1", "--save_steps", "1",
                   "--pretrained_path", str(root / "ckpt" / "matchrcnn" / "final.pt"),
                   "--save_dir", str(root / "ckpt"), "--log_dir", str(root / "runs"),
                   "--device", dev.type]

    def counted(orig):
        def epoch(runner, head_step, data, *a, **kw):
            def taken(items_iter):
                batches.append(0)
                for items in items_iter:
                    batches[-1] += 1
                    yield items

            def timed_head(batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = head_step(batch)
                torch.cuda.synchronize()
                head_ms.append((time.perf_counter() - t0) * 1e3)
                return out

            timed_head.group, timed_head.optimizer = head_step.group, head_step.optimizer
            return orig(runner, timed_head, taken(data), *a, **kw)
        return epoch

    def recorded_sgd(orig):
        class Recorded(orig):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                optimizers.append(self)

            def distribute(self, *a, **kw):
                out = super().distribute(*a, **kw)
                timed_sync(self, ar_ms)
                return out
        return Recorded

    def stop_after(orig):
        def save_mid(self, payload):
            orig(self, payload)
            raise StopRun()
        return save_mid

    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(patched(os, "replace", lambda orig: lambda src, dst: (
                wrote.append(os.path.basename(dst)), orig(src, dst))[1]))
            stack.enter_context(patched(ckpt_io, "resolve_auto_resume", lambda orig: lambda *a: (
                resumed.append(orig(*a)), resumed[-1])[1]))
            stack.enter_context(patched(cli, epoch_name, counted))
            stack.enter_context(patched(cli, "SGD", recorded_sgd))
            stack.enter_context(patched(cli, "init_model", lambda orig: lambda *a, **kw: (
                models.append(orig(*a, **kw)), models[-1])[1]))
            launch_counts(zero=True)
            t0 = time.perf_counter()
            with patched(ckpt_io.CheckpointManager, "save_mid", stop_after):
                try:
                    cli.main(argv)
                except StopRun:
                    pass
            after_stop = os.path.exists(artifacts)
            dist.barrier()  # every rank has stopped before the rerun replaces the mid file
            cli.main(argv + ["--auto_resume"])
            seconds = time.perf_counter() - t0
            counts = launch_counts()
            has_artifacts = (after_stop, os.path.exists(artifacts))
    finally:
        os.chdir(cwd)
    model, opt = models[-1], optimizers[-1]
    log(f"dist rank {rank}: {name} under torchrun's environment (2 ranks, 2 products x 11 "
        f"images a batch a rank) in {seconds:.1f} s with the stop and the resume: batches "
        f"taken {batches}, head steps " + ", ".join(f"{t:.1f}" for t in head_ms) + " ms, their "
        "gradient all-reduce " + ", ".join(f"{t:.1f}" for t in ar_ms) + f" ms; {opt.count} "
        f"steps; wrote {wrote}; resumed from {resumed}; evaluation artifacts {has_artifacts}; "
        f"launches K1 {counts['fused_stem']}, K2 {counts['roi_align']}, K3 "
        f"{counts['nlb_aggregate']}, K4 {counts['pairwise_scores']}")
    check_launches(f"dist_cli_{kind} rank {rank}", counts, CLI_EVAL_PATH, SEAM_STEP_NEVER)
    return {"wrote": wrote, "resumed": resumed, "batches": batches, "count": opt.count,
            "artifacts": has_artifacts, "head_step_ms": head_ms, "allreduce_ms": ar_ms,
            "seconds": seconds, "launches": counts, "save_tag": tag,
            "digest": state_digest(dict(trained_state(model, opt),
                                        **{f"all:{k}": v for k, v in
                                           model.state_dict().items()}))}


def dist_rank(rank, root, port, dev):
    """One rank of phase 8 (a process of its own, on the parent's card)."""
    import pickle

    from seam_match_rcnn_tpu_torch.parallel.mesh import make_mesh

    root = Path(root)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    native.library()  # built by the parent
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous", rank=rank,
                            world_size=DIST_WORLD)
    out = {}
    try:
        mesh = make_mesh(data=DIST_WORLD)
        out["train"] = dist_train(rank, dev, mesh)
        out["heads"] = dist_heads(rank, dev, mesh)
        out["runner"] = dist_runner(rank, dev, mesh)
        out["score"] = dist_score(rank, dev)
        dist.destroy_process_group()
        out["cli"] = dist_cli(rank, dev, root, port)
        torch.cuda.empty_cache()
        for kind in DIST_PHASE2:
            out[f"cli_{kind}"] = dist_cli_phase2(rank, dev, root, kind)
            torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(root / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_nccl(dev, root: Path):
    """A one-rank NCCL group on the card: a full-width phase-1 step through
    ``Phase1Trainer(mesh=make_mesh(data=1))``, its gradient all-reduce and
    RoI gather over NCCL."""
    from seam_match_rcnn_tpu_torch.parallel.collectives import all_gather
    from seam_match_rcnn_tpu_torch.parallel.mesh import make_mesh
    from seam_match_rcnn_tpu_torch.train.engine import bucket_batches

    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{root}/nccl", rank=0, world_size=1)
    try:
        mesh = make_mesh(data=1)
        model, timed = train_model(dev, "pallas_resident", mesh)
        ar_ms = []
        timed_sync(timed.optimizer, ar_ms)
        images, targets = train_batch(np.random.RandomState(11), DIST_TRAIN_SIZES)
        batches = bucket_batches(model, images[:4], targets[:4], 24, dev)
        before = trained_state(model)
        launch_counts(zero=True)
        for s in range(2):
            d = dist_draws(model, batches[0], 4, 2000 + s)
            timed.step(batches, draws=[d])
        counts = launch_counts()
        x = torch.randn((32, 256, 14, 14), device=dev)
        gathered = all_gather(x, mesh.get_group("data"))
        moved = sum(not torch.equal(v, trained_state(model)[k]) for k, v in before.items())
        backend = dist.get_backend(mesh.get_group("data"))
    finally:
        dist.destroy_process_group()
    log(f"dist: one-rank NCCL group ({backend}): 2 full-width steps "
        + ", ".join(f"{t * 1e3:.1f}" for t in timed.times) + " ms, gradient all-reduce "
        + ", ".join(f"{t:.2f}" for t in ar_ms) + f" ms; gather {tuple(gathered.shape)} equal "
        f"{torch.equal(gathered[0], x)}; {moved} of {len(before)} trained tensors moved; "
        f"launches K1 {counts['fused_stem']}, K2 {counts['roi_align']}, K5 "
        f"{counts['roi_align_adjoint']}")
    if backend != "nccl" or not torch.equal(gathered[0], x) or moved == 0 or not all(
            np.isfinite(v) for lf in timed.losses for v in lf.values()):
        raise SystemExit("dist: the one-rank NCCL group failed its checks")
    missing = [n for n in TRAIN_PATH if counts[n] == 0]
    if missing:
        raise SystemExit(f"dist: the NCCL step never launched {missing}")
    return counts, {"step_ms": [t * 1e3 for t in timed.times], "allreduce_ms": ar_ms}


def phase_dist(dev):
    """Phase 8: the distributed paths on two ranks sharing the card over Gloo,
    then a one-rank NCCL group."""
    import pickle

    from seam_match_rcnn_tpu_torch.parallel.collectives import dist_backend

    t_phase = time.perf_counter()
    log("dist: 2 ranks share the one card, so the transport is Gloo (SEAM_DIST_BACKEND=gloo; "
        "the compute stays on the card): NCCL refuses two ranks on one device")
    try:
        dist_backend(DIST_WORLD, torch.cuda.device_count(), "nccl")
        raise SystemExit("dist: the backend rule let NCCL run two ranks on one card")
    except RuntimeError as e:
        log(f"dist: the backend rule refuses NCCL here: {e}")
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    paths, report = {}, {}
    try:
        img_dir, ann_dir = make_synthetic_df2(str(root / "df2"), n_products=8, views_per_side=2,
                                              image_size=(600, 800))
        run_cli(deepf_to_coco.main, ["--image_dir", img_dir, "--annos_dir", ann_dir, "--out",
                                     str(root / "df2" / "annots.json")])
        # the phase-2 CLIs' fixtures: 8 MovingFashion products (2 test ones),
        # 8 MultiDF2 products of 3 street and 3 shop views
        mf_fixture(root / "mf", n_train=8, n_test=2)
        img_dir, ann_dir = make_synthetic_df2(str(root / "mdf2"), n_products=8,
                                              views_per_side=3, image_size=(600, 800))
        run_cli(deepf_to_coco.main, ["--image_dir", img_dir, "--annos_dir", ann_dir, "--out",
                                     str(root / "mdf2" / "annots.json")])
        torch.cuda.empty_cache()
        ctx = torch.multiprocessing.spawn(dist_rank, args=(str(root), free_port(), dev),
                                          nprocs=DIST_WORLD, join=False)
        deadline = time.monotonic() + DIST_TIMEOUT_S
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                raise SystemExit(f"dist: the ranks ran past {DIST_TIMEOUT_S} s")
        ranks = []
        for r in range(DIST_WORLD):
            with open(root / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        a, b = ranks
        checks = {
            "DP steps bit-equal": all(a["train"][k]["digest"] == b["train"][k]["digest"]
                                      for k in ("pallas_resident", "pallas", "f32")),
            "head steps bit-equal": all(a["heads"][k]["digest"] == b["heads"][k]["digest"]
                                        for k in a["heads"] if k != "all_empty_skipped"),
            "cli ranks bit-equal": a["cli"]["digest"] == b["cli"]["digest"],
            "cli rank 0 alone wrote": (b["cli"]["wrote"] == [] and a["cli"]["wrote"]
                                       == ["mid.pt", "mid.pt", "epoch000.pt", "final.pt"]),
            "cli one checkpoint set": sorted(os.listdir(root / "ckpt" / "matchrcnn"))
            == ["epoch000.pt", "final.pt"],
            "cli same resume file": (a["cli"]["resumed"] == b["cli"]["resumed"]
                                     == [str(root / "ckpt" / "matchrcnn" / "mid.pt")]),
        }
        for kind in DIST_PHASE2:
            x, y = a[f"cli_{kind}"], b[f"cli_{kind}"]
            ckpt = root / "ckpt" / x["save_tag"]
            checks.update({
                f"cli_{kind} ranks bit-equal": x["digest"] == y["digest"],
                f"cli_{kind} rank 0 alone wrote": (
                    y["wrote"] == [] and x["wrote"] == ["mid.pt", "mid.pt", "epoch000.pt",
                                                        "final.pt"]),
                f"cli_{kind} one checkpoint set": sorted(os.listdir(ckpt))
                == ["epoch000.pt", "final.pt"],
                f"cli_{kind} same resume file": x["resumed"] == y["resumed"]
                == [str(ckpt / "mid.pt")],
                # steps_per_epoch = 8 products // (2 a batch x 2 ranks)
                f"cli_{kind} steps_per_epoch / W batches a rank": x["batches"] == y["batches"]
                == [1, 1] and x["count"] == y["count"] == 2,
                f"cli_{kind} rank 0 alone wrote the evaluation's artifacts": (
                    x["artifacts"] == (False, True) and y["artifacts"] == (False, False)),
            })
        log("dist: " + "; ".join(f"{k}: {v}" for k, v in checks.items()))
        if not all(checks.values()):
            raise SystemExit(f"dist: failed {[k for k, v in checks.items() if not v]}")
        for r, res in enumerate(ranks):
            paths[f"dist_train_rank{r}"] = res["train"]["pallas_resident"]["launches"]
            paths[f"dist_train_pallas_rank{r}"] = res["train"]["pallas"]["launches"]
            paths[f"dist_train_f32_rank{r}"] = res["train"]["f32"]["launches"]
            paths[f"dist_runner_rank{r}"] = res["runner"]["launches"]
            paths[f"dist_score_rank{r}"] = res["score"]["launches"]
            paths[f"dist_cli_rank{r}"] = res["cli"]["launches"]
            for kind in DIST_PHASE2:
                paths[f"dist_cli_{kind}_rank{r}"] = res[f"cli_{kind}"]["launches"]
        paths["dist_nccl"], report["nccl"] = dist_nccl(dev, root)
        report.update({"ranks": [{k: v for k, v in res.items()} for res in ranks]})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    report["seconds"] = time.perf_counter() - t_phase
    log(f"dist: phase 8 took {report['seconds']:.1f} s")
    return paths, report


# ---- phase 9: the phase-1 ablation paths, inference with GT, the trace ---------------

ABLATE_SINGLE = [(600, 800), (720, 1280), (480, 640), (768, 1024), (540, 960), (500, 900),
                 (640, 960), (450, 800)]  # one landscape bucket
# 4 landscape and 4 portrait images; street image i and shop image i + 4 share
# an orientation, so each bucket holds street/shop pairs
ABLATE_MIXED = [(600, 800), (720, 1280), (800, 600), (1280, 720), (480, 640), (768, 1024),
                (640, 480), (1024, 768)]
ABLATE_STAGES = ("backbone", "rpn", "sample", "boxbranch", "mask", "full")
NO_K5_PATH = ("roi_align_adjoint",)
P1_NO_K6 = P1_CLI_NEVER + ("roi_align_patch",)  # phase 1 on K2: no K3, K4, K6, K7
INFER_GT_NEVER = ("nlb_aggregate", "pairwise_scores", "roi_align_adjoint", "roi_align_patch",
                  "roi_align_patch_int8")


def synced_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def update_of(before, after):
    """after - before of each trainable tensor of ``trained_state``."""
    return {k: after[k].double() - before[k].double() for k in before
            if not k.startswith("momentum")}


def stage_rows(model, optimizer, batches, draws, stages, reps=3):
    """Per stage of ``MatchRCNN.profile_losses``: the forward alone (no
    graph) and a step (forward, backward, update) in ms, medians of
    ``reps`` after one warm-up each, on a synchronised host clock; "opt" is
    ``optimizer.step`` alone on gradients of ones.  Every stage starts from
    the weights and optimizer state of the call, as the JAX package's
    tools/profile_train.py times each stage from the same state."""
    model_state = copy.deepcopy(model.state_dict())
    opt_state = copy.deepcopy(optimizer.state_dict())

    def restore():
        model.load_state_dict(model_state)
        optimizer.load_state_dict(copy.deepcopy(opt_state))
        optimizer.zero_grad()

    rows = []
    for stage in stages:
        row = {"stage": stage}
        restore()
        if stage == "opt":
            for p in optimizer.params:
                p.grad = torch.ones_like(p)
            times = [synced_ms(optimizer.step)[0] for _ in range(reps + 1)][1:]
            row["step_ms"] = statistics.median(times)
            rows.append(row)
            continue

        def fwd():
            with torch.no_grad():
                return model.profile_losses(batches, stage, draws=draws)

        def step():
            optimizer.zero_grad()
            loss = model.profile_losses(batches, stage, draws=draws)
            loss.backward()
            optimizer.step()
            return loss.detach()

        times = [synced_ms(fwd) for _ in range(reps + 1)][1:]
        row["fwd_ms"] = statistics.median(t for t, _ in times)
        row["loss"] = float(times[-1][1])
        times = [synced_ms(step)[0] for _ in range(reps + 1)][1:]
        row["step_ms"] = statistics.median(times)
        if not np.isfinite(row["loss"]):
            raise SystemExit(f"ablate: stage {stage}: loss {row['loss']}")
        rows.append(row)
    restore()
    return rows


def ablate_remat(dev, paths, report):
    """remat off vs on: 1 + 3 steps each of the same single-orientation batch
    and draws under deterministic algorithms, from the same weights."""
    runs = {}
    for remat in (False, True):
        model, timed = train_model(dev, "pallas_resident", remat=remat)
        batches = bucket_batches(model, *train_batch(np.random.RandomState(21), ABLATE_SINGLE),
                                 24, dev)
        draws = [dist_draws(model, batches[0], 8, 900 + s) for s in range(4)]
        timed.step(batches, draws=[draws[0]])
        torch.cuda.reset_peak_memory_stats(dev)
        launch_counts(zero=True)
        for d in draws[1:]:
            timed.step(batches, draws=[d])
        counts = launch_counts()
        runs[remat] = {"step_ms": [t * 1e3 for t in timed.times[1:]],
                       "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                       "losses": timed.losses, "state": trained_state(model, timed.optimizer),
                       "launches": counts}
        del model, timed, batches
        torch.cuda.empty_cache()
    off, on = runs[False], runs[True]
    paths["ablate_remat"] = on["launches"]
    check_launches("ablate_remat", on["launches"], TRAIN_PATH, P1_NO_K6)
    diff = [k for k in off["state"] if not torch.equal(off["state"][k], on["state"][k])]
    worst = max((float((on["state"][k].double() - off["state"][k].double()).abs().max())
                 for k in diff), default=0.0)
    log(f"ablate: remat_backbone off / on, batch 8 at 800x1344, deterministic algorithms: "
        f"median step {statistics.median(off['step_ms']):.1f} / "
        f"{statistics.median(on['step_ms']):.1f} ms (each "
        + ", ".join(f"{a:.1f}/{b:.1f}" for a, b in zip(off["step_ms"], on["step_ms"]))
        + f"); peak {off['peak_gib']:.2f} / {on['peak_gib']:.2f} GiB; after 4 steps "
        f"{len(diff)} of {len(off['state'])} tensors differ (max {worst:.3g}); losses "
        f"{off['losses'][-1]['loss']:.6f} / {on['losses'][-1]['loss']:.6f}; launches "
        f"{on['launches']}")
    if diff:
        raise SystemExit(f"ablate: the remat steps are not bit-equal to the steps without: "
                         f"{diff[:5]}")
    report["remat"] = {k: {"step_ms": r["step_ms"], "peak_gib": r["peak_gib"],
                           "loss_last": r["losses"][-1]["loss"]}
                       for k, r in (("off", off), ("on", on))}
    report["remat"]["bit_equal"] = True


def ablate_adjoint(dev, paths, report):
    """``roi_adjoint_backend="xla"`` against K5: one captured cotangent, the
    first step's update from the same weights and draws, step times, and
    one step with the K6 forward under "xla"."""
    out, captured, states = {}, [], {}
    adjoint = cuda_roi_align.roi_align_adjoint

    def record(grad, rois, level_shapes, dtype, sampling_ratio=2,
               spatial_scales=SPATIAL_SCALES):
        if not captured:
            captured.append((grad.clone(), rois.clone(), [tuple(x) for x in level_shapes]))
        return adjoint(grad, rois, level_shapes, dtype, sampling_ratio, spatial_scales)

    record.launches = 0  # the wrapper counts under its module name while patched
    for backend in ("pallas", "xla"):
        model, timed = train_model(dev, "pallas_resident", roi_adjoint_backend=backend)
        batches = bucket_batches(model, *train_batch(np.random.RandomState(22), ABLATE_SINGLE),
                                 24, dev)
        draws = [dist_draws(model, batches[0], 8, 950 + s) for s in range(3)]
        before = trained_state(model)
        if backend == "pallas":
            cuda_roi_align.roi_align_adjoint = record
        try:
            timed.step(batches, draws=[draws[0]])
        finally:
            cuda_roi_align.roi_align_adjoint = adjoint
        states[backend] = update_of(before, trained_state(model))
        launch_counts(zero=True)
        for d in draws[1:]:
            timed.step(batches, draws=[d])
        out[backend] = {"step_ms": [t * 1e3 for t in timed.times[1:]],
                        "first_step_ms": timed.times[0] * 1e3, "launches": launch_counts()}
        del model, timed, batches
        torch.cuda.empty_cache()
    paths["ablate_xla_adjoint"] = out["xla"]["launches"]
    check_launches("ablate_xla_adjoint", out["xla"]["launches"], ("fused_stem", "roi_align"),
                   P1_NO_K6 + NO_K5_PATH)
    num = sum(float(((states["xla"][k] - states["pallas"][k]) ** 2).sum()) for k in states["xla"])
    den = sum(float((states["pallas"][k] ** 2).sum()) for k in states["pallas"])
    rel = (num / max(den, 1e-300)) ** 0.5

    # the captured cotangent: K5 and the scatter-add adjoint (f32 sums, then
    # bf16 as the "xla" backward returns it) against the f32 plain adjoint
    g, rois, shapes = captured[0]
    want = multilevel_roi_align_adjoint(g, rois, shapes)
    mass = multilevel_roi_align_adjoint(g.abs(), rois, shapes)
    k5 = cuda_roi_align.roi_align_adjoint(g, rois, shapes, torch.bfloat16)
    xla = tuple(x.to(torch.bfloat16).permute(0, 3, 1, 2) for x in want)
    err_k5, tol, ok_k5 = check_adjoint(k5, want, mass, torch.bfloat16)
    err_xla, _, ok_xla = check_adjoint(xla, want, mass, torch.bfloat16)
    k5_ms = median_ms(lambda: cuda_roi_align.roi_align_adjoint(g, rois, shapes, torch.bfloat16),
                      5)
    xla_ms = median_ms(lambda: multilevel_roi_align_adjoint(g, rois, shapes), 5)
    # index_add_ under torch.use_deterministic_algorithms(True), as phase 7 runs phase 1
    try:
        torch.use_deterministic_algorithms(True)
        det_ms = median_ms(lambda: multilevel_roi_align_adjoint(g, rois, shapes), 3)
        det = f"runs, {det_ms:.3f} ms"
    except RuntimeError as e:
        det_ms, det = None, f"raises: {str(e).splitlines()[0][:200]}"
    finally:
        torch.use_deterministic_algorithms(False)

    # one step with the K6 forward under "xla"
    model, timed = train_model(dev, "pallas", roi_adjoint_backend="xla")
    batches = bucket_batches(model, *train_batch(np.random.RandomState(22), ABLATE_SINGLE), 24,
                             dev)
    timed.step(batches, draws=[dist_draws(model, batches[0], 8, 960)])
    launch_counts(zero=True)
    timed.step(batches, draws=[dist_draws(model, batches[0], 8, 961)])
    paths["ablate_xla_adjoint_pallas"] = launch_counts()
    pallas_ms = timed.times[1] * 1e3
    losses = timed.losses[-1]
    del model, timed, batches
    torch.cuda.empty_cache()
    check_launches("ablate_xla_adjoint_pallas", paths["ablate_xla_adjoint_pallas"],
                   ("fused_stem", "roi_align_patch"), P1_CLI_NEVER + NO_K5_PATH + ("roi_align",))
    b, r, o = g.shape[:3]
    log(f"ablate: roi_adjoint_backend xla vs pallas (K5): captured cotangent {b}x{r} rois "
        f"{o}x{o}: K5 off the f32 plain adjoint by {err_k5:.3g}, the xla adjoint (bf16) by "
        f"{err_xla:.3g} ({tol}); adjoint alone K5 {k5_ms:.3f} ms, scatter-add {xla_ms:.3f} ms; "
        f"under torch.use_deterministic_algorithms(True) the scatter-add {det}; the first "
        f"step's update off the default's by {rel:.3g} of its norm (limit 1e-3); steps "
        f"(after the first) pallas " + ", ".join(f"{t:.1f}" for t in out["pallas"]["step_ms"])
        + " ms, xla " + ", ".join(f"{t:.1f}" for t in out["xla"]["step_ms"]) + " ms; one "
        f"step with the K6 forward under xla {pallas_ms:.1f} ms; launches xla "
        f"{out['xla']['launches']}, xla with K6 {paths['ablate_xla_adjoint_pallas']}")
    if not (ok_k5 and ok_xla) or rel > 1e-3 or not np.isfinite(losses["loss"]):
        raise SystemExit(f"ablate: the xla adjoint disagrees (K5 {err_k5}, xla {err_xla}, "
                         f"update {rel})")
    report["adjoint"] = {"k5_err": err_k5, "xla_err": err_xla, "k5_ms": k5_ms,
                         "xla_adjoint_ms": xla_ms, "deterministic": det,
                         "deterministic_ms": det_ms, "update_rel": rel,
                         "pallas_step_ms": out["pallas"]["step_ms"],
                         "xla_step_ms": out["xla"]["step_ms"], "xla_k6_step_ms": pallas_ms}


def ablate_accum(dev, paths, report):
    """The grad/accum/apply triple: at weight 1 on one bucket against
    ``Phase1Trainer.step`` (same weights and draws, deterministic
    algorithms), then on a mixed batch beside ``Phase1Trainer``."""
    states = {}
    for form in ("trainer", "triple"):
        model, timed = train_model(dev, "pallas_resident")
        batches = bucket_batches(model, *train_batch(np.random.RandomState(23), ABLATE_SINGLE),
                                 24, dev)
        d = dist_draws(model, batches[0], 8, 970)
        if form == "trainer":
            timed.step(batches, draws=[d])
        else:
            grad_fn, _, apply_fn = make_phase1_grad_apply(model, timed.optimizer)
            grads, _ = grad_fn(batches[0], 1.0, draws=d)
            apply_fn(grads)
        states[form] = trained_state(model, timed.optimizer)
        del model, timed, batches
        torch.cuda.empty_cache()
    diff = [k for k in states["trainer"] if not torch.equal(states["trainer"][k],
                                                            states["triple"][k])]
    rows = {}
    for form in ("trainer", "triple"):
        model, timed = train_model(dev, "pallas_resident")
        batches = bucket_batches(model, *train_batch(np.random.RandomState(24), ABLATE_MIXED),
                                 24, dev)
        draws = [[dist_draws(model, b, b["images"].shape[0], 980 + 10 * s + i)
                  for i, b in enumerate(batches)] for s in range(2)]
        if form == "trainer":
            step = lambda ds: timed.step(batches, draws=ds)  # noqa: E731
        else:
            grad_fn, accum_fn, apply_fn = make_phase1_grad_apply(model, timed.optimizer)

            def step(ds):
                acc, lf = None, {}
                for b, d in zip(batches, ds):
                    w = b["images"].shape[0] / 8
                    grads, losses = grad_fn(b, w, draws=d)
                    acc = grads if acc is None else accum_fn(acc, grads)
                    for k, v in losses.items():
                        lf[k] = lf.get(k, 0.0) + w * float(v)
                apply_fn(acc)
                return lf
        step(draws[0])
        count = timed.optimizer.count
        torch.cuda.reset_peak_memory_stats(dev)
        launch_counts(zero=True)
        ms, losses = synced_ms(lambda: step(draws[1]))
        counts = launch_counts()
        rows[form] = {"step_ms": ms, "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                      "count": timed.optimizer.count - count, "buckets": len(batches),
                      "losses": {k: float(v) for k, v in losses.items()}}
        if form == "triple":
            paths["ablate_accum"] = counts
        del model, timed, batches
        torch.cuda.empty_cache()
    check_launches("ablate_accum", paths["ablate_accum"], TRAIN_PATH, P1_NO_K6)
    t, p = rows["triple"], rows["trainer"]
    log(f"ablate: grad/accum/apply triple at weight 1 on one bucket vs Phase1Trainer.step "
        f"(deterministic algorithms): {len(diff)} of {len(states['trainer'])} tensors differ; "
        f"mixed batch of {t['buckets']} buckets: triple {t['step_ms']:.1f} ms, peak "
        f"{t['peak_gib']:.2f} GiB, {t['count']} update, loss {t['losses']['loss']:.4f} "
        f"(match {t['losses']['loss_match']:.4f}); Phase1Trainer {p['step_ms']:.1f} ms, peak "
        f"{p['peak_gib']:.2f} GiB, loss {p['losses']['loss']:.4f}; launches "
        f"{paths['ablate_accum']}")
    if diff:
        raise SystemExit(f"ablate: the triple at weight 1 is not Phase1Trainer's step: {diff[:5]}")
    if t["count"] != 1 or t["buckets"] != 2 or not all(np.isfinite(v)
                                                        for v in t["losses"].values()):
        raise SystemExit(f"ablate: the triple's mixed step failed: {t}")
    report["accum"] = {"weight_one_bit_equal": True, "triple": t, "trainer": p}


def ablate_stages(dev, paths, report):
    """Forward and step ms for each stage of ``profile_losses`` and the
    optimizer alone; "full" equals the step's loss."""
    model, timed = train_model(dev, "pallas_resident")
    batches = bucket_batches(model, *train_batch(np.random.RandomState(25), ABLATE_SINGLE), 24,
                             dev)
    d = dist_draws(model, batches[0], 8, 990)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        full = float(model.profile_losses(batches, "full", draws=[d]).detach())
        step_loss = float(timed.step(batches, draws=[d])["loss"])
    finally:
        torch.use_deterministic_algorithms(False)
    launch_counts(zero=True)
    rows = stage_rows(model, timed.optimizer, batches, [d], ABLATE_STAGES + ("opt",))
    paths["ablate_stages"] = launch_counts()
    del model, timed, batches
    torch.cuda.empty_cache()
    check_launches("ablate_stages", paths["ablate_stages"], TRAIN_PATH, P1_NO_K6)
    log("ablate: stages (batch 8 at 800x1344, ms forward / step): " + "; ".join(
        f"{r['stage']} {r.get('fwd_ms', float('nan')):.1f} / {r['step_ms']:.1f}" for r in rows)
        + f"; full {full:.6f} vs the step's loss {step_loss:.6f}; launches "
        f"{paths['ablate_stages']}")
    if full != step_loss:
        raise SystemExit(f"ablate: profile_losses('full') {full} is not the step's loss "
                         f"{step_loss}")
    report["stages"] = rows


def ablate_infer_gt(dev, paths, report):
    """``inference(gt=)`` on the video model at serving width (batch 11, G
    = 4 drawn boxes an image, one row invalid): the GT rows first, score 1
    where valid; the other rows as ``inference`` without ``gt``.  Returns
    the model, the images and the outputs."""
    model = serving_model(dev)
    rng = np.random.RandomState(26)
    images = [synthetic_image(rng, 720, 1280)[0] for _ in range(11)]
    (bucket,) = batch_images(images, model.cfg.transform, dev)
    sizes = torch.as_tensor(bucket.sizes, device=dev)
    g = 4
    x1 = rng.uniform(0, 900, (11, g))
    y1 = rng.uniform(0, 500, (11, g))
    boxes = np.stack([x1, y1, x1 + rng.uniform(40, 400, (11, g)),
                      y1 + rng.uniform(40, 280, (11, g))], -1).astype(np.float32)
    valid = np.ones((11, g), bool)
    valid[:, -1] = False
    gt = {"boxes": torch.as_tensor(boxes, device=dev),
          "labels": torch.as_tensor(rng.randint(1, 14, (11, g)), device=dev),
          "valid": torch.as_tensor(valid, device=dev)}
    plain = model.inference(bucket.pixels, sizes, with_masks=True)
    launch_counts(zero=True)
    ms, out = synced_ms(lambda: model.inference(bucket.pixels, sizes, with_masks=True, gt=gt))
    paths["infer_gt"] = launch_counts()
    check_launches("infer_gt", paths["infer_gt"], ("fused_stem", "roi_align"), INFER_GT_NEVER)
    head = (torch.equal(out["boxes"][:, :g], gt["boxes"])
            and torch.equal(out["scores"][:, :g], gt["valid"].float())
            and torch.equal(out["labels"][:, :g], gt["labels"])
            and torch.equal(out["valid"][:, :g], gt["valid"]))
    rest = {k: float((out[k][:, g:].float() - v.float()).abs().max()) for k, v in plain.items()}
    equal = {k: torch.equal(out[k][:, g:], v) for k, v in plain.items()}
    finite = all(bool(torch.isfinite(v.float()).all()) for v in out.values())
    d = plain["boxes"].shape[1]
    log(f"ablate: inference(gt=) at batch 11 (720x1280 on 800x1344), G = {g} (one row "
        f"invalid) + D = {d} rows in {ms:.1f} ms: GT rows first with score 1 where valid "
        f"{head}; the D rows bit-equal to inference without gt {equal} (max differences "
        f"{rest}); launches {paths['infer_gt']}")
    exact = ("boxes", "scores", "labels", "valid", "roi_features")
    if not head or not finite or not all(equal[k] for k in exact) \
            or rest["match_features"] > 1e-4 or rest["masks"] > 1e-2:
        raise SystemExit("ablate: inference(gt=) failed its checks")
    report["infer_gt"] = {"ms": ms, "bit_equal": equal, "max_diff": rest}
    return model, images, out


def ablate_trace(dev, model, paths, report):
    """One ``SeamRetrieval.retrieve`` request traced under
    ``annotate("retrieve")`` into build/chip_smoke_trace/: the trace names
    the annotation and the CUDA kernels of K1-K4."""
    out_dir = Path("build") / "chip_smoke_trace"
    shutil.rmtree(out_dir, ignore_errors=True)
    retr = SeamRetrieval(model, chunk=11)
    rng = np.random.RandomState(27)
    gallery = retr.build_gallery([synthetic_image(rng, 600, 800)[0] for _ in range(4)])
    frames = [synthetic_image(rng, 720, 1280)[0] for _ in range(10)]
    retr.retrieve(frames, gallery, k=2)  # warm-up outside the trace
    launch_counts(zero=True)
    with profiling.trace(str(out_dir)):
        with profiling.annotate("retrieve"):
            retr.retrieve(frames, gallery, k=2)
    paths["trace_retrieve"] = launch_counts()
    check_launches("trace_retrieve", paths["trace_retrieve"], SERVING_PATH, SERVE_IDLE)
    files = sorted(out_dir.glob("*.pt.trace.json"))
    text = files[0].read_text() if len(files) == 1 else ""
    names = ("retrieve", "stem_kernel", "roi_align_kernel", "nlb_kernel", "pairwise_kernel")
    found = {n: n in text for n in names}
    log(f"ablate: utils.profiling.trace of one retrieve request: {[str(f) for f in files]} "
        f"({len(text)} bytes) names {found}; launches {paths['trace_retrieve']}")
    if not all(found.values()):
        raise SystemExit(f"ablate: the trace misses {[n for n, v in found.items() if not v]}")
    report["trace"] = {"file": str(files[0]), "bytes": len(text)}


def ablate_visualize(images, out, report):
    """``utils.visualize.visualize_matches`` on the detector's CUDA outputs,
    where matplotlib is importable."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        log(f"ablate: matplotlib is not importable here ({e}); visualize not run")
        report["visualize"] = {"matplotlib": False}
        return
    path = Path("build") / "chip_smoke_trace" / "matches.png"
    v0, v1 = out["valid"][0], out["valid"][1]
    visualize.visualize_matches(
        torch.as_tensor(images[0]).cuda(), torch.as_tensor(images[1]).cuda(),
        out["boxes"][0][v0], out["boxes"][1][v1], scores=out["scores"][0][v0],
        out_path=str(path))
    size = path.stat().st_size
    log(f"ablate: matplotlib {matplotlib.__version__} importable; visualize_matches of the "
        f"detector's CUDA outputs wrote {path} ({size} bytes)")
    if size == 0:
        raise SystemExit("ablate: visualize_matches wrote an empty file")
    report["visualize"] = {"matplotlib": matplotlib.__version__, "png": str(path), "bytes": size}


def phase_ablate(dev):
    """Phase 9: the phase-1 ablation paths at full width (phase 4's batch 8 at
    800x1344 and ``train_model``), inference with GT, a traced request and
    the visualizer."""
    t_phase = time.perf_counter()
    paths, report = {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ablate_remat(dev, paths, report)
        ablate_accum(dev, paths, report)
    finally:
        torch.use_deterministic_algorithms(False)
    ablate_adjoint(dev, paths, report)
    ablate_stages(dev, paths, report)
    model, images, out = ablate_infer_gt(dev, paths, report)
    ablate_trace(dev, model, paths, report)
    ablate_visualize(images, out, report)
    del model, out
    torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_phase
    log(f"ablate: phase 9 took {report['seconds']:.1f} s")
    return paths, report


EXPORT_CASES = (("export_serving", "pallas_resident", 11), ("export_pallas", "pallas", 1),
                ("export_pallas_int8", "pallas_int8", 1))
PARITY_NEVER = ("roi_align_adjoint", "roi_align_patch", "roi_align_patch_int8")


def export_case(dev, name, backend, batch, paths, report, reps=5):
    """``tools/export_serving_torch``: ``serving_model_config()`` under the
    RoIAlign ``backend`` exported at ``batch`` x 800x1344 from CUDA fake
    tensors, saved to a temporary .pt2, loaded and replayed on seeded
    synthetic images: the replay equal to the eager forward bit for bit, K1
    once and the backend's RoIAlign kernel twice (box branch, 14x14 pass) a
    replayed forward, no other kernel, and the graph calling their ops."""
    from tools import export_serving_torch as est

    roi_kernel = EVAL_ROI_KERNEL[backend]
    cfg = serving_model_config(roi_heads=RoIHeadsConfig(roi_align_backend=backend))
    module, inputs = est.build(batch, (800, 1344), cfg, device=dev)
    t0 = time.perf_counter()
    program = est.export(module, inputs)
    export_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serving.pt2")
        t0 = time.perf_counter()
        torch.export.save(program, path)
        save_s = time.perf_counter() - t0
        mb = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        loaded = est.load(path)
        load_s = time.perf_counter() - t0
    ops = est.seam_ops(loaded)
    replay = loaded.module()
    rng = np.random.RandomState(40 + batch)
    (bucket,) = batch_images([synthetic_image(rng, 720, 1280)[0] for _ in range(batch)],
                             cfg.transform, dev)
    sizes = torch.as_tensor(bucket.sizes, device=dev)
    with torch.no_grad():
        want = module(bucket.pixels, sizes)
        replay(bucket.pixels, sizes)  # warm-up
        launch_counts(zero=True)
        got = replay(bucket.pixels, sizes)
        torch.cuda.synchronize()
        paths[name] = launch_counts()
        eager_ms, replay_ms = [], []
        for _ in range(reps):
            eager_ms.append(synced_ms(lambda: module(bucket.pixels, sizes))[0])
            replay_ms.append(synced_ms(lambda: replay(bucket.pixels, sizes))[0])
    equal = {k: torch.equal(got[k], want[k]) for k in want}
    counts = paths[name]
    # K1 once, the RoIAlign kernel twice (box branch, 14x14 pass), K8 after each of the
    # body's 48 convs
    want_calls = {"fused_stem": 1, roi_kernel: 2, "bn_epilogue": 48}
    want_counts = {k: want_calls.get(k, 0) for k in counts}
    want_ops = {f"seam.{k}.default": n for k, n in want_calls.items()}
    row = {"export_s": export_s, "save_s": save_s, "mb": mb, "load_s": load_s,
           "eager_ms": statistics.median(eager_ms), "replay_ms": statistics.median(replay_ms),
           "bit_equal": equal, "ops": ops, "valid": int(got["valid"].sum())}
    log(f"export: {name} ({backend}, batch {batch} on 800x1344): export {export_s:.1f} s, save "
        f"{save_s:.1f} s, {mb:.1f} MB, load {load_s:.1f} s; replay {row['replay_ms']:.2f} ms "
        f"against eager {row['eager_ms']:.2f} ms (medians of {reps}); graph ops {ops}; "
        f"launches {counts}; {row['valid']} valid rows; bit-equal to eager {equal}")
    if ops != want_ops or counts != want_counts or not all(equal.values()) \
            or got["boxes"].shape != (batch, cfg.roi_heads.detections_per_img, 4):
        raise SystemExit(f"export: {name} failed: ops {ops} (want {want_ops}), launches "
                         f"{counts} (want {want_counts}), bit-equal {equal}")
    report[name] = row
    del program, loaded, replay, module, got, want
    torch.cuda.empty_cache()


def export_cli(paths, report):
    """``tools/export_serving_torch.py --out`` at its defaults (ModelConfig(),
    batch 11, 800x1344, on the card), then ``--check`` on the file, in
    process."""
    from tools import export_serving_torch as est

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serving.pt2")
        launch_counts(zero=True)
        rc_out, out_lines, out_s = run_cli(est.main, ["--out", path])
        rc_check, check_lines, check_s = run_cli(est.main, ["--check", path])
        paths["export_cli"] = launch_counts()
        mb = os.path.getsize(path) / 1e6
    log(f"export: CLI --out in {out_s:.1f} s: {out_lines}")
    log(f"export: CLI --check in {check_s:.1f} s: {check_lines}")
    text = "\n".join(check_lines)
    if rc_out != 0 or rc_check != 0 or "input images: [11, 3, 800, 1344]" not in text \
            or "custom ops: {'seam.bn_epilogue.default': 49}" not in text:  # K8 alone
        raise SystemExit("export: the CLI's --out/--check failed")
    report["export_cli"] = {"out_s": out_s, "check_s": check_s, "mb": mb,
                            "out": out_lines, "check": check_lines}


def parity_gate(paths, report):
    """``tools/validate_parity_torch.main(["--synthetic"])`` at full geometry
    (3 products of 1 shop image + 3 frames, random weights) for the three
    profiles, launches counted per profile: a PARITY_JSON line with three
    top-1 values in [0, 1] a profile, the deltas and the gate's verdict."""
    from tools import validate_parity_torch as vp

    need = {"exact": ("pairwise_scores",), "serving": SERVING_PATH, "fast": SERVING_PATH}
    never = {"exact": ("fused_stem", "roi_align", "nlb_aggregate") + PARITY_NEVER,
             "serving": PARITY_NEVER, "fast": PARITY_NEVER}

    def counted(run_profile):
        def run(profile, args):
            launch_counts(zero=True)
            out = run_profile(profile, args)
            paths[f"parity_{profile}"] = launch_counts()
            return out
        return run

    with patched(vp, "run_profile", counted):
        rc, lines, secs = run_cli(vp.main, ["--synthetic"])
    [line] = [ln for ln in lines if ln.startswith("PARITY_JSON ")]
    payload = json.loads(line[len("PARITY_JSON "):])
    gate = [ln for ln in lines if " gate]" in ln]
    log(f"parity: tools/validate_parity_torch.py --synthetic, 3 profiles in {secs:.1f} s, exit "
        f"{rc}: {payload}")
    for ln in gate:
        log(f"parity: {ln}")
    log("parity: the weights are random, so the verdict says nothing about accuracy (with "
        "random weights, near-tie detections flip between numerically different backends); "
        "the smoke checks the pipeline, not the verdict")
    for profile in ("exact", "serving", "fast"):
        check_launches(f"parity_{profile}", paths[f"parity_{profile}"], need[profile],
                       never[profile])
        vals = payload.get(profile, {})
        if set(vals) != {"top1_single", "top1_avg_desc", "top1_aggr_desc"} \
                or not all(0.0 <= v <= 1.0 for v in vals.values()):
            raise SystemExit(f"parity: profile {profile} gave {vals}")
    if rc not in (0, 1) or len(gate) != 6:
        raise SystemExit(f"parity: exit {rc}, {len(gate)} gate lines")
    report["parity"] = {"seconds": secs, "exit": rc, "results": payload, "gate": gate}


def phase_export(dev):
    """Phase 10: the AOT serving export (three RoIAlign backends, and the
    CLI) and the retrieval parity gate's rehearsal."""
    t_phase = time.perf_counter()
    paths, report = {}, {}
    for name, backend, batch in EXPORT_CASES:
        export_case(dev, name, backend, batch, paths, report)
    export_cli(paths, report)
    parity_gate(paths, report)
    report["seconds"] = time.perf_counter() - t_phase
    log(f"export: phase 10 took {report['seconds']:.1f} s")
    return paths, report


# ---- phase 11: the serving-profile validation tools ---------------------------------------

GATE_ARGS = ["--products", "8", "--epochs", "3", "--confusable"]
GATE_EVAL = ("fused_stem", "nlb_aggregate", "pairwise_scores")  # + the arm's RoIAlign kernel
ROI_KERNELS = ("roi_align", "roi_align_patch", "roi_align_patch_int8")
# the gates train ModelConfig(compute_dtype="float32") as the JAX tools do: its
# RoIAlign ("xla") and stem ("xla") are the plain versions, so no hand kernel
# runs there; an evaluation never runs K5, nor a RoIAlign kernel but its arm's
GATE_KEYS = {"INT8VAL_JSON": ("results", "deltas_vs_pallas_resident",
                              "probe_drift_vs_pallas_resident",
                              "rank_margin_vs_pallas_resident", "confusable", "products",
                              "frames"),
             "FASTVAL_JSON": ("results", "deltas", "rank_margin_fast_vs_serving", "confusable",
                              "products", "frames"),
             "TRUNKVAL_JSON": ("results", "deltas_vs_float32", "probe_drift_vs_float32",
                               "rank_margin_vs_float32", "confusable", "products", "frames")}


def gate_arm_check(path, counts, roi_kernel):
    never = ("roi_align_adjoint",) + tuple(k for k in ROI_KERNELS if k != roi_kernel)
    check_launches(path, counts, GATE_EVAL + (roi_kernel,), never)


# what an arm may find still allocated from earlier ones: cuBLAS's workspaces (65 MiB after
# a gate's training on the H100) stay; one video model's weights alone are 0.197 GiB
GATE_HELD_BYTES = 128 * 2 ** 20


def counted(paths, path_of, check, base):
    """A wrapper maker for a gate's training or per-arm function: the counts
    zeroed before each call and read after it into ``paths[path_of(args)]``,
    with its seconds and peak memory; ``check(path, counts)``.  Each call
    must find the card holding no more than ``base[0]`` (the gate's start)
    plus GATE_HELD_BYTES: one full model at a time."""
    def make(fn):
        def run(*args, **kw):
            path = path_of(args)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated() - base[0]
            if held > GATE_HELD_BYTES:
                raise SystemExit(f"gates: {path}: {held / 2 ** 20:.0f} MiB still allocated "
                                 "from earlier arms: a model was not released")
            torch.cuda.reset_peak_memory_stats()
            launch_counts(zero=True)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            paths[path] = launch_counts()
            paths[path + ":s"] = time.perf_counter() - t0
            paths[path + ":peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            check(path, paths[path])
            return out
        return run
    return make


def run_gate(gate, module, marker, arm_module, arm_name, arm_of, roi_kernel_of, report,
             paths):
    """One gate's ``main(GATE_ARGS)`` in process on the card: its training
    and each arm counted (``arm_of(args)`` names the arm from the arm
    function's arguments), its JSON line parsed and checked (the JAX tool's
    keys, top-1 values in [0, 1]), the card's memory back to what it held
    before."""
    from tools import _synth_train_torch as st

    base = [torch.cuda.memory_allocated()]
    train = counted(paths, lambda _: f"gate_train_{gate}",
                    lambda path, c: check_launches(path, c, (),
                                                   tuple(k for k in KERNELS if k not in K8)),
                    base)
    arm = counted(paths, lambda a: f"gate_{gate}_{arm_of(a)}",
                  lambda path, c: gate_arm_check(path, c, roi_kernel_of(path.split("_", 2)[2])),
                  base)
    with patched(st, "train_synthetic_phase1", train), patched(arm_module, arm_name, arm):
        _, lines, secs = run_cli(module.main, GATE_ARGS)
    [line] = [ln for ln in lines if ln.startswith(marker + " ")]
    payload = json.loads(line[len(marker) + 1:])
    tops = [v for arm in payload["results"].values()
            for v in (arm.values() if gate == "fast" else
                      [x for ds in arm.values() for x in ds.values()])]
    if tuple(payload) != GATE_KEYS[marker] or not tops \
            or not all(0.0 <= v <= 1.0 for v in tops):
        raise SystemExit(f"gates: {gate}: {marker} keys {list(payload)}, top-1 {tops}")
    held = torch.cuda.memory_allocated() - base[0]
    if held > GATE_HELD_BYTES:
        raise SystemExit(f"gates: {gate}: {held / 2 ** 20:.0f} MiB still allocated after it")
    arms = [k[len(f"gate_{gate}_"):] for k in paths
            if k.startswith(f"gate_{gate}_") and ":" not in k]
    log(f"gates: {gate}: tools/{module.__name__.split('.')[-1]}.py {' '.join(GATE_ARGS)} in "
        f"{secs:.1f} s; training {paths[f'gate_train_{gate}:s']:.1f} s, peak "
        f"{paths[f'gate_train_{gate}:peak_gib']:.2f} GiB, launches "
        f"{paths[f'gate_train_{gate}']}; arms " + "; ".join(
            f"{a} {paths[f'gate_{gate}_{a}:s']:.1f} s, peak "
            f"{paths[f'gate_{gate}_{a}:peak_gib']:.2f} GiB, launches "
            f"{paths[f'gate_{gate}_{a}']}" for a in arms))
    log(f"gates: {line}")
    report[gate] = {"seconds": secs, "payload": payload,
                    "train_s": paths[f"gate_train_{gate}:s"],
                    "train_peak_gib": paths[f"gate_train_{gate}:peak_gib"],
                    "arms": {a: {"s": paths[f"gate_{gate}_{a}:s"],
                                 "peak_gib": paths[f"gate_{gate}_{a}:peak_gib"]}
                             for a in arms}}


def phase_gates(dev):
    """Phase 11: the five serving-profile validation tools in process on the
    card (their fixtures and logs in a temporary directory): the int8, fast
    and trunk-dtype gates at GATE_ARGS, then the clamp measurement with
    --detector."""
    from tools import measure_roi_clamp_torch as clamp
    from tools import validate_fast_profile_torch as vf
    from tools import validate_int8_torch as vi
    from tools import validate_trunk_dtype_torch as vt
    from tools import _synth_train_torch as st

    t_phase = time.perf_counter()
    paths, report = {}, {}
    old_tmp = tempfile.tempdir
    with tempfile.TemporaryDirectory() as tmp:
        tempfile.tempdir = tmp
        try:
            # harness_arm(vcfg, trained, tag, ...), profile_arm(name, vcfg, ...)
            run_gate("int8", vi, "INT8VAL_JSON", st, "harness_arm", lambda a: a[2],
                     EVAL_ROI_KERNEL.get, report, paths)
            run_gate("fast", vf, "FASTVAL_JSON", vf, "profile_arm", lambda a: a[0],
                     lambda _: "roi_align", report, paths)
            run_gate("trunk", vt, "TRUNKVAL_JSON", st, "harness_arm", lambda a: a[2],
                     lambda _: "roi_align", report, paths)
        finally:
            tempfile.tempdir = old_tmp
    launch_counts(zero=True)
    _, lines, secs = run_cli(clamp.main, ["--detector"])
    paths["gate_clamp"] = launch_counts()
    check_launches("gate_clamp", paths["gate_clamp"], ("fused_stem", "roi_align", "bn_epilogue"),
                   tuple(k for k in KERNELS if k not in ("fused_stem", "roi_align") + K8))
    [det] = [ln for ln in lines if ln.startswith("detector detections")]
    fracs = [ln for ln in lines if "clamp fraction" in ln]
    if len(fracs) != 4 or len([ln for ln in lines if " clamps (footprint " in ln]) != 8:
        raise SystemExit(f"gates: clamp: unexpected output {lines}")
    for ln in lines:
        log(f"gates: clamp: {ln}")
    log(f"gates: clamp: tools/measure_roi_clamp_torch.py --detector in {secs:.1f} s, launches "
        f"{paths['gate_clamp']}")
    report["clamp"] = {"seconds": secs, "lines": lines}
    report["seconds"] = time.perf_counter() - t_phase
    log(f"gates: phase 11 took {report['seconds']:.1f} s")
    return {k: v for k, v in paths.items() if ":" not in k}, report


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
    torch.cuda.empty_cache()
    serve_launches, serve_report = phase_serve(dev)
    paths.update(serve_launches)
    torch.cuda.empty_cache()
    cli_launches, cli_report = phase_cli(dev)
    paths.update(cli_launches)
    torch.cuda.empty_cache()
    dist_launches, dist_report = phase_dist(dev)
    paths.update(dist_launches)
    torch.cuda.empty_cache()
    ablate_launches, ablate_report = phase_ablate(dev)
    paths.update(ablate_launches)
    torch.cuda.empty_cache()
    export_launches, export_report = phase_export(dev)
    paths.update(export_launches)
    torch.cuda.empty_cache()
    gate_launches, gate_report = phase_gates(dev)
    paths.update(gate_launches)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "cases",
            "canvas_cases", "deterministic")
    log(json.dumps({"kernels": [
        {"name": name, "route": "triton" if src.endswith(".py") else "cuda", "source": src,
         "replaces": rep,
         "launches": sum(counts[name] for counts in paths.values()),
         "launches_by_path": {path: counts[name] for path, counts in paths.items()},
         **{k: results[name][k] for k in keys if k in results[name]}}
        for name, (src, rep, _) in KERNELS.items()],
        "retrieve_ms": [x * 1e3 for x in latencies], "gallery_ms": gallery_s * 1e3,
        "serving_peak_gib": serve_peak_gb, "eval": eval_report, "train_step_ms": step_ms,
        "train_step_buckets": step_buckets, "train_peak_gib": train_peak_gb,
        "train_losses": train_losses, "train_pallas_step_ms": pallas_step_ms,
        "train_pallas_peak_gib": pallas_peak_gb, "train_pallas_losses": pallas_losses,
        "seam": seam_report, "serve": serve_report, "cli": cli_report, "dist": dist_report,
        "ablate": ablate_report, "export": export_report, "gates": gate_report}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
