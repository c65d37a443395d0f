"""How kernel K5 (``csrc/roi_adjoint.cu``) spreads its time over its blocks, and
what its P5 tile size costs, on one GPU.

    python3 tools/probe_adjoint_tiles.py [--p5-tiles 4,8] [--out build/adjoint_tiles.json]

Builds ``csrc/roi_adjoint.cu`` once per P5 tile side (``SEAM_ADJOINT_P5_TILE``;
P2-P4 take 8x8 cells) twice: as the library builds it, for CUDA-event times,
and with ``SEAM_ADJOINT_PROBE`` defined, in which thread 0 of every block
records the global timer (ns) at the block's start and end, its SM, level,
rois listed, samples visited and its cycles in each phase.  Both run (bf16
output, C = 256, sampling ratio 2) on three roi sets:

* ``phase1``: the rois and cotangents that K5 gets in the phase-1 training
  step of ``tools/profile_torch_train.py`` (full-width model, seeded random
  weights, the sampler's 512 rois an image at 7x7 and its positives at
  14x14), one step of the single-orientation batch (one bucket) and one of
  the mixed batch (two buckets), captured from ``RoIAlignFunction``'s
  backward;
* ``anchors``: anchor-like boxes (16..800 px, aspect 1:3..3:1, uniform over
  the image), as ``chip_smoke.serving_rois``, at 8 x 512 7x7 and 8 x 128
  14x14 over an 8-image 800x1344 pyramid;
* ``crowd``: the same shapes with a quarter of the rois jittered around 1-3
  garment boxes per image, the rest anchor-like.

For each case and tile it prints the median CUDA-event time of 20 launches,
the probed launch's span, the share of the span during which fewer blocks
than SMs ran (the tail), per level the blocks' time and the rois each tile
listed (how crowded the tiles are), and the slowest blocks; then one JSON
object with the card's name and power limit, also written to ``--out``.
Every output is held against the plain adjoint first.  Needs the CUDA
toolkit and a CUDA device; the build flags are ``ops/native.py``'s.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from seam_match_rcnn_tpu_torch.ops import cuda_roi_align, native  # noqa: E402
from seam_match_rcnn_tpu_torch.ops.roi_align import (SPATIAL_SCALES,  # noqa: E402
                                                      multilevel_roi_align_adjoint,
                                                      roi_footprints)

PYRAMID = ((200, 336), (100, 168), (50, 84), (25, 42))  # P2..P5 of an 800x1344 canvas
FIELDS = ("start_ns", "end_ns", "sm", "level", "listed", "visits", "scan_cycles",
          "table_cycles", "add_cycles", "setup_and_write_cycles")
PHASES = FIELDS[6:]


def build(tiles):
    """{(p5 tile, probed): library}, one nvcc per library, all at once."""
    out = ROOT / "build" / "probe_adjoint_tiles"
    out.mkdir(parents=True, exist_ok=True)
    src = native.CSRC / "roi_adjoint.cu"
    jobs = {}
    for tile in tiles:
        for probed in (False, True):
            lib = out / f"libadjoint_p5_{tile}{'_probe' if probed else ''}.so"
            defs = [f"-DSEAM_ADJOINT_P5_TILE={tile}"] + (["-DSEAM_ADJOINT_PROBE"] if probed else [])
            jobs[tile, probed] = (lib, subprocess.Popen(
                [native._nvcc(), *native.NVCC_FLAGS, *defs, "-I", str(native.CSRC), "-shared",
                 "-o", str(lib), str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for key, (lib, proc) in jobs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise SystemExit(f"probe_adjoint_tiles: nvcc failed for {lib.name}:\n{log}")
        libs[key] = ctypes.CDLL(str(lib))
        libs[key].seam_roi_align_adjoint.argtypes = native._SIGNATURES["seam_roi_align_adjoint"]
        libs[key].seam_roi_align_adjoint.restype = ctypes.c_int
    return libs


def anchor_rois(rng, b, n, h=800, w=1344):
    """Anchor-like boxes (16..800 px, aspect 1:3..3:1) inside an h x w image."""
    size = np.exp(rng.uniform(np.log(16), np.log(800), (b, n)))
    aspect = np.exp(rng.uniform(np.log(1 / 3), np.log(3), (b, n)))
    bw, bh = size * np.sqrt(aspect), size / np.sqrt(aspect)
    cx, cy = rng.uniform(0, w, (b, n)), rng.uniform(0, h, (b, n))
    boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    boxes[..., 0::2] = boxes[..., 0::2].clip(0, w)
    boxes[..., 1::2] = boxes[..., 1::2].clip(0, h)
    return boxes.astype(np.float32)


def crowd_rois(rng, b, n, h=800, w=1344):
    """A quarter of the rois within ~10% of 1-3 garment boxes (20-60% of the
    image's sides) per image, the rest anchor-like."""
    rois = anchor_rois(rng, b, n, h, w)
    pos = n // 4
    for i in range(b):
        k = rng.randint(1, 4)
        gw, gh = w * rng.uniform(0.2, 0.6, k), h * rng.uniform(0.2, 0.6, k)
        gx, gy = rng.uniform(0, w - gw), rng.uniform(0, h - gh)
        which = rng.randint(0, k, pos)
        jit = rng.uniform(-0.1, 0.1, (pos, 4))
        bw, bh = gw[which], gh[which]
        rois[i, :pos] = np.stack([gx[which] + jit[:, 0] * bw, gy[which] + jit[:, 1] * bh,
                                  gx[which] + bw * (1 + jit[:, 2]),
                                  gy[which] + bh * (1 + jit[:, 3])], -1).clip(0, [w, h, w, h])
    return rois


def phase1_cases(dev):
    """(name, cotangent, rois, level shapes) of every K5 call in one phase-1
    step of the single-orientation batch and one of the mixed batch, as
    ``tools/profile_torch_train.py`` builds them."""
    from chip_smoke import train_batch
    from profile_torch_train import MIXED, SINGLE
    from seam_match_rcnn_tpu_torch.config import (RoIHeadsConfig, TrainConfig,
                                                  serving_model_config)
    from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model
    from seam_match_rcnn_tpu_torch.train.engine import bucket_batches
    from seam_match_rcnn_tpu_torch.train.optim import multistep_warmup_schedule, sgd
    from seam_match_rcnn_tpu_torch.train.steps import Phase1Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = serving_model_config(roi_heads=RoIHeadsConfig(roi_align_backend="pallas_resident"),
                               freeze_backbone_stages=True)
    model = init_model(cfg, video=False, seed=0, device=dev)
    tc = TrainConfig()
    trainer = Phase1Trainer(model, sgd(model, multistep_warmup_schedule(
        tc.lr, tc.milestones, tc.gamma, 1000, tc.warmup_iters, tc.warmup_factor)))
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.RandomState(3)
    calls = []
    adjoint = cuda_roi_align.roi_align_adjoint

    def record(grad, rois, level_shapes, dtype, sampling_ratio=2,
               spatial_scales=SPATIAL_SCALES):
        calls.append((grad.clone(), rois.clone(), tuple(tuple(s) for s in level_shapes)))
        return adjoint(grad, rois, level_shapes, dtype, sampling_ratio, spatial_scales)

    record.launches = 0  # the wrapper counts its launches under its module name
    cases = []
    cuda_roi_align.roi_align_adjoint = record
    try:
        for name, sizes in (("single", SINGLE), ("mixed", MIXED)):
            trainer.step(bucket_batches(model, *train_batch(rng, sizes), 24, dev), gen)
            for i, (g, rois, shapes) in enumerate(calls):
                b, n, o = g.shape[:3]
                cases.append((f"{name} step call {i}: {b}x{n} rois {o}x{o}", g, rois, shapes))
            calls.clear()
    finally:
        cuda_roi_align.roi_align_adjoint = adjoint
    del model, trainer
    torch.cuda.empty_cache()
    return cases


def summarize(rec: np.ndarray, sms: int) -> dict:
    start, end = rec[:, 0].astype(np.int64), rec[:, 1].astype(np.int64)
    t0 = int(start.min())
    span = int(end.max()) - t0
    us = (end - start) / 1e3
    # blocks running over time: fewer than one an SM is the tail
    events = sorted([(int(s) - t0, 1) for s in start] + [(int(e) - t0, -1) for e in end])
    running, last, thin = 0, 0, 0
    for t, d in events:
        if running < sms:
            thin += t - last
        running, last = running + d, t
    levels = {}
    for lv in range(4):
        at = rec[:, 3] == lv
        if at.any():
            levels[f"P{lv + 2}"] = {
                "blocks": int(at.sum()), "median_us": float(np.median(us[at])),
                "max_us": float(us[at].max()), "sum_us": float(us[at].sum()),
                "mean_listed": float(rec[at, 4].mean()), "max_listed": int(rec[at, 4].max()),
                "mean_visits": float(rec[at, 5].mean()), "max_visits": int(rec[at, 5].max())}
    phases = {k: float(rec[:, 6 + i].sum()) for i, k in enumerate(PHASES)}
    worst = np.argsort(-us)[:5]
    return {"span_us": span / 1e3, "blocks": len(rec), "block_us_sum": float(us.sum()),
            "tail_share": thin / span, "phase_cycles": phases, "levels": levels,
            "slowest": [{"block": int(i), "level": f"P{int(rec[i, 3]) + 2}", "us": float(us[i]),
                         "listed": int(rec[i, 4]), "visits": int(rec[i, 5])} for i in worst]}


def run_case(libs, tiles, g, rois, shapes, sms, dev):
    """Each tile's event time, probe summary and error on one call's inputs."""
    from chip_smoke import bf16_ulp
    b, n, o, _, c = g.shape
    sizes = [b * h * w * c for h, w in shapes]
    flat = torch.empty(sum(sizes), dtype=torch.bfloat16, device=dev)
    levels = [v.view(b, h, w, c) for v, (h, w) in zip(torch.split(flat, sizes), shapes)]
    want = multilevel_roi_align_adjoint(g, rois, shapes)
    mass = multilevel_roi_align_adjoint(g.abs(), rois, shapes)
    lvl = roi_footprints(rois, shapes, o)[0]
    row = {"rois_by_level": [int((lvl == k).sum()) for k in range(4)], "tiles": {}}

    def launch(lib):
        native.check(lib.seam_roi_align_adjoint(
            *[v.data_ptr() for v in levels], *[h for h, _ in shapes], *[w for _, w in shapes],
            *SPATIAL_SCALES, g.data_ptr(), rois.data_ptr(), b * n, n, c, o, 2, 1,
            native.stream(dev)), "roi_align_adjoint")

    for tile in tiles:
        lib = libs[tile, False]
        for _ in range(3):
            launch(lib)
        torch.cuda.synchronize()
        # the smoke's tolerance: 1e-5 x sum |summands| + 1e-7 + one bf16 ulp
        ok = all(bool(((a.float() - w).abs() <= 1e-5 * m + 1e-7 + bf16_ulp(w)).all())
                 for a, w, m in zip(levels, want, mass))
        err = max(float((a.float() - w).abs().max()) for a, w in zip(levels, want))
        first = flat.clone()
        times = []
        for _ in range(20):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            launch(lib)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        deterministic = torch.equal(first.view(torch.int16), flat.view(torch.int16))
        probe = libs[tile, True]
        blocks = b * sum(-(-h // 4) * -(-w // 4) for h, w in shapes) * -(-c // 256)  # at most
        rec = torch.zeros((blocks, len(FIELDS)), dtype=torch.int64, device=dev)
        native.check(probe.seam_probe_records(ctypes.c_void_p(rec.data_ptr())),
                     "seam_probe_records")
        for _ in range(2):  # the last launch is read, with its code and data warm
            launch(probe)
        torch.cuda.synchronize()
        rec = rec.cpu().numpy()
        row["tiles"][f"p5_{tile}"] = {
            "ms": statistics.median(times), "ms_all": times, "max_abs_err": err,
            "within_tolerance": ok, "deterministic": deterministic,
            **summarize(rec[rec[:, 1] > 0], sms)}
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--p5-tiles", default="4,8", help="P5 tile sides to compare")
    ap.add_argument("--out", default="build/adjoint_tiles.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_adjoint_tiles: no CUDA device")
    sys.path.insert(0, str(ROOT / "tools"))
    tiles = [int(t) for t in args.p5_tiles.split(",")]
    libs = build(tiles)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [("phase1 " + name, g, rois, shapes)
             for name, g, rois, shapes in phase1_cases(dev)]
    rng = np.random.RandomState(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for kind, make in (("anchors", anchor_rois), ("crowd", crowd_rois)):
        for b, n, o in ((8, 512, 7), (8, 128, 14)):
            cases.append((f"{kind} {b}x{n} rois {o}x{o}", torch.randn(
                (b, n, o, o, 256), generator=gen, device=dev),
                torch.from_numpy(make(rng, b, n)).to(dev), PYRAMID))
    report = {"cases": []}
    all_ok = True
    for name, g, rois, shapes in cases:
        row = {"case": name, "levels": [list(s) for s in shapes],
               **run_case(libs, tiles, g, rois, shapes, sms, dev)}
        report["cases"].append(row)
        all_ok &= all(t["within_tolerance"] and t["deterministic"] for t in row["tiles"].values())
        print(json.dumps({"case": name, "rois_by_level": row["rois_by_level"], **{
            k: {f: t[f] for f in ("ms", "span_us", "tail_share", "max_abs_err", "deterministic")}
            | {lv: {f: t["levels"][lv][f] for f in ("max_us", "mean_listed", "max_listed")}
               for lv in t["levels"]}
            for k, t in row["tiles"].items()}}), flush=True)
    report["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    line = json.dumps(report)
    print(line)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(line + "\n")
    if not all_ok:
        raise SystemExit("probe_adjoint_tiles: a tile size disagreed with the plain adjoint "
                         "or was not deterministic")


if __name__ == "__main__":
    main()
