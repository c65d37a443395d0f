"""The NMS fixed point of ``ops/nms.py`` on one GPU: the ``while_loop``
operator called directly (the port's), the public ``while_loop`` wrapper
(which compiles each call with Dynamo), and the Python loop that breaks on
``torch.equal`` (the port before the ``while_loop``), on the same boxes.

    python3 tools/time_torch_nms.py [--reps 9]

For each [M, N] of the serving path (the RPN's per-level batch of 11 images x
5 levels at 1000 boxes, 11 x 4000, 11 x 1000, and a class-NMS-sized 14 x
300): whether each loop returns the old loop's kept mask, each one's first
call in the process (ms), and the median of ``--reps`` calls (ms, host clock
around a device synchronize).  Needs a CUDA device; prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch
from torch._higher_order_ops import while_loop

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from seam_match_rcnn_tpu_torch.ops import nms  # noqa: E402
from seam_match_rcnn_tpu_torch.ops.boxes import box_iou  # noqa: E402

SHAPES = ((55, 1000), (11, 4000), (11, 1000), (14, 300))


def _conflict(sboxes, thr):
    n = sboxes.shape[1]
    earlier = torch.ones((n, n), dtype=torch.bool, device=sboxes.device).tril(-1)
    return ((box_iou(sboxes, sboxes) > thr) & earlier).to(torch.float32)


def python_loop(sboxes, svalid, thr):
    conflict_f = _conflict(sboxes, thr)
    kept = svalid
    for _ in range(sboxes.shape[1]):
        hit = torch.bmm(conflict_f, kept.to(torch.float32)[..., None])[..., 0] > 0
        new = svalid & ~hit
        if torch.equal(new, kept):
            break
        kept = new
    return kept


def public_while_loop(sboxes, svalid, thr):
    conflict_f = _conflict(sboxes, thr)

    def step(kept, done):
        hit = torch.bmm(conflict_f, kept.to(torch.float32)[..., None])[..., 0] > 0
        new = svalid & ~hit
        return new, (new == kept).all()

    done = torch.zeros((), dtype=torch.bool, device=sboxes.device)
    return while_loop(lambda kept, done: ~done, step, (svalid, done))[0]


LOOPS = {"while_loop_op": nms._kept_sorted, "public_while_loop": public_while_loop,
         "python_loop": python_loop}


def synced_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_nms: no CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    rows = []
    for m, n in SHAPES:
        xy = torch.rand(m, n, 2, generator=gen) * 1000
        boxes = torch.cat([xy, xy + 20 + torch.rand(m, n, 2, generator=gen) * 200], -1).to(dev)
        valid = (torch.rand(m, n, generator=gen) > 0.05).to(dev)
        row = {"shape": [m, n], "first_ms": {}, "equal": {}, "median_ms": {}}
        for name, fn in LOOPS.items():
            row["first_ms"][name], _ = synced_ms(lambda: fn(boxes, valid, 0.7))
        want = python_loop(boxes, valid, 0.7)
        for name, fn in LOOPS.items():
            row["equal"][name] = bool(torch.equal(fn(boxes, valid, 0.7), want))
            row["median_ms"][name] = statistics.median(
                synced_ms(lambda: fn(boxes, valid, 0.7))[0] for _ in range(args.reps))
        rows.append(row)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nms": rows}))
    return 0 if all(all(r["equal"].values()) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
