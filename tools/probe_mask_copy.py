"""Time the copy of detect's full-image masks from the card to the host, on one GPU.

    python3 tools/probe_mask_copy.py [--frames 5] [--out build/probe_mask_copy.json]

``SeamRetrieval.detect`` returns each image's masks as [D, H, W] f32 numpy
arrays (the JAX package's contract): 369 MB for 100 rows of a 720x1280
frame.  ``chip_smoke.py`` phase 6 timed that copy alone at ~146 ms a frame,
while a whole detect frame (forward, paste and copy) took 77-97 ms (NVIDIA
H100 80GB HBM3, 700 W).  This
times the copy of ``--frames`` pasted frames in the patterns that differ,
each with the process's minor page faults (``getrusage``) over its copies,
in the order E A B C D D C B A E (ms a frame, the median of a turn's
frames; E also the whole detect's ms a frame):

  A  synced: paste on the card, synchronize, then ``.cpu().numpy()``;
  B  inline: ``paste_masks(...).cpu().numpy()`` with no synchronize between
     (the runner's own line; the time includes the paste);
  C  preallocated pageable: ``copy_`` into a numpy buffer written beforehand;
  D  pinned: ``copy_`` into a page-locked buffer;
  E  detect: ``SeamRetrieval.detect`` of synthetic frames of that size on the
     full-width serving model, each ``.cpu()`` of its pasted masks timed
     inside the runner (the pasted tensor handed back as a subclass whose
     ``cpu`` keeps a clock).

Then A and E once more after the process has written and freed 8 GB of host
memory in 369 MB arrays (a long-running process, such as the smoke after
its first five phases, has done so).  Prints one JSON object (with the card's name and power limit and the
kernel's transparent-huge-page setting) and writes it to ``--out``.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import resource
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import serving_model, synthetic_image  # noqa: E402
from seam_match_rcnn_tpu_torch.eval import runner as runner_mod  # noqa: E402
from seam_match_rcnn_tpu_torch.ops.masks import paste_masks  # noqa: E402
from seam_match_rcnn_tpu_torch.serving import SeamRetrieval  # noqa: E402

H, W, D = 720, 1280, 100


def faults() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_minflt


class _ClockedCopy(torch.Tensor):
    """A pasted mask tensor whose ``cpu`` records its own time."""

    record = []

    def cpu(self, *a, **kw):
        t0, f0 = time.perf_counter(), faults()
        out = torch.Tensor.cpu(self.as_subclass(torch.Tensor), *a, **kw)
        _ClockedCopy.record.append(((time.perf_counter() - t0) * 1e3, faults() - f0))
        return out


def paste_inputs(dev, rng, n):
    out = []
    for _ in range(n):
        m = torch.from_numpy(rng.rand(D, 28, 28).astype(np.float32)).to(dev)
        x1, y1 = rng.uniform(0, W - 200, D), rng.uniform(0, H - 150, D)
        b = np.stack([x1, y1, x1 + rng.uniform(20, 600, D), y1 + rng.uniform(20, 500, D)], 1)
        out.append((m, torch.from_numpy(b.astype(np.float32)).to(dev)))
    return out


def run_case(case, dev, inputs, retr, frames):
    """-> (ms a frame, page faults a frame) of one turn of ``case``."""
    times, flt, kept = [], [], []
    if case == "E":
        _ClockedCopy.record = []
        t0 = time.perf_counter()
        retr.detect(frames)
        whole = (time.perf_counter() - t0) * 1e3 / len(frames)
        times, flt = zip(*[r for r in _ClockedCopy.record])
        return statistics.median(times), statistics.median(flt), whole
    bufs = []
    if case == "C":
        bufs = [np.empty((D, H, W), np.float32) for _ in inputs]
        for b in bufs:
            b.fill(0.0)
    if case == "D":
        bufs = [torch.empty((D, H, W), dtype=torch.float32, pin_memory=True) for _ in inputs]
    for i, (m, b) in enumerate(inputs):
        p = paste_masks(m, b, H, W)
        if case != "B":
            torch.cuda.synchronize()
        t0, f0 = time.perf_counter(), faults()
        if case in ("A", "B"):
            kept.append(p.cpu().numpy())
        elif case == "C":
            torch.from_numpy(bufs[i]).copy_(p)
        else:
            bufs[i].copy_(p)
        times.append((time.perf_counter() - t0) * 1e3)
        flt.append(faults() - f0)
        del p
    return statistics.median(times), statistics.median(flt)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--out", default="build/probe_mask_copy.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_mask_copy: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(0)
    inputs = paste_inputs(dev, rng, args.frames)
    frames = [synthetic_image(rng, H, W)[0] for _ in range(args.frames)]
    retr = SeamRetrieval(serving_model(dev), chunk=11)
    plain_paste = runner_mod.paste_masks
    runner_mod.paste_masks = lambda *a: plain_paste(*a).as_subclass(_ClockedCopy)
    retr.detect(frames[:1])  # warm-up
    for m, b in inputs[:1]:
        paste_masks(m, b, H, W).cpu()
    order = ["E", "A", "B", "C", "D"]
    turns = {c: [] for c in order}
    for case in order + order[::-1]:
        turns[case].append(run_case(case, dev, inputs, retr, frames))
        torch.cuda.empty_cache()
    for _ in range(22):  # 8 GB of host memory written and freed, an array at a time
        np.ones((D, H, W), np.float32)
    churned = {c: run_case(c, dev, inputs, retr, frames) for c in ("A", "E")}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    thp = Path("/sys/kernel/mm/transparent_hugepage/enabled")
    result = {"card": smi, "frame": [D, H, W], "mbytes_a_frame": D * H * W * 4 / 1e6,
              "transparent_hugepage": thp.read_text().strip() if thp.exists() else None,
              "cases": {c: {"ms_a_frame": [t[0] for t in v],
                            "page_faults_a_frame": [t[1] for t in v],
                            **({"detect_ms_a_frame": [t[2] for t in v]} if c == "E" else {})}
                        for c, v in turns.items()},
              "after_8gb_churn": {c: {"ms_a_frame": t[0], "page_faults_a_frame": t[1]}
                                  for c, t in churned.items()}}
    print(json.dumps(result))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
