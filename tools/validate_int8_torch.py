"""pallas_int8 accuracy gate of the PyTorch port: measured retrieval deltas,
the counterpart of tools/validate_int8.py.

The int8 profile quantizes the feature pyramid to int8 per channel and
pools it with int32 sums (kernel K7, ``csrc/roi_align_patch.cu``).
Whether ranks survive that drift is what this tool measures:

  1. trains phase-1 Match R-CNN on a synthetic DF2 fixture at REAL
     geometry (shared flow with tools/validate_fast_profile_torch.py);
  2. warm-starts the video model (reference load_saved_matchrcnn);
  3. runs BOTH eval harnesses — MovingFashion (all 7 strategies) and
     MultiDF2 — under serving profiles that differ ONLY in the RoIAlign
     backend: pallas_resident (K2, the serving default), pallas (K6, the
     40x48 window), pallas_int8 (K7);
  4. prints per-strategy top-1 deltas vs the serving default, and an
     ``INT8VAL_JSON`` line.

Synthetic garments are easier than real data, so zero delta is necessary
but not sufficient; a NONZERO delta kills the int8 profile outright.

  python tools/validate_int8_torch.py [--products 16] [--epochs 8] [--device cpu]

Flags, printed lines and JSON keys are the JAX tool's; ``--device``
(default ``cuda``, raising without a card) is the port's.
"""

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from seam_match_rcnn_tpu_torch.cli._args import add_device_flag, check_device  # noqa: E402
from seam_match_rcnn_tpu_torch.config import (RoIHeadsConfig,  # noqa: E402
                                              serving_model_config)
from tools import _synth_train_torch as st  # noqa: E402


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--products", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.001)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--backends", nargs="+",
                    default=["pallas_resident", "pallas", "pallas_int8"])
    ap.add_argument("--confusable", action="store_true",
                    help="near-pair palette (_synth_train.confusable_"
                    "palette): small retrieval margins so rank damage "
                    "can't hide inside a saturated top-1 table")
    add_device_flag(ap)
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)

    device = check_device(args.device)
    trained, palette, root = st.train_synthetic_phase1(
        args.products, args.epochs, args.batch, args.lr,
        palette_colors=(st.confusable_palette(args.products)
                        if args.confusable else None), device=device)

    mf, mdf2_fixture = st.eval_fixtures(root, args.products, palette)
    probe_images = st.probe_set(mf, args.frames)

    results, probes, mprobes = {}, {}, {}
    for backend in args.backends:
        vcfg = serving_model_config(
            roi_heads=RoIHeadsConfig(roi_align_backend=backend))
        results[backend], probes[backend], mprobes[backend] = st.harness_arm(
            vcfg, trained, backend, root, mf, mdf2_fixture, args.frames,
            probe_images, device)
        print(f"[{backend}] MF top-1: {results[backend]['mf']}")
        print(f"[{backend}] MDF2 top-1: {results[backend]['mdf2']}")

    base = args.backends[0]
    deltas, drift, margins = st.gate_summary(results, probes, mprobes, args.backends)
    print("INT8VAL_JSON " + json.dumps(
        {"results": results, "deltas_vs_" + base: deltas,
         "probe_drift_vs_" + base: drift,
         "rank_margin_vs_" + base: margins,
         "confusable": args.confusable,
         "products": args.products, "frames": args.frames}))


if __name__ == "__main__":
    main()
