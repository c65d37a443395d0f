"""bf16 match-trunk accuracy gate of the PyTorch port, the counterpart of
tools/validate_trunk_dtype.py.

``MatchHeadConfig.trunk_dtype="bfloat16"`` runs the match/aggregator conv
trunks (4 valid 3x3 convs per trunk — the FLOPs of the serving tail) in
bf16 through cuDNN; pool/linear/BN/descriptors stay f32
(models/match_head.MatchTrunk).  Whether retrieval ranks survive the conv
rounding is what this tool measures, mirroring tools/validate_int8_torch.py:

  1. trains phase-1 Match R-CNN on a synthetic DF2 fixture at REAL
     geometry (shared flow, tools/_synth_train_torch.py);
  2. warm-starts the video model (reference load_saved_matchrcnn);
  3. runs BOTH eval harnesses — MovingFashion (all 7 strategies) and
     MultiDF2 — under serving profiles differing ONLY in trunk_dtype, with
     the NLB on kernel K3 (``nlb_backend="pallas"``);
  4. prints per-strategy top-1 deltas vs the f32 default, and a
     ``TRUNKVAL_JSON`` line.

Synthetic garments are easier than real data, so zero delta is necessary
but not sufficient; a NONZERO delta keeps the knob opt-in.

  python tools/validate_trunk_dtype_torch.py [--products 16] [--epochs 8] [--device cpu]

Flags, printed lines and JSON keys are the JAX tool's; ``--device``
(default ``cuda``, raising without a card) is the port's.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from seam_match_rcnn_tpu_torch.cli._args import add_device_flag, check_device  # noqa: E402
from seam_match_rcnn_tpu_torch.config import (MatchHeadConfig,  # noqa: E402
                                              serving_model_config)
from tools import _synth_train_torch as st  # noqa: E402


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--products", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.001)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--dtypes", nargs="+",
                    default=["float32", "bfloat16"])
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
    # fixed probe set for sub-quantum drift stats (see validate_int8_torch.py)
    probe_images = st.probe_set(mf, args.frames)

    results, probes, mprobes = {}, {}, {}
    for dt in args.dtypes:
        vcfg = serving_model_config(
            match=MatchHeadConfig(nlb_backend="pallas", trunk_dtype=dt))
        results[dt], probes[dt], mprobes[dt] = st.harness_arm(
            vcfg, trained, dt, root, mf, mdf2_fixture, args.frames,
            probe_images, device)
        print(f"[{dt}] MF top-1: {results[dt]['mf']}")
        print(f"[{dt}] MDF2 top-1: {results[dt]['mdf2']}")

    base = args.dtypes[0]
    deltas, drift, margins = st.gate_summary(results, probes, mprobes, args.dtypes)
    print("TRUNKVAL_JSON " + json.dumps(
        {"results": results, "deltas_vs_" + base: deltas,
         "probe_drift_vs_" + base: drift,
         "rank_margin_vs_" + base: margins,
         "confusable": args.confusable,
         "products": args.products, "frames": args.frames}))


if __name__ == "__main__":
    main()
