"""Fast-profile (1000 post-NMS proposals) accuracy validation of the
PyTorch port on synthetic data at FULL serving geometry, the counterpart of
tools/validate_fast_profile.py.

The fast profile cuts the box branch's RoIAlign work 4x (torchvision's
default 1000 post-NMS proposals instead of the reference's 4000).  Its
top-k drift cannot be validated without real data; this tool produces the
best available evidence instead:

  1. trains phase-1 Match R-CNN on a synthetic DeepFashion2 fixture at the
     REAL geometry (min side 800) until it detects the garments reliably
     (shared flow: tools/_synth_train_torch.py);
  2. warm-starts the video model from that checkpoint (the reference
     load_saved_matchrcnn flow);
  3. runs the MovingFashion eval twice — serving profile (4000 proposals)
     vs fast profile (1000) — with IDENTICAL weights and kernels, so the
     only difference is the proposal-count knob;
  4. prints top-1 deltas for ALL SEVEN retrieval strategies, and a
     ``FASTVAL_JSON`` line.

Synthetic garments are easier than real data (high-contrast rectangles),
so a zero delta here is necessary but not sufficient; a NONZERO delta
would kill the default-flip outright.

  python tools/validate_fast_profile_torch.py [--products 8] [--epochs 6] [--device cpu]

Flags, printed lines and JSON keys are the JAX tool's; ``--device``
(default ``cuda``, raising without a card) is the port's.
"""

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from seam_match_rcnn_tpu_torch.cli._args import add_device_flag, check_device  # noqa: E402
from seam_match_rcnn_tpu_torch.config import (EvalConfig,  # noqa: E402
                                              fast_eval_model_config,
                                              serving_model_config)
from seam_match_rcnn_tpu_torch.data.movingfashion import MovingFashionDataset  # noqa: E402
from seam_match_rcnn_tpu_torch.data.synthetic import make_synthetic_movingfashion  # noqa: E402
from seam_match_rcnn_tpu_torch.eval.movingfashion import evaluate  # noqa: E402
from tools import _synth_train_torch as st  # noqa: E402


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--products", type=int, default=16)
    ap.add_argument("--eval_products", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.001)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--confusable", action="store_true",
                    help="near-pair palette (_synth_train.confusable_"
                    "palette): small retrieval margins so rank damage "
                    "can't hide inside a saturated top-1 table")
    add_device_flag(ap)
    return ap


def shared_palette(args):
    """One shared palette: the match head trains on and retrieves the SAME
    product identities (color is the only retrieval signal in the synthetic
    family; unseen colors evaluate at chance)."""
    palette_rng = np.random.RandomState(42)
    n_colors = max(args.products, args.eval_products)
    if args.confusable:
        return st.confusable_palette(n_colors)
    return [list(map(int, palette_rng.randint(64, 255, 3)))
            for _ in range(n_colors)]


def profile_arm(name, vcfg, trained, root, mf, frames, device="cuda"):
    """One profile: the warm-started video model of ``vcfg``, the
    MovingFashion eval (logs under ``root``/logs_``name``) and the
    rank-margin probe; the model is released before it returns."""
    vmodel = st.video_vars(vcfg, trained, device)
    out_dir = os.path.join(root, f"logs_{name}")
    evaluate(
        vmodel,
        st._eval_products(mf, frames, None),
        EvalConfig(frames_per_product=frames, first_n_withvideo=None),
        out_dir=out_dir,
    )
    top1 = st.all_strategy_top1(out_dir)
    # full-fixture rank+margin instrument
    mprobe = st.rank_margin_probe(vmodel, st._eval_products(mf, frames, None))
    del vmodel
    st.release()
    return top1, mprobe


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = check_device(args.device)
    trained, palette, root = st.train_synthetic_phase1(
        args.products, args.epochs, args.batch, args.lr,
        palette_colors=shared_palette(args), device=device)

    mf_json = make_synthetic_movingfashion(
        os.path.join(root, "mf"), n_products=args.eval_products, n_frames=8,
        colors=palette)
    mf = MovingFashionDataset(mf_json, root=os.path.join(root, "mf"),
                              noise=True)

    results, mprobes = {}, {}
    for name, vcfg in (("serving", serving_model_config()),
                       ("fast", fast_eval_model_config())):
        results[name], mprobes[name] = profile_arm(name, vcfg, trained, root, mf,
                                                   args.frames, device)
        print(f"[{name}] top-1 by strategy: {results[name]}")

    deltas = {k: results["fast"][k] - results["serving"][k]
              for k in results["serving"]}
    print("FASTVAL_JSON " + json.dumps(
        {"results": results, "deltas": deltas,
         "rank_margin_fast_vs_serving": st.margin_analysis(
             mprobes["serving"], mprobes["fast"]),
         "confusable": args.confusable,
         "products": args.eval_products, "frames": args.frames}))


if __name__ == "__main__":
    main()
