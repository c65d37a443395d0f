"""Retrieval-accuracy parity gate of the PyTorch port: the one-command 0.5%
top-1 gate, the counterpart of tools/validate_parity.py.

  python tools/validate_parity_torch.py \\
      --root data/MovingFashion --test_annots data/MovingFashion/test.json \\
      --ckpt ckpt/seam_mf/final.pt \\
      [--profiles exact serving fast] [--reference_csv logs_mf/<torch>.csv]

Profiles: ``exact`` (``ModelConfig()``: the plain stem, RoIAlign and NLB;
the semantics gate), ``serving`` (``serving_model_config()``: the fused stem
K1, the exact RoIAlign K2 and the NLB K3 of ``seam_match_rcnn_tpu_torch/csrc/``;
its drift must stay within 0.5%),
``fast`` (serving with torchvision's default 1000 post-NMS proposals).
``--reference_csv`` takes the CSV the torch reference writes (its
evaluate_movingfashion.py:441-443: rows single / product-max / avg-desc /
aggr-desc, columns k thresholds, in percent); our ``exact`` numbers are gated
against it, and every other profile against ``exact``.  The script prints
the results as JSON, a ``PARITY_JSON`` line, one line per gated value, and
exits 0 when every delta is within the gate, else 1.

``--ckpt`` is a torch file (the port's phase-2 ``final.pt`` or the
reference's released checkpoint); an Orbax directory of the JAX package
raises, and ``tools/orbax_to_torch.py`` converts it.  ``--synthetic
[--small]`` runs the same pipeline on a generated MovingFashion fixture with
random weights: a rehearsal of the gate without data, whose verdict says
nothing about accuracy.  ``--device`` (default ``cuda``) as the port's CLIs.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _flag(v) -> bool:
    # argparse type=bool parses "False" as True; accept real booleans
    return str(v).lower() in ("1", "true", "yes")


def build_config(profile, small):
    import dataclasses

    from seam_match_rcnn_tpu_torch.config import (ModelConfig, TransformConfig,
                                                  fast_eval_model_config,
                                                  serving_model_config)

    if profile in ("exact", "parity"):
        cfg = ModelConfig()
    elif profile == "serving":
        cfg = serving_model_config()
    elif profile == "fast":
        cfg = fast_eval_model_config()
    else:
        raise SystemExit(f"unknown profile {profile!r}; "
                         "expected exact|serving|fast")
    if small:
        cfg = dataclasses.replace(
            cfg,
            compute_dtype="float32",
            rpn=dataclasses.replace(
                cfg.rpn, pre_nms_top_n_test=60,
                post_nms_top_n_test=80 if profile != "fast" else 40),
            roi_heads=dataclasses.replace(cfg.roi_heads, detections_per_img=8),
            transform=TransformConfig(min_size=96, max_size=128),
        )
    return cfg


def run_profile(profile, args):
    import os

    from seam_match_rcnn_tpu_torch.ckpt.torch_convert import load_pretrained_detector
    from seam_match_rcnn_tpu_torch.cli.train_movingfashion import _eval_products
    from seam_match_rcnn_tpu_torch.config import EvalConfig
    from seam_match_rcnn_tpu_torch.data.movingfashion import MovingFashionDataset
    from seam_match_rcnn_tpu_torch.eval.movingfashion import evaluate
    from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model

    cfg = build_config(profile, args.small)
    model = init_model(cfg, video=True, device=args.device)
    if args.ckpt:
        # a directory (Orbax) raises, pointing to tools/orbax_to_torch.py
        load_pretrained_detector(args.ckpt, model, clone_match_to_aggregator=False)

    ds = MovingFashionDataset(args.test_annots, root=args.root,
                              noise=_flag(args.noise))
    r1, r2, r3 = evaluate(
        model,
        _eval_products(ds, args.frames_per_shop_test, args.first_n_withvideo),
        EvalConfig(score_threshold=args.score_threshold,
                   frames_per_product=args.frames_per_shop_test,
                   first_n_withvideo=args.first_n_withvideo,
                   gallery_dtype="fp16" if args.fp16_gallery else "f32"),
        out_dir=os.path.join(args.out_dir, f"logs_mf_{profile}"),
    )
    return {"top1_single": r1, "top1_avg_desc": r2, "top1_aggr_desc": r3}


def load_reference_csv(path):
    import numpy as np

    perf = np.loadtxt(path, delimiter="\t") / 100.0
    # reference rows (evaluate_movingfashion.py:435-438):
    # 0 single-frame, 1 product max, 2 avg desc, 3 aggr desc; col 0 = top-1
    return {"top1_single": float(perf[0, 0]),
            "top1_avg_desc": float(perf[2, 0]),
            "top1_aggr_desc": float(perf[3, 0])}


def check_gate(results, baseline_key, out, gate=0.005):
    ok = True
    for name, res in results.items():
        if name == baseline_key:
            continue
        for k in ("top1_single", "top1_avg_desc", "top1_aggr_desc"):
            d = abs(res[k] - results[baseline_key][k])
            passed = d <= gate
            ok &= passed
            out.append(f"{name} vs {baseline_key} {k}: delta {d:.4f} "
                       f"[{'PASS' if passed else 'FAIL'} {gate * 100:.1f}% gate]")
    return ok


def main(argv=None):
    p = argparse.ArgumentParser("retrieval parity validation (PyTorch port)")
    p.add_argument("--root", type=str, default=None)
    p.add_argument("--test_annots", type=str, default=None)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--profiles", nargs="+", default=["exact", "serving", "fast"])
    p.add_argument("--frames_per_shop_test", type=int, default=10)
    p.add_argument("--first_n_withvideo", type=int, default=100)
    p.add_argument("--score_threshold", type=float, default=0.0)
    p.add_argument("--noise", type=_flag, default=True)
    p.add_argument("--out_dir", type=str, default=".")
    p.add_argument("--fp16_gallery", action="store_true",
                   help="reference numpy-fp16 gallery scoring chain")
    p.add_argument("--reference_csv", type=str, default=None,
                   help="logs_mf CSV produced by the torch reference")
    p.add_argument("--synthetic", action="store_true",
                   help="generated MovingFashion fixture, random weights")
    p.add_argument("--small", action="store_true",
                   help="reduced geometry (synthetic rehearsal only)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the model: 'cuda' (the default; raises "
                        "without a card) or 'cpu'")
    args = p.parse_args(argv)

    from seam_match_rcnn_tpu_torch.cli._args import check_device

    check_device(args.device)
    if args.synthetic:
        import tempfile

        from seam_match_rcnn_tpu_torch.data.synthetic import make_synthetic_movingfashion

        root = tempfile.mkdtemp(prefix="validate_parity_synth_")
        args.root = root
        args.test_annots = make_synthetic_movingfashion(root, n_products=3)
        args.frames_per_shop_test = 3
        args.out_dir = root
    elif not (args.root and args.test_annots and args.ckpt):
        p.error("--root/--test_annots/--ckpt required without --synthetic")

    results = {name: run_profile(name, args) for name in args.profiles}
    if args.reference_csv:
        results["reference"] = load_reference_csv(args.reference_csv)

    print(json.dumps(results, indent=2))
    # single-line machine-readable mirror (the eval harness prints tables
    # around the pretty JSON)
    print("PARITY_JSON " + json.dumps(results))
    lines: list = []
    ok = True
    if "reference" in results and any(
            k in results for k in ("exact", "parity")):
        base = "exact" if "exact" in results else "parity"
        # gate OUR exact semantics against the reference numbers...
        ok &= check_gate({k: v for k, v in results.items()
                          if k in (base, "reference")}, "reference", lines)
    if ("exact" in results or "parity" in results) and len(results) > 1:
        # ...and every throughput profile against our exact semantics
        base = "exact" if "exact" in results else "parity"
        ok &= check_gate({k: v for k, v in results.items()
                          if k != "reference"}, base, lines)
    for ln in lines:
        print(ln)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
