"""Eval CLI: MultiDeepFashion2 retrieval, on PyTorch.

Port of ``seam_match_rcnn_tpu/cli/evaluate_multidf2.py`` (the reference's
evaluate_multiDF2.py __main__), flag for flag, plus ``--device`` (default
``cuda``; without a card, pass ``--device cpu``):

  python -m seam_match_rcnn_tpu_torch.cli.evaluate_multidf2 \\
      --root_test data/deepfashion2/validation/image \\
      --test_annots data/deepfashion2/validation/annots.json \\
      --ckpt_path ckpt/seam_mdf2/final.pt

``--ckpt_path`` as in ``cli.evaluate_movingfashion``; ``main`` returns the
(single, avg, aggr) top-1 accuracies.
"""

from __future__ import annotations

import argparse
import os

from ..config import EvalConfig
from ..data.multidf2 import MultiDeepFashion2Dataset
from ..eval.multidf2 import evaluate
from ..parallel.collectives import initialize_distributed, is_main_process
from ._args import add_device_flag, check_device
from .evaluate_movingfashion import load_eval_model
from .train_multidf2 import eval_products


def build_argparser():
    p = argparse.ArgumentParser("PyTorch SEAM Match R-CNN MultiDF2 eval")
    p.add_argument("--root_test", type=str, default="data/deepfashion2/validation/image")
    p.add_argument("--test_annots", type=str, default="data/deepfashion2/validation/annots.json")
    p.add_argument("--frames_per_shop_test", type=int, default=10)
    p.add_argument("--first_n_withvideo", type=int, default=100)
    p.add_argument("--score_threshold", type=float, default=0.0)
    p.add_argument("--ckpt_path", type=str, default="ckpt/SEAM/multiDF2/DF2_epoch031")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic DeepFashion2 fixture and "
                        "evaluate on it: a dataset-free end-to-end run")
    p.add_argument("--fp16_gallery", action="store_true",
                   help="score the gallery with the reference's numpy-fp16 "
                        "chain (bit-faithful rank parity; default: f32 on "
                        "the device, algebraically identical)")
    p.add_argument("--device_ingest", action="store_true",
                   help="upload raw frames and resize them on the device "
                        "instead of cv2 on the host (eval/runner "
                        "ingest='device')")
    p.add_argument("--exact_roi_align", action="store_true",
                   help="the plain PyTorch versions of every kernel "
                        "(ModelConfig()) instead of the serving profile's "
                        "CUDA kernels")
    add_device_flag(p)
    return p


def main(argv=None):
    # as the JAX CLI: the group is joined, the evaluation is not sharded
    # (every rank runs all of it; rank 0 writes the artifacts)
    initialize_distributed()  # no-op unless SEAM_MULTIHOST=1
    args = build_argparser().parse_args(argv)
    device = check_device(args.device)
    if args.synthetic:
        import tempfile

        from ..data import convert as conv
        from ..data.synthetic import make_synthetic_df2

        root = tempfile.mkdtemp(prefix="seam_synth_mdf2_")
        img_dir, ann_dir = make_synthetic_df2(
            root, n_products=3, views_per_side=2, image_size=(120, 150))
        ann = os.path.join(root, "annots.json")
        conv.convert(img_dir, ann_dir, ann)
        args.root_test, args.test_annots = img_dir, ann
        args.frames_per_shop_test = min(args.frames_per_shop_test, 2)
        args.out_dir = os.path.join(root, "logs_mdf2")
    model = load_eval_model(args, device)
    ds = MultiDeepFashion2Dataset(args.test_annots, args.root_test,
                                  noise=False, filter_onestreet=True)
    return evaluate(
        model,
        eval_products(ds, args.frames_per_shop_test, args.first_n_withvideo),
        EvalConfig(score_threshold=args.score_threshold,
                   frames_per_product=args.frames_per_shop_test,
                   first_n_withvideo=args.first_n_withvideo,
                   ingest="device" if args.device_ingest else "host",
                   gallery_dtype="fp16" if args.fp16_gallery else "f32",
                   tracking_threshold=0.7),
        out_dir=getattr(args, "out_dir", "logs_mdf2"), save_artifacts=is_main_process(),
    )


if __name__ == "__main__":
    main()
