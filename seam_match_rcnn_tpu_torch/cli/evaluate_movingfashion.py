"""Eval CLI: MovingFashion video-to-shop retrieval, on PyTorch.

Port of ``seam_match_rcnn_tpu/cli/evaluate_movingfashion.py`` (the
reference's evaluate_movingfashion.py __main__), flag for flag, plus
``--device`` (default ``cuda``; without a card, pass ``--device cpu``):

  python -m seam_match_rcnn_tpu_torch.cli.evaluate_movingfashion \\
      --root data/MovingFashion --ckpt_path ckpt/seam_mf/final.pt

``--ckpt_path`` is a torch file: the port's phase-2 ``final.pt`` or the
reference's released checkpoint (a file without an aggregator gets the
phase-1 warm start, ``ckpt/torch_convert.load_pretrained_detector``).  An
Orbax directory of the JAX package raises; ``tools/orbax_to_torch.py``
converts it.  ``main`` returns the (single, avg, aggr) top-1 accuracies.
"""

from __future__ import annotations

import argparse
import os

from ..ckpt.torch_convert import load_pretrained_detector
from ..config import EvalConfig, ModelConfig, serving_model_config
from ..data.movingfashion import MovingFashionDataset
from ..eval.movingfashion import evaluate
from ..models.matchrcnn import init_model
from ..parallel.collectives import initialize_distributed, is_main_process
from ._args import add_device_flag, check_device, strtobool
from .train_movingfashion import _eval_products


def build_argparser():
    p = argparse.ArgumentParser("PyTorch SEAM Match R-CNN MovingFashion eval")
    p.add_argument("--root", type=str, default="data/MovingFashion")
    p.add_argument("--test_annots", type=str, default="data/MovingFashion/test.json")
    p.add_argument("--frames_per_shop_test", type=int, default=10)
    p.add_argument("--first_n_withvideo", type=int, default=100)
    p.add_argument("--score_threshold", type=float, default=0.0)
    p.add_argument("--noise", type=strtobool, default=True)
    p.add_argument("--ckpt_path", type=str, default="ckpt/SEAM/MovingFashion/MF_epoch031")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a tiny synthetic MovingFashion dataset "
                        "(real mp4 videos and schema-exact JSON) and evaluate "
                        "on it: an end-to-end run with no dataset downloads")
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


def load_eval_model(args, device):
    """The video model of ``args``' profile on ``device``, its weights from
    ``--ckpt_path``; a path that does not exist raises unless it is empty or
    ``--synthetic`` (random weights)."""
    cfg = ModelConfig() if args.exact_roi_align else serving_model_config()
    model = init_model(cfg, video=True, device=device)
    if args.ckpt_path and os.path.exists(args.ckpt_path):
        load_pretrained_detector(args.ckpt_path, model, clone_match_to_aggregator=False)
    elif args.ckpt_path and not args.synthetic:
        # fail fast: silently evaluating random weights looks like a model
        # regression and wastes the whole eval run
        raise FileNotFoundError(
            f"--ckpt_path {args.ckpt_path!r} does not exist (pass "
            "--ckpt_path '' explicitly to evaluate random-init weights)")
    return model


def main(argv=None):
    # as the JAX CLI: the group is joined, the evaluation is not sharded
    # (every rank runs all of it; rank 0 writes the artifacts)
    initialize_distributed()  # no-op unless SEAM_MULTIHOST=1
    args = build_argparser().parse_args(argv)
    device = check_device(args.device)
    if args.synthetic:
        import tempfile

        from ..data.synthetic import make_synthetic_movingfashion

        root = tempfile.mkdtemp(prefix="seam_synth_mf_")
        args.test_annots = make_synthetic_movingfashion(root, n_products=3)
        args.root = root
        args.frames_per_shop_test = min(args.frames_per_shop_test, 4)
        args.out_dir = os.path.join(root, "logs_mf")
    model = load_eval_model(args, device)
    ds = MovingFashionDataset(args.test_annots, root=args.root, noise=args.noise)
    return evaluate(
        model,
        _eval_products(ds, args.frames_per_shop_test, args.first_n_withvideo),
        EvalConfig(score_threshold=args.score_threshold,
                   frames_per_product=args.frames_per_shop_test,
                   first_n_withvideo=args.first_n_withvideo,
                   ingest="device" if args.device_ingest else "host",
                   gallery_dtype="fp16" if args.fp16_gallery else "f32"),
        out_dir=getattr(args, "out_dir", "logs_mf"), save_artifacts=is_main_process(),
    )


if __name__ == "__main__":
    main()
