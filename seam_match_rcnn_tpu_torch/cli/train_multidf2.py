"""Phase-2 CLI: SEAM training on MultiDeepFashion2, on PyTorch.

Port of ``seam_match_rcnn_tpu/cli/train_multidf2.py``, flag for flag, plus
``--device`` (default ``cuda``; without a card, pass ``--device cpu``): the
recipe of ``cli.train_movingfashion`` (the reference's train_multiDF2.py:
152-186) with lr 0.02, 8 products a batch and the aggregator-only MultiDF2
loss (``train.seam.make_mdf2_head_step``): the optimizer holds the temporal
aggregator's parameters only, so the match predictor stays bit-equal.

  python -m seam_match_rcnn_tpu_torch.cli.train_multidf2 \\
      --root_train data/deepfashion2/train/image \\
      --train_annots data/deepfashion2/train/annots.json \\
      --pretrained_path ckpt/matchrcnn/final.pt

Checkpoints, resume and the multi-process run are as in
``cli.train_movingfashion``.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..ckpt.io import CheckpointManager, training_payload
from ..ckpt.torch_convert import load_pretrained_detector
from ..config import EvalConfig, ModelConfig, SEAMTrainConfig, serving_model_config
from ..data.multidf2 import MultiDeepFashion2Dataset, product_batches
from ..data.prefetch import prefetch
from ..eval.multidf2 import evaluate
from ..eval.runner import InferenceRunner
from ..models.matchrcnn import init_model
from ..parallel.collectives import (initialize_distributed, is_main_process, process_count,
                                    process_index)
from ..parallel.mesh import make_mesh, replicate
from ..train.engine import train_one_epoch_multidf2
from ..train.optim import SGD, multistep_warmup_schedule
from ..train.seam import make_mdf2_head_step
from ..utils.logging import ScalarWriter
from ._args import add_device_flag, check_device, resume, strtobool


def build_argparser():
    p = argparse.ArgumentParser("PyTorch SEAM Match R-CNN MultiDF2 training")
    p.add_argument("--root_train", type=str, default="data/deepfashion2/train/image")
    p.add_argument("--train_annots", type=str, default="data/deepfashion2/train/annots.json")
    p.add_argument("--root_test", type=str, default="data/deepfashion2/validation/image")
    p.add_argument("--test_annots", type=str, default="data/deepfashion2/validation/annots.json")
    p.add_argument("--n_shops", type=int, default=8)
    p.add_argument("--frames_per_shop_train", type=int, default=10)
    p.add_argument("--frames_per_shop_test", type=int, default=10)
    p.add_argument("--epochs", type=int, default=31)
    # the reference's MultiDF2 lr is 0.02 (train_multiDF2.py:170), not
    # MovingFashion's 0.04
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--w_decay", type=float, default=5e-4)
    p.add_argument("--milestones", type=int, nargs="+", default=[15, 25])
    p.add_argument("--gamma", type=float, default=0.1)
    # the reference passes 0.1 into the epoch loop (train_multiDF2.py:113)
    p.add_argument("--score_thresh", type=float, default=0.1)
    p.add_argument("--eval_freq", type=int, default=4)
    p.add_argument("--save_epochs", type=int, default=2)
    p.add_argument("--save_steps", type=int, default=0,
                   help="also checkpoint every N product batches into an "
                        "overwriting 'mid' slot (0 = off); --start_ckpt on "
                        "a mid checkpoint resumes inside the epoch")
    p.add_argument("--save_tag", type=str, default="seam_mdf2")
    p.add_argument("--save_dir", type=str, default="ckpt")
    p.add_argument("--log_dir", type=str, default="runs")
    p.add_argument("--print_freq", type=int, default=20)
    p.add_argument("--first_n_withvideo", type=int, default=100)
    p.add_argument("--noise", type=strtobool, default=True)
    p.add_argument("--pretrained_path", type=str, default="ckpt/df2matchrcnn")
    p.add_argument("--start_ckpt", type=str, default=None)
    p.add_argument("--auto_resume", action="store_true",
                   help="resume from the newest checkpoint under "
                        "save_dir/save_tag (mid-epoch slot included) when "
                        "--start_ckpt is not given; no-op on a fresh run")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true",
                   help="train one epoch on a generated synthetic "
                        "MultiDF2 fixture (products with >= 3 street "
                        "views): a dataset-free end-to-end run of the "
                        "aggregator-only MultiDF2 loop")
    p.add_argument("--device_ingest", action="store_true",
                   help="raw-frame upload and resize on the device for the "
                        "frozen detector's inference (eval/runner "
                        "ingest='device'; default: cv2 on the host)")
    p.add_argument("--exact_roi_align", action="store_true",
                   help="the plain PyTorch versions of every kernel "
                        "(ModelConfig()) for the frozen detector's inference "
                        "instead of the serving profile's CUDA kernels")
    add_device_flag(p)
    return p


def main(argv=None):
    initialize_distributed()  # no-op unless SEAM_MULTIHOST=1
    args = build_argparser().parse_args(argv)
    device = check_device(args.device)
    rank, world = process_index(), process_count()
    if args.synthetic:
        import tempfile

        from ..data import convert as conv
        from ..data.synthetic import make_synthetic_df2

        root = tempfile.mkdtemp(prefix="seam_synth_mdf2_")
        # >= 3 street views a product: the MultiDF2 aggregation loss needs
        # >= 3 winners a sequence
        img_dir, ann_dir = make_synthetic_df2(
            root, n_products=3, views_per_side=4, image_size=(160, 200))
        ann = os.path.join(root, "annots.json")
        conv.convert(img_dir, ann_dir, ann)
        args.root_train = args.root_test = img_dir
        args.train_annots = args.test_annots = ann
        args.n_shops, args.frames_per_shop_train = 2, 3
        args.frames_per_shop_test = 3
        args.epochs, args.eval_freq, args.print_freq = 1, 1, 1
        args.save_dir = os.path.join(root, "ckpt")
        args.pretrained_path = ""
    cfg = ModelConfig() if args.exact_roi_align else serving_model_config()
    tcfg = SEAMTrainConfig(
        lr=args.lr, weight_decay=args.w_decay, milestones=tuple(args.milestones),
        gamma=args.gamma, epochs=args.epochs, n_shops=args.n_shops,
        frames_per_shop=args.frames_per_shop_train, score_thresh=args.score_thresh,
        eval_freq=args.eval_freq, save_epochs=args.save_epochs,
        save_steps=args.save_steps,
        print_freq=args.print_freq, seed=args.seed,
    )

    train_ds = MultiDeepFashion2Dataset(args.train_annots, args.root_train, noise=args.noise)
    test_ds = MultiDeepFashion2Dataset(args.test_annots, args.root_test,
                                       noise=False, filter_onestreet=True)

    model = init_model(cfg, video=True, device=device)
    if args.pretrained_path and os.path.exists(args.pretrained_path):
        load_pretrained_detector(args.pretrained_path, model, clone_match_to_aggregator=True)
    ta = model.roi_heads["temporal_aggregator"]

    # one rank's optimizer steps: the products are sharded over the ranks
    steps_per_epoch = max(len(train_ds) // (tcfg.n_shops * world), 1)
    mesh = make_mesh(data=world, device_type=torch.device(device).type) if world > 1 else None
    schedule = multistep_warmup_schedule(
        tcfg.lr, tcfg.milestones, tcfg.gamma, steps_per_epoch,
        tcfg.warmup_iters, tcfg.warmup_factor,
    )
    optimizer = SGD(ta.parameters(), schedule, tcfg.momentum, tcfg.weight_decay)
    start_ep, resume_skip = resume(args, model, optimizer)
    replicate(model, mesh)

    head_step = make_mdf2_head_step(ta, optimizer, mesh=mesh)
    runner = InferenceRunner(
        model, chunk=tcfg.infer_chunk, with_match=False, with_aggr_features=False,
        with_roi_features=True, ingest="device" if args.device_ingest else "host")
    writer = ScalarWriter(os.path.join(args.log_dir, args.save_tag) if is_main_process()
                          else None)
    ckpts = CheckpointManager(os.path.join(args.save_dir, args.save_tag), tcfg.save_epochs)

    for epoch in range(start_ep, tcfg.epochs):
        skip = resume_skip if epoch == start_ep else 0

        def save_mid(step_in_epoch, epoch=epoch):
            ckpts.save_mid(training_payload(model, optimizer, epoch,
                                            step_in_epoch=step_in_epoch))

        train_one_epoch_multidf2(
            runner, head_step,
            prefetch(product_batches(train_ds, tcfg.n_shops, tcfg.frames_per_shop,
                                     seed=tcfg.seed, epoch=epoch, drop_last=True,
                                     num_shards=world, shard=rank, skip_batches=skip)),
            epoch, tcfg.n_shops, tcfg.frames_per_shop,
            score_thresh=tcfg.score_thresh, print_freq=tcfg.print_freq,
            writer=writer, start_step=skip,
            save_every_steps=tcfg.save_steps,
            save_fn=save_mid if tcfg.save_steps else None,
        )
        ckpts.maybe_save(epoch, training_payload(model, optimizer, epoch))
        if tcfg.eval_freq > 0 and epoch % tcfg.eval_freq == 0:
            res = evaluate(
                model,
                eval_products(test_ds, args.frames_per_shop_test, args.first_n_withvideo),
                EvalConfig(frames_per_product=args.frames_per_shop_test,
                           first_n_withvideo=args.first_n_withvideo,
                           tracking_threshold=0.7),
                save_artifacts=is_main_process(),
            )
            for tag, v in zip(("acc_single", "acc_avgdesc", "acc_aggrdesc"), res):
                writer.add_scalar(tag, v, global_step=epoch)
            print(f"epoch {epoch}: single/avg/aggr = {res}")
    last = tcfg.epochs - 1
    ckpts.maybe_save(last, training_payload(model, optimizer, last), final=True)
    writer.close()


def eval_products(ds: MultiDeepFashion2Dataset, frames: int, first_n):
    for k, items in enumerate(product_batches(ds, 1, frames, shuffle=False)):
        yield {
            "images": [it["image"] for it in items],
            "targets": items,
            "key": items[0]["key"],
            "has_video": k < first_n if first_n is not None else True,
        }


if __name__ == "__main__":
    main()
