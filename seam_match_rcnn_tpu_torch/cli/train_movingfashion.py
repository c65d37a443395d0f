"""Phase-2 CLI: SEAM training on MovingFashion, on PyTorch.

Port of ``seam_match_rcnn_tpu/cli/train_movingfashion.py``, flag for flag,
plus ``--device`` (default ``cuda``; without a card, pass ``--device
cpu``).  The reference's recipe (train_movingfashion.py:158-189): SGD lr
0.04 weight decay 5e-4, MultiStepLR [15, 25] gamma 0.1, 31 epochs, batches of
(1 + frames_per_shop) x n_shops images, the phase-1 warm start with the match
predictor cloned into the temporal aggregator, and an evaluation every
``--eval_freq`` epochs that keeps the best single, avg and aggr top-1.

  python -m seam_match_rcnn_tpu_torch.cli.train_movingfashion \\
      --root data/MovingFashion --pretrained_path ckpt/matchrcnn/final.pt

The frozen detector runs through one ``InferenceRunner`` for the whole run:
the heads are trained in place, so it sees the current ones (the JAX CLI
rebuilds its runner every epoch for that).  A checkpoint holds the whole
video model, the heads' optimizer and the epoch (``ckpt/io``); a mid file
adds ``step_in_epoch``, and a resume skips the trained batches through
``product_batches(skip_batches=...)`` without decoding them.

Under ``torchrun`` with ``SEAM_MULTIHOST=1`` (as ``cli.train_matchrcnn``)
each rank takes its shard of the products (``product_batches(num_shards,
shard)``), ``steps_per_epoch`` counts one rank's batches (the JAX CLI's
rule, train_movingfashion.py:127-129), and the head step trains over the
rows that every rank selected (``train.seam``'s mesh step); rank 0 writes
the checkpoints and the scalars.  Every rank runs the in-loop evaluation,
as in the JAX CLI; rank 0 writes its artifacts.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..ckpt.io import CheckpointManager, training_payload
from ..ckpt.torch_convert import load_pretrained_detector
from ..config import EvalConfig, ModelConfig, SEAMTrainConfig, serving_model_config
from ..data.movingfashion import MovingFashionDataset, product_batches
from ..data.prefetch import prefetch
from ..eval.movingfashion import evaluate
from ..eval.runner import InferenceRunner
from ..models.matchrcnn import init_model
from ..parallel.collectives import (initialize_distributed, is_main_process, process_count,
                                    process_index)
from ..parallel.mesh import make_mesh, replicate
from ..train.engine import train_one_epoch_movingfashion
from ..train.optim import SGD, multistep_warmup_schedule
from ..train.seam import make_seam_head_step
from ..utils.logging import ScalarWriter
from ._args import add_device_flag, check_device, resume, strtobool


def build_argparser():
    p = argparse.ArgumentParser("PyTorch SEAM Match R-CNN phase-2 training")
    p.add_argument("--root", type=str, default="data/MovingFashion")
    p.add_argument("--train_annots", type=str, default="data/MovingFashion/train.json")
    p.add_argument("--test_annots", type=str, default="data/MovingFashion/test.json")
    p.add_argument("--n_shops", type=int, default=16)
    p.add_argument("--frames_per_shop_train", type=int, default=10)
    p.add_argument("--frames_per_shop_test", type=int, default=10)
    p.add_argument("--epochs", type=int, default=31)
    p.add_argument("--lr", type=float, default=0.04)
    p.add_argument("--w_decay", type=float, default=5e-4)
    p.add_argument("--milestones", type=int, nargs="+", default=[15, 25])
    p.add_argument("--gamma", type=float, default=0.1)
    # the reference passes 0.1 into the epoch loop (train_movingfashion.py:119)
    p.add_argument("--score_thresh", type=float, default=0.1)
    p.add_argument("--eval_freq", type=int, default=4)
    p.add_argument("--save_epochs", type=int, default=2)
    p.add_argument("--save_steps", type=int, default=0,
                   help="also checkpoint every N product batches into an "
                        "overwriting 'mid' slot (0 = off); --start_ckpt on "
                        "a mid checkpoint resumes inside the epoch")
    p.add_argument("--save_tag", type=str, default="seam_mf")
    p.add_argument("--save_dir", type=str, default="ckpt")
    p.add_argument("--log_dir", type=str, default="runs")
    p.add_argument("--print_freq", type=int, default=20)
    p.add_argument("--first_n_withvideo", type=int, default=100)
    p.add_argument("--noise", type=strtobool, default=True)
    # phase-1 checkpoint: a torch file (the reference's released one, or
    # cli.train_matchrcnn's final.pt)
    p.add_argument("--pretrained_path", type=str, default="ckpt/df2matchrcnn")
    p.add_argument("--start_ckpt", type=str, default=None)
    p.add_argument("--auto_resume", action="store_true",
                   help="resume from the newest checkpoint under "
                        "save_dir/save_tag (mid-epoch slot included) when "
                        "--start_ckpt is not given; no-op on a fresh run")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true",
                   help="train one epoch on a generated synthetic "
                        "MovingFashion dataset (real mp4 decode): a "
                        "dataset-free end-to-end run of the SEAM loop")
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

        from ..data.synthetic import make_synthetic_movingfashion

        root = tempfile.mkdtemp(prefix="seam_synth_mf_")
        annots = make_synthetic_movingfashion(root, n_products=3)
        args.root = root
        args.train_annots = annots
        args.test_annots = annots
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

    train_ds = MovingFashionDataset(args.train_annots, root=args.root, noise=args.noise)
    test_ds = MovingFashionDataset(args.test_annots, root=args.root, noise=args.noise)

    model = init_model(cfg, video=True, device=device)
    if args.pretrained_path and os.path.exists(args.pretrained_path):
        # the reference's load_saved_matchrcnn (train_movingfashion.py:85-89)
        load_pretrained_detector(args.pretrained_path, model, clone_match_to_aggregator=True)
    heads = model.roi_heads
    mp, ta = heads["match_predictor"], heads["temporal_aggregator"]

    # one rank's optimizer steps: the products are sharded over the ranks
    steps_per_epoch = max(len(train_ds) // (tcfg.n_shops * world), 1)
    mesh = make_mesh(data=world, device_type=torch.device(device).type) if world > 1 else None
    schedule = multistep_warmup_schedule(
        tcfg.lr, tcfg.milestones, tcfg.gamma, steps_per_epoch,
        tcfg.warmup_iters, tcfg.warmup_factor,
    )
    optimizer = SGD([p for h in (mp, ta) for p in h.parameters()], schedule,
                    tcfg.momentum, tcfg.weight_decay)
    start_ep, resume_skip = resume(args, model, optimizer)
    replicate(model, mesh)

    head_step = make_seam_head_step(mp, ta, optimizer, frames_per_product=tcfg.frames_per_shop,
                                    n_frames=cfg.match.n_frames, mesh=mesh)
    runner = InferenceRunner(
        model, chunk=tcfg.infer_chunk, with_match=False, with_aggr_features=False,
        with_roi_features=True, ingest="device" if args.device_ingest else "host")
    writer = ScalarWriter(os.path.join(args.log_dir, args.save_tag) if is_main_process()
                          else None)
    ckpts = CheckpointManager(os.path.join(args.save_dir, args.save_tag), tcfg.save_epochs)
    best = [0.0, 0.0, 0.0]

    for epoch in range(start_ep, tcfg.epochs):
        skip = resume_skip if epoch == start_ep else 0

        def save_mid(step_in_epoch, epoch=epoch):
            ckpts.save_mid(training_payload(model, optimizer, epoch,
                                            step_in_epoch=step_in_epoch))

        train_one_epoch_movingfashion(
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
                _eval_products(test_ds, args.frames_per_shop_test, args.first_n_withvideo),
                EvalConfig(frames_per_product=args.frames_per_shop_test,
                           first_n_withvideo=args.first_n_withvideo),
                save_artifacts=is_main_process(),
            )
            best = [max(b, r) for b, r in zip(best, res)]
            for tag, v in zip(("acc_single", "acc_avgdesc", "acc_aggrdesc"), res):
                writer.add_scalar(tag, v, global_step=epoch)
            print(f"epoch {epoch}: single/avg/aggr = {res}; best = {best}")
    last = tcfg.epochs - 1
    ckpts.maybe_save(last, training_payload(model, optimizer, last), final=True)
    writer.close()


def _eval_products(ds: MovingFashionDataset, frames: int, first_n: int):
    for k, items in enumerate(product_batches(ds, 1, frames, shuffle=False,
                                              uniform_sampling=False)):
        shop, frames_items = items[0], items[1:]
        yield {
            "images": [shop["image"]] + [f["image"] for f in frames_items],
            "tracklet_gt": [f["tracklet"] for f in frames_items],
            "source": shop["source"],
            "key": shop["key"],
            "has_video": k < first_n if first_n is not None else True,
        }


if __name__ == "__main__":
    main()
