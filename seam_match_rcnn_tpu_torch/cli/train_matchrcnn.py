"""Phase-1 CLI: supervised Match R-CNN training on DeepFashion2, on PyTorch.

Port of ``seam_match_rcnn_tpu/cli/train_matchrcnn.py``, flag for flag, plus
``--device`` (default ``cuda``; without a card, pass ``--device cpu``).  The
reference's recipe (train_matchrcnn.py:110-133): SGD lr 0.02 momentum 0.9,
MultiStepLR [6, 9], 12 epochs, a checkpoint every 2 epochs, 14 classes.

  python -m seam_match_rcnn_tpu_torch.cli.train_matchrcnn \\
      --root_train data/deepfashion2/train/image \\
      --train_annots data/deepfashion2/train/annots.json --clip_grad_norm 5.0

Checkpoints are torch files (``ckpt/io``): ``<save_dir>/<save_tag>/
epochNNN.pt``, ``final.pt`` and, with ``--save_steps``, the ``mid.pt``
slot.  ``--start_ckpt`` (or ``--auto_resume``) on an epoch file resumes at
the next epoch; on a mid file it resumes inside its epoch, skipping the
batches already trained before any image is loaded, with the samplers'
generator restored.  Each epoch seeds the global ``random``, from which the
horizontal flip draws, with ``seed + epoch``, and the skip consumes the
skipped images' flip draws, so a resumed run replays the uninterrupted
run's flips too (the JAX CLI leaves the flips unseeded).

Multi-process training runs under ``torchrun`` with ``SEAM_MULTIHOST=1``
(``parallel.collectives.initialize_distributed``; ``SEAM_DIST_BACKEND=gloo``
where ranks share a card):

  SEAM_MULTIHOST=1 torchrun --nproc_per_node=8 \
      -m seam_match_rcnn_tpu_torch.cli.train_matchrcnn --batch_size 8 ...

Each rank takes its shard of the pair sampler (``num_shards`` = the ranks,
``shard`` = its rank) and ``--batch_size`` images of it, and
``Phase1Trainer`` steps the global batch over the ``data`` mesh: the
gradients are synchronised, so the ranks train one model (the JAX CLI shards
the data but steps each process alone: F-ref-6 in ROADMAP.md).  Rank r's
sampler generator is seeded with ``seed + r * 2**32`` and its flips with
``seed + epoch + r * 2**32`` (rank 0 draws as one process does); a mid file
holds every rank's generator state.  Rank 0 writes the checkpoints and the
scalars.  The prefetch thread does host work only (PIL decode and mask
crops); every CUDA call stays on the main thread.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random

import torch

from ..ckpt.io import CheckpointManager, generator_state, training_payload
from ..ckpt.torch_convert import import_imagenet_backbone
from ..config import (ModelConfig, RoIHeadsConfig, RPNConfig, TrainConfig, TransformConfig,
                      serving_model_config)
from ..data.df2 import DF2PairBatchSampler, DeepFashion2Dataset
from ..data.prefetch import prefetch
from ..data.transforms import Compose, RandomHorizontalFlip, ToArray
from ..models.matchrcnn import init_model
from ..parallel.collectives import (initialize_distributed, is_main_process, process_count,
                                    process_index)
from ..parallel.mesh import make_mesh, replicate
from ..train.engine import train_one_epoch_matchrcnn
from ..train.optim import multistep_warmup_schedule, sgd
from ..train.steps import Phase1Trainer
from ..utils.logging import ScalarWriter
from ._args import add_device_flag, check_device, resume


def build_argparser():
    p = argparse.ArgumentParser("PyTorch Match R-CNN phase-1 training")
    p.add_argument("--root_train", type=str, default="data/deepfashion2/train/image")
    p.add_argument("--train_annots", type=str, default="data/deepfashion2/train/annots.json")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--clip_grad_norm", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = off, reference "
                        "parity); use ~5.0 when training from scratch "
                        "without --imagenet_backbone")
    p.add_argument("--milestones", type=int, nargs="+", default=[6, 9])
    p.add_argument("--gamma", type=float, default=0.1)
    p.add_argument("--save_epochs", type=int, default=2)
    p.add_argument("--save_steps", type=int, default=0,
                   help="also checkpoint every N optimizer steps into an "
                        "overwriting 'mid' slot (0 = off); --start_ckpt on "
                        "a mid checkpoint resumes inside the epoch")
    p.add_argument("--save_tag", type=str, default="matchrcnn")
    p.add_argument("--save_dir", type=str, default="ckpt")
    p.add_argument("--log_dir", type=str, default="runs")
    p.add_argument("--print_freq", type=int, default=100)
    p.add_argument("--start_ckpt", type=str, default=None)
    p.add_argument("--auto_resume", action="store_true",
                   help="resume from the newest checkpoint under "
                        "save_dir/save_tag (mid-epoch slot included) when "
                        "--start_ckpt is not given; no-op on a fresh run")
    # ImageNet resnet50 state_dict (torch file): the reference's
    # pretrained_backbone=True warm start
    p.add_argument("--imagenet_backbone", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true",
                   help="train one epoch on a generated synthetic "
                        "DeepFashion2 fixture at reduced geometry: a "
                        "dataset-free end-to-end run of the phase-1 "
                        "pipeline (sampler, engine, step, checkpoints)")
    p.add_argument("--train_full_backbone", action="store_true",
                   help="also train the backbone stem conv and layer1, which "
                        "the reference's torchvision backbone freezes "
                        "(trainable_layers=3); their FrozenBatchNorm affines "
                        "stay frozen buffers")
    p.add_argument("--exact_roi_align", action="store_true",
                   help="the plain PyTorch versions of every kernel "
                        "(ModelConfig()) instead of the serving profile's "
                        "CUDA kernels")
    p.add_argument("--roi_backend", type=str, default="pallas_resident",
                   choices=["pallas", "pallas_resident", "xla"],
                   help="training RoIAlign backend: pallas_resident (K2, "
                        "exact), pallas (K6, the window kernel) or xla "
                        "(plain); both kernel backends train through K5")
    p.add_argument("--prefetch_depth", type=int, default=2,
                   help="decode-ahead depth of the threaded batch "
                        "prefetcher (data/prefetch.py): image decode and "
                        "mask-crop rasterization overlap the device step; "
                        "0 disables")
    add_device_flag(p)
    return p


def main(argv=None):
    initialize_distributed()  # no-op unless SEAM_MULTIHOST=1
    args = build_argparser().parse_args(argv)
    device = check_device(args.device)
    rank, world = process_index(), process_count()
    rank_seed = rank << 32
    backend = "xla" if args.exact_roi_align else args.roi_backend
    cfg = (ModelConfig() if args.exact_roi_align else serving_model_config(
        roi_heads=RoIHeadsConfig(roi_align_backend=backend)))
    if not args.train_full_backbone:
        cfg = dataclasses.replace(cfg, freeze_backbone_stages=True)
    else:
        # K1 has no backward: a trained stem runs through the torch ops
        cfg = dataclasses.replace(cfg, stem_backend="xla")
    if args.synthetic:
        import tempfile

        from ..data import convert as conv
        from ..data.synthetic import make_synthetic_df2

        root = tempfile.mkdtemp(prefix="seam_synth_df2_")
        img_dir, ann_dir = make_synthetic_df2(
            root, n_products=2, views_per_side=2, image_size=(120, 150))
        ann = os.path.join(root, "annots.json")
        conv.convert(img_dir, ann_dir, ann)
        args.root_train, args.train_annots = img_dir, ann
        args.batch_size, args.print_freq = 2, 1
        if args.epochs == 12:  # argparse default -> smoke-scale single epoch
            args.epochs = 1
        # the tiny epoch ends its warmup at once (the warmup clamps to
        # steps_per_epoch - 1, as in the reference), and the full 0.02
        # from-scratch lr diverges at batch 2: a smoke-scale lr, unless --lr
        # was given
        if args.lr == 0.02:
            args.lr = 0.002
        if args.save_dir == "ckpt":  # keep an explicitly passed save_dir
            args.save_dir = os.path.join(root, "ckpt")
        print(f"synthetic mode: save_dir={args.save_dir}")
        cfg = dataclasses.replace(
            cfg,
            compute_dtype="float32",
            rpn=RPNConfig(pre_nms_top_n_train=80, post_nms_top_n_train=100,
                          pre_nms_top_n_test=40, post_nms_top_n_test=60,
                          batch_size_per_image=32),
            roi_heads=dataclasses.replace(
                cfg.roi_heads, batch_size_per_image=64, detections_per_img=8),
            transform=TransformConfig(min_size=96, max_size=128),
        )
    tcfg = TrainConfig(
        lr=args.lr, momentum=args.momentum, milestones=tuple(args.milestones),
        gamma=args.gamma, epochs=args.epochs, batch_size=args.batch_size,
        save_epochs=args.save_epochs, save_steps=args.save_steps,
        print_freq=args.print_freq, seed=args.seed,
        clip_grad_norm=args.clip_grad_norm,
    )

    dataset = DeepFashion2Dataset(
        args.train_annots, args.root_train,
        transforms=Compose([ToArray(), RandomHorizontalFlip(0.5)]),
    )
    sampler = DF2PairBatchSampler(dataset, tcfg.batch_size, seed=tcfg.seed,
                                  num_shards=world, shard=rank)
    steps_per_epoch = max(len(sampler), 1)
    mesh = make_mesh(data=world, device_type=torch.device(device).type) if world > 1 else None

    model = init_model(cfg, video=False, device=device)
    if args.train_full_backbone:
        body = model.backbone.body
        for mod in (body.conv1, body.layer1):
            mod.requires_grad_(True)
    if args.imagenet_backbone and os.path.exists(args.imagenet_backbone):
        import_imagenet_backbone(
            model, torch.load(args.imagenet_backbone, map_location="cpu", weights_only=True))
    schedule = multistep_warmup_schedule(
        tcfg.lr, tcfg.milestones, tcfg.gamma, steps_per_epoch,
        tcfg.warmup_iters, tcfg.warmup_factor,
    )
    # the parameters the reference's optimizer sees: those that require a
    # gradient (the stem and layer1 do not, unless --train_full_backbone)
    optimizer = sgd(model, schedule, tcfg.momentum, tcfg.weight_decay, tcfg.clip_grad_norm)
    generator = torch.Generator(device=device).manual_seed(tcfg.seed + rank_seed)
    start_ep, resume_skip = resume(args, model, optimizer, generator)
    replicate(model, mesh)

    trainer = Phase1Trainer(model, optimizer, mesh)
    writer = ScalarWriter(os.path.join(args.log_dir, args.save_tag) if is_main_process()
                          else None)
    ckpts = CheckpointManager(os.path.join(args.save_dir, args.save_tag), tcfg.save_epochs)

    def batches(epoch, skip=0):
        # skip: batches trained before a mid-epoch resume.  The sampler is
        # epoch-seeded and the flips draw from `random` seeded per epoch, so
        # both replay; a skipped batch costs index math and one flip draw
        # an image (RandomHorizontalFlip draws once a call), no image load
        random.seed(tcfg.seed + epoch + rank_seed)
        sampler.set_epoch(epoch)
        for bi, idxs in enumerate(sampler):
            if bi < skip:
                for _ in idxs:
                    random.random()
                continue
            items = [dataset[i] for i in idxs]
            yield [i[0] for i in items], [i[1] for i in items], [i[2] for i in items]

    for epoch in range(start_ep, tcfg.epochs):
        skip = resume_skip if epoch == start_ep else 0

        def save_mid(step_in_epoch, epoch=epoch):
            ckpts.save_mid(training_payload(model, optimizer, epoch,
                                            step_in_epoch=step_in_epoch,
                                            generator=generator_state(generator)))

        data = batches(epoch, skip)
        if args.prefetch_depth > 0:
            data = prefetch(data, depth=args.prefetch_depth)
        try:
            train_one_epoch_matchrcnn(
                model, trainer, data, epoch, generator,
                print_freq=tcfg.print_freq, writer=writer,
                steps_per_epoch=steps_per_epoch, start_step=skip,
                save_every_steps=tcfg.save_steps,
                save_fn=save_mid if tcfg.save_steps else None,
            )
        finally:
            if args.prefetch_depth > 0:
                data.close()
        ckpts.maybe_save(epoch, training_payload(model, optimizer, epoch))
    last = tcfg.epochs - 1
    ckpts.maybe_save(last, training_payload(model, optimizer, last), final=True)
    writer.close()


if __name__ == "__main__":
    main()
