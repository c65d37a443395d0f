"""Shared helpers of the port's CLIs: ``strtobool`` (a copy of
``seam_match_rcnn_tpu/cli/_args.py``), the ``--device`` flag and its check,
and the training CLIs' resume."""


def strtobool(v) -> bool:
    """Boolean flag VALUE parser.

    The reference CLIs use ``type=bool`` (e.g. train_movingfashion.py:171),
    under which ``--noise False`` parses as True: a reference bug, not
    copied.  Any of 0/false/no/off (case-insensitive) disables; the defaults
    are unchanged.
    """
    s = str(v).strip().lower()
    if s in ("1", "true", "yes", "on", "y", "t"):
        return True
    if s in ("0", "false", "no", "off", "n", "f", ""):
        return False
    raise ValueError(f"expected a boolean, got {v!r}")


def add_device_flag(p) -> None:
    """``--device``: the port's CLIs run on the card unless asked for the
    CPU."""
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the model: 'cuda' (the default; raises "
                        "without a card) or 'cpu'")


def check_device(device: str) -> str:
    """``device``, or a RuntimeError for a CUDA device where there is none:
    a CLI never moves to the CPU on its own."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device (torch.cuda.is_available() is "
                           "False); pass --device cpu to run on the CPU")
    return device


def resume(args, model, optimizer, generator=None):
    """``--start_ckpt`` / ``--auto_resume`` of the training CLIs: restore the
    model, the optimizer (its momentum and step count) and, from a mid-epoch
    file, ``generator``'s state, in place.  Returns (the epoch to start at,
    the batches of it to skip): an epoch file resumes at ``epoch + 1``, a
    mid file inside its epoch after ``step_in_epoch + 1`` batches."""
    from ..ckpt.io import (resolve_auto_resume, restore_training_checkpoint,
                           restore_training_state)

    if args.auto_resume and not args.start_ckpt:
        args.start_ckpt = resolve_auto_resume(args.save_dir, args.save_tag)
        if args.start_ckpt:
            print(f"auto-resume from {args.start_ckpt}")
    if not args.start_ckpt:
        return 0, 0
    payload, is_mid = restore_training_checkpoint(args.start_ckpt)
    # an epoch file restarts the generator from the seed, as the JAX CLI's rng
    restore_training_state(payload, model, optimizer, generator if is_mid else None)
    if not is_mid:
        return int(payload.get("epoch", 0)) + 1, 0
    start_ep, skip = int(payload["epoch"]), int(payload["step_in_epoch"]) + 1
    print(f"mid-epoch resume: epoch {start_ep}, skipping {skip} batches")
    return start_ep, skip
