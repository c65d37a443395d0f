"""Readings for the limits of ``correct``: the port's compared numbers on many
seeds, and the precision control's (the reference in scaled float8 put in the
port's place), in one process.  The benchmark's own runs never run this.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault <name>] [--out readings.json]

``--fault`` plants, for the ``--seeds`` readings, a fault in the port
(``half_batch``) or one of the port's own lower-precision paths for its f32
trunks (``tf32``: TF32 switched on; ``bf16_trunk``: ``trunk_dtype`` bfloat16).

For each seed the port is set up as a run sets it up (training's set-up takes
the checked steps) and then drives one cycle of the mix's items at the cell's own
load, so every compared answer comes from the timed path; the reference then
judges them as a run does.  For each control seed the control's outputs are judged the
same way.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import run as R


def half_batch_step(step):
    """``Phase1Trainer.step`` with the fault "half of the batch left out, the
    mean taken over the rest": each bucket keeps its first half of images."""

    def half(self, batches, generator=None, draws=None):
        keep = [max(1, b["images"].shape[0] // 2) for b in batches]
        batches = [{"images": b["images"][:k], "sizes": b["sizes"][:k],
                    "gt": {n: v[:k] for n, v in b["gt"].items()}} for b, k in zip(batches, keep)]
        draws = [{n: v[:k] for n, v in d.items()} for d, k in zip(draws, keep)]
        return step(self, batches, generator, draws)

    return half


def half_batch():
    """Plant ``half_batch_step`` in the port's training step."""
    from seam_match_rcnn_tpu_torch.train.steps import Phase1Trainer

    Phase1Trainer.step = half_batch_step(Phase1Trainer.step)


def tf32():
    """The port with TF32 on: its model turns TF32 off when it is built, so
    turn it on again after that.  The reference turns it off for itself."""
    from seam_match_rcnn_tpu_torch.models.matchrcnn import MatchRCNN

    init = MatchRCNN.__init__

    def with_tf32(self, *args, **kwargs):
        init(self, *args, **kwargs)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True

    MatchRCNN.__init__ = with_tf32


def bf16_trunk():
    """The port's own bf16 path for the match and aggregator trunks."""
    import dataclasses

    from . import model as M

    port_config = M.port_config

    def bf16(cfg, transform=None):
        mc = port_config(cfg, transform)
        return dataclasses.replace(mc, match=dataclasses.replace(mc.match,
                                                                 trunk_dtype="bfloat16"))

    M.port_config = bf16


FAULTS = {"half_batch": half_batch, "tf32": tf32, "bf16_trunk": bf16_trunk}


def readings(cell: dict, seed: int, control: bool, device="cuda") -> dict:
    entry = R.make_entry(cell, seed, device)
    if control:
        entry.setup_inputs()
        out = entry.check(entry.control_outputs())
    else:
        entry.setup()
        for _ in range(entry.cycle):
            entry.item()
        entry.release()
        torch.cuda.synchronize()
        out = entry.check()
    return dict(out, diagnostics=getattr(entry, "diagnostics", {}))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default="")
    p.add_argument("--fault", choices=sorted(FAULTS), default=None,
                   help="plant a fault or a lower-precision path in the port for the --seeds "
                   "readings")
    args = p.parse_args(argv)
    if args.fault:
        FAULTS[args.fault]()
    cell = R.find_cell(R.load_benchmark(), args.workload)
    limits = R.load_limits(cell)
    out = {"workload": args.workload, "fault": args.fault,
           "device": torch.cuda.get_device_name(0),
           "limits": limits, "port": {}, "control": {}}
    for kind, seeds in (("port", args.seeds), ("control", args.control_seeds)):
        for s in [int(x) for x in seeds.split(",") if x]:
            r = readings(cell, s, kind == "control")
            out[kind][str(s)] = r
            print(kind, s, json.dumps(r), file=sys.stderr, flush=True)
    for kind in ("port", "control"):
        for k in limits:
            vals = [r[k] for r in out[kind].values() if k in r]
            if vals:
                print(f"{kind} {k}: min {min(vals)!r} max {max(vals)!r} limit {limits[k]!r}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
