"""AOT export of the PyTorch port's serving forward (torch.export): the
counterpart of tools/export_serving.py.

Writes ``MatchRCNN.inference(with_masks=True, with_match=True,
with_roi_features=False)`` of the video model as one ``torch.export``
program (``.pt2``) and replays it.  The hand-written kernels stay in the
program as the custom ops ``seam::fused_stem``, ``seam::roi_align``,
``seam::roi_align_patch``, ``seam::roi_align_patch_int8`` and
``seam::bn_epilogue`` (K8, after each conv of the backbone), and the NMS
fixed point as a ``while_loop`` node, so a replay on the card launches the
kernels.  Loading a ``.pt2`` that calls ``seam::`` ops needs the port's ops
modules imported first (``load`` here does it); replay it under
``torch.no_grad()``, as it was exported (the parameters require gradients,
and the kernel ops have no backward).

One difference from the JAX artifact: PyTorch's program carries the
parameters and buffers (random weights made from a seed, ~216 MB at full
width), and is called with the images and their sizes alone, while the JAX
artifact takes the variables as an argument.

Usage:
  python tools/export_serving_torch.py --out serving.pt2 [--batch 11]
      [--height 800] [--width 1344] [--device cuda|cpu]
  python tools/export_serving_torch.py --check serving.pt2   # load, list
"""

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402


class ServingForward(torch.nn.Module):
    """The exported function: images [B, 3, H, W] in [0, 1] and image_sizes
    [B, 2] -> inference's dict (boxes, scores, labels, valid, masks,
    match_features)."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, images, image_sizes):
        return self.model.inference(images, image_sizes, with_masks=True, with_match=True,
                                    with_roi_features=False)


def build(batch: int, canvas=(800, 1344), cfg=None, device="cuda"):
    """(module, example inputs) of the serving forward at ``batch`` x
    ``canvas``: the video model of ``cfg`` (``ModelConfig()``, the JAX
    tool's, by default; ``serving_model_config()`` runs the kernels) with
    seeded random weights on ``device``, and zero images with sizes of the
    whole canvas."""
    from seam_match_rcnn_tpu_torch.config import ModelConfig
    from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model

    model = init_model(cfg or ModelConfig(), video=True, device=device)
    images = torch.zeros((batch, 3, canvas[0], canvas[1]), dtype=torch.float32, device=device)
    sizes = torch.tensor([list(canvas)] * batch, dtype=torch.int32, device=device)
    return ServingForward(model), (images, sizes)


def export(module, inputs):
    """``torch.export.export(..., strict=False)`` of ``module`` under
    ``torch.no_grad()``, without its example inputs: ``torch.export.save``
    would write them into the file (the zero images, 142 MB at batch 11)."""
    with torch.no_grad():
        program = torch.export.export(module, inputs, strict=False)
    program.example_inputs = None
    return program


def load(path: str):
    """The exported program in ``path``, after registering the ``seam::`` ops."""
    from seam_match_rcnn_tpu_torch.ops import (cuda_epilogue, cuda_roi_align,  # noqa: F401
                                               cuda_stem)

    return torch.export.load(path)


def seam_ops(program):
    """The ``seam::`` custom ops the program calls, with their counts, over
    its graph and every subgraph (the NMS loop's bodies)."""
    counts = {}
    for mod in program.graph_module.modules():
        if isinstance(mod, torch.fx.GraphModule):
            for node in mod.graph.nodes:
                name = str(node.target)
                if node.op == "call_function" and name.startswith("seam."):
                    counts[name] = counts.get(name, 0) + 1
    return dict(sorted(counts.items()))


def user_inputs(program):
    """(name, shape, dtype, device) of the program's inputs."""
    shapes = {n.name: n.meta.get("val") for n in program.graph.nodes if n.op == "placeholder"}
    return [(name, tuple(shapes[name].shape), shapes[name].dtype, shapes[name].device)
            for name in program.graph_signature.user_inputs]


def main(argv=None):
    ap = argparse.ArgumentParser("AOT export of the PyTorch serving forward")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--check", type=str, default=None)
    ap.add_argument("--batch", type=int, default=11)
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--width", type=int, default=1344)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the model: 'cuda' (the default; raises without a "
                         "card) or 'cpu'")
    args = ap.parse_args(argv)

    if args.check:
        t0 = time.perf_counter()
        program = load(args.check)
        n_state = len(program.state_dict) + len(program.constants)
        print(f"loaded {args.check} in {time.perf_counter() - t0:.1f} s: "
              f"{len(program.graph_signature.user_inputs)} inputs, {n_state} parameters, "
              "buffers and constants")
        for name, shape, dtype, device in user_inputs(program):
            print(f"  input {name}: {list(shape)} {dtype} on {device}")
        print("custom ops:", seam_ops(program) or "none")
        return 0

    from seam_match_rcnn_tpu_torch.cli._args import check_device

    module, inputs = build(args.batch, (args.height, args.width),
                           device=check_device(args.device))
    t0 = time.perf_counter()
    program = export(module, inputs)
    t1 = time.perf_counter()
    out = args.out or "serving.pt2"
    torch.export.save(program, out)
    t2 = time.perf_counter()
    print(f"wrote {out}: {os.path.getsize(out) / 1e6:.1f} MB (export {t1 - t0:.1f} s, "
          f"save {t2 - t1:.1f} s), custom ops {seam_ops(program) or 'none'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
