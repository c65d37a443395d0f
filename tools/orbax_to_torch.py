"""Convert an Orbax checkpoint of the JAX package's CLIs to the PyTorch
port's torch file.

    JAX_PLATFORMS=cpu python tools/orbax_to_torch.py \\
        --orbax ckpt/matchrcnn/final --out ckpt/matchrcnn_final.pt

The JAX package's training CLIs save Orbax directories
(``seam_match_rcnn_tpu/ckpt/io.py``): phase 1 as ``{"state": TrainState,
"epoch"}``, phase 2 as ``{"variables", "head_state", "epoch"}``.  This tool
runs under JAX: it restores the directory with the JAX package's
``restore_checkpoint``, maps its ``{"params", "batch_stats"}`` into the
port's model with ``seam_match_rcnn_tpu_torch/ckpt/from_jax.
load_jax_variables`` (the video model when the tree has a temporal
aggregator, else the phase-1 model; every leaf used once), and writes
``{"model_state_dict", "epoch"}`` with the port's ``ckpt/io.save_checkpoint``.
The file serves as a warm start (``--pretrained_path``), an eval checkpoint
(``--ckpt_path``) or a ``SeamRetrieval.from_checkpoint`` file; it carries no
optimizer state, so it does not resume a training run.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def variables_of(payload: Dict[str, Any]) -> Dict[str, Any]:
    """The ``{"params", "batch_stats"}`` tree of a restored payload of either
    CLI phase."""
    tree = payload["variables"] if "variables" in payload else payload.get("state", payload)
    return {"params": tree["params"], "batch_stats": tree.get("batch_stats", {})}


def convert(orbax_dir: str, out: str) -> str:
    from seam_match_rcnn_tpu.ckpt.io import restore_checkpoint

    from seam_match_rcnn_tpu_torch.ckpt.from_jax import load_jax_variables
    from seam_match_rcnn_tpu_torch.ckpt.io import save_checkpoint
    from seam_match_rcnn_tpu_torch.config import ModelConfig
    from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model

    payload = restore_checkpoint(orbax_dir)
    variables = variables_of(payload)
    video = "temporal_aggregator" in variables["params"]
    # the state dict's keys and shapes are the same under every profile
    model = load_jax_variables(init_model(ModelConfig(), video=video, device="cpu"), variables)
    return save_checkpoint(out, {"model_state_dict": model.state_dict(),
                                 "epoch": int(payload.get("epoch", 0))})


def main(argv=None):
    p = argparse.ArgumentParser("Orbax checkpoint of the JAX CLIs -> the port's torch file")
    p.add_argument("--orbax", required=True, help="Orbax checkpoint directory")
    p.add_argument("--out", required=True, help="torch file to write")
    args = p.parse_args(argv)
    path = convert(args.orbax, args.out)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
