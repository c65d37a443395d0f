"""Small shapes for the CPU tests: the cells' configurations and mixes with an
orientation canvas of 64x96, few proposals and detections, and a handful of
small images.  At these sizes a whole run takes seconds on the CPU."""

from __future__ import annotations

import copy
import dataclasses

from portbench import generate
from portbench import model as M


def small_canvas(base, landscape):
    h, w = landscape
    return dataclasses.dataclass(frozen=True)(type(f"{base.__name__}{h}x{w}", (base,), {
        "landscape_canvas": property(lambda self: (h, w)),
        "portrait_canvas": property(lambda self: (w, h))}))


def transform():
    from seam_match_rcnn_tpu_torch.config import TransformConfig

    return small_canvas(TransformConfig, (64, 96))(min_size=64, max_size=96)


def config(name: str, compute_dtype: str = None) -> dict:
    c = copy.deepcopy(M.load_config(name))
    c["model"]["rpn"].update(pre_nms_top_n_test=60, post_nms_top_n_test=120,
                             pre_nms_top_n_train=60, post_nms_top_n_train=120,
                             batch_size_per_image=32)
    c["model"]["roi_heads"].update(detections_per_img=6, batch_size_per_image=32)
    if compute_dtype:
        # the CPU version of K1 rounds its output to bf16; the plain stem keeps
        # a float32 port equal to the reference to rounding
        c["model"].update(compute_dtype=compute_dtype, stem_backend="xla")
    return c


def mix(name: str) -> dict:
    m = generate.load_mix(name)
    if m["entry"] == "index":
        return dict(m, calls=2, products_per_call=2, frames_per_product=2, frame_hw=[48, 80],
                    shop_side=[40, 90], check_images=3, trace_items=1)
    return dict(m, batches=4, side=[40, 100], trace_items=1)  # the cell's batch of 8


CELLS = {"seam_serving.index_mf": ("seam_serving", "index_mf"),
         "matchrcnn_train.phase1_b8": ("matchrcnn_train", "phase1_b8")}


def entry(cell: str, seed: int, compute_dtype: str = None):
    """The cell's entry at the small shapes, on the CPU."""
    import importlib

    cfg, mx = CELLS[cell]
    m = mix(mx)
    mod = importlib.import_module(f"portbench.entries.{m['entry']}")
    return mod.Entry(config(cfg, compute_dtype), m, seed, "cpu", transform())
