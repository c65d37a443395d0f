"""Transform configs with small orientation canvases for the port's CPU
tests: both packages place every image on an 800x1344 (or 1344x800) canvas,
which makes a CPU forward of a few small images cost as much as one of
full-size ones.  A frozen subclass that overrides only the two canvas
properties keeps the resize, the buckets and the padding rules."""

import dataclasses

from seam_match_rcnn_tpu.config import TransformConfig as JaxTransformConfig

from seam_match_rcnn_tpu_torch.config import TransformConfig


def small_canvas(base, landscape):
    """A frozen subclass of the TransformConfig ``base`` whose landscape
    canvas is ``landscape`` (h, w) and whose portrait canvas is (w, h)."""
    h, w = landscape
    return dataclasses.dataclass(frozen=True)(type(f"{base.__name__}{h}x{w}", (base,), {
        "landscape_canvas": property(lambda self: (h, w)),
        "portrait_canvas": property(lambda self: (w, h))}))


JaxCanvas96x128 = small_canvas(JaxTransformConfig, (96, 128))
Canvas96x128 = small_canvas(TransformConfig, (96, 128))
Canvas64x96 = small_canvas(TransformConfig, (64, 96))
