"""Gallery indexing on the ViTDet-L backbone: ``index.py``'s entry and
comparison, with the port's own ``MatchRCNN`` built on ``backbone="vitdet_l"``
and the plain ``reference/vitdet.py`` as the reference (in ``check``, in the
precision control and in the operation count alike).

Set-up raises at once, before any weight is drawn, unless the port builds its
ViTDet backbone for this configuration: a program without one would otherwise
drop the configuration's ``backbone`` and ``vit`` keys and index with its
ResNet-50 under this cell's name."""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from .. import model as M
from .. import weights
from ..reference import vitdet as rv
from . import index


def reference_config(cfg: dict, compute_dtype: str = "float32", transform=None):
    """The reference's ``ViTDetModelConfig``: the configuration's sizes in
    ``compute_dtype`` (float32, or ``layers.FP8`` for the control), f32 trunks."""
    mc = M._build(rv.ViTDetModelConfig, cfg["model"])
    mc = dataclasses.replace(mc, compute_dtype=compute_dtype,
                             match=dataclasses.replace(mc.match, trunk_dtype="float32"))
    return mc if transform is None else dataclasses.replace(mc, transform=transform)


def reference_model(cfg: dict, seed: int, device, compute_dtype: str = "float32",
                    transform=None):
    """The ViTDet reference with the seed's weights, drawn as the port's are."""
    rcfg = reference_config(cfg, compute_dtype, transform)
    with torch.device("meta"):
        shell = rv.MatchRCNN(rcfg, cfg["video"])
    return rv.build(rcfg, cfg["video"], weights.make_state(shell, seed, device), device)


@contextlib.contextmanager
def _vitdet_reference():
    """``index.py`` builds its reference through ``model.reference_model``:
    the ViTDet reference in its place while the block runs."""
    saved = M.reference_model
    M.reference_model = reference_model
    try:
        yield
    finally:
        M.reference_model = saved


class Entry(index.Entry):
    def setup(self) -> None:
        # a program without the ViTDet backbone fails here, at once
        from seam_match_rcnn_tpu_torch.models.vit import ViTDetBackbone

        if M.port_config(self.cfg, self.transform).backbone != "vitdet_l":
            raise RuntimeError("the port's ModelConfig does not take backbone 'vitdet_l'")
        super().setup()
        if not isinstance(self.model.backbone, ViTDetBackbone):
            raise RuntimeError(f"the port built {type(self.model.backbone).__name__}, "
                               "not its ViTDet backbone")

    def control_outputs(self):
        with _vitdet_reference():
            return super().control_outputs()

    def check(self, outputs=None):
        with _vitdet_reference():
            return super().check(outputs)

    def flops_per_unit(self):
        with _vitdet_reference():
            return super().flops_per_unit()
