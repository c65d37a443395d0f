"""The port's own copies of the JAX package's jax-free modules (config,
anchors, tracking) agree with their originals: the port may not import
them, so the copies must not drift."""

import dataclasses

import numpy as np
import pytest

from seam_match_rcnn_tpu import config as jax_config
from seam_match_rcnn_tpu.eval.tracking import build_tracklets as jax_tracklets
from seam_match_rcnn_tpu.models.anchors import grid_anchors as jax_grid_anchors

from seam_match_rcnn_tpu_torch import config
from seam_match_rcnn_tpu_torch.eval.tracking import build_tracklets
from seam_match_rcnn_tpu_torch.models.anchors import grid_anchors


@pytest.mark.parametrize("factory", ["ModelConfig", "serving_model_config",
                                     "fast_eval_model_config", "TrainConfig", "EvalConfig",
                                     "SEAMTrainConfig", "MeshConfig"])
def test_config_copies_agree(factory):
    mine, theirs = getattr(config, factory)(), getattr(jax_config, factory)()
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert type(mine).__name__ == type(theirs).__name__


@pytest.mark.parametrize("canvas", [(800, 1344), (1344, 800), (64, 96)])
def test_anchor_copies_agree(canvas):
    h, w = canvas
    shapes = [(h // s, w // s) for s in (4, 8, 16, 32)]
    shapes.append(((shapes[-1][0] - 1) // 2 + 1, (shapes[-1][1] - 1) // 2 + 1))
    sizes, ratios = (32.0, 64.0, 128.0, 256.0, 512.0), (0.5, 1.0, 2.0)
    for a, b in zip(grid_anchors(canvas, tuple(shapes), sizes, ratios),
                    jax_grid_anchors(canvas, tuple(shapes), sizes, ratios)):
        np.testing.assert_array_equal(a, b)


def test_tracking_copies_agree():
    import inspect
    from seam_match_rcnn_tpu.eval import tracking as jax_tracking
    from seam_match_rcnn_tpu_torch.eval import tracking
    # the code is the same; only the module docstring says whose copy it is
    body = lambda m: inspect.getsource(m).split('"""', 2)[2]  # noqa: E731
    assert body(tracking) == body(jax_tracking)
    assert build_tracklets.__name__ == jax_tracklets.__name__
