"""The port's own copies of the JAX package's jax-free modules (config,
anchors, tracking, prefetch, the numpy box IoU of ops/rle, the phase-2 host
row selection) agree with their originals: the port may not import them,
so the copies must not drift."""

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
    """The JAX package's fields agree; the port's own (the ViTDet backbone
    and the square canvas, which the JAX package lacks) keep their defaults."""
    mine, theirs = getattr(config, factory)(), getattr(jax_config, factory)()
    ours = dataclasses.asdict(mine)
    if isinstance(mine, config.ModelConfig):
        assert ours.pop("backbone") == "resnet50_fpn"
        assert ours.pop("vit") == dataclasses.asdict(config.ViTConfig())
        assert ours["transform"].pop("square_pad") == 0
    assert ours == dataclasses.asdict(theirs)
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


def test_prefetch_copy_agrees():
    import inspect
    from seam_match_rcnn_tpu.data import prefetch as jax_prefetch
    from seam_match_rcnn_tpu_torch.data import prefetch
    body = lambda m: inspect.getsource(m).split('"""', 2)[2]  # noqa: E731
    assert body(prefetch) == body(jax_prefetch)
    assert list(prefetch.prefetch(iter(range(5)), depth=2)) == list(range(5))


def test_box_iou_xywh_copy_agrees():
    from seam_match_rcnn_tpu.ops.rle import box_iou_xywh as jax_iou
    from seam_match_rcnn_tpu_torch.ops.rle import box_iou_xywh
    rng = np.random.RandomState(0)
    a = np.concatenate([rng.uniform(0, 100, (7, 2)), rng.uniform(0, 60, (7, 2))], 1)
    b = np.concatenate([rng.uniform(0, 100, (5, 2)), rng.uniform(0, 60, (5, 2))], 1)
    b[0] = a[0]
    b[1, 2:] = 0.0  # an empty box
    np.testing.assert_allclose(box_iou_xywh(a, b), jax_iou(a, b), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("name", ["select_rows_host", "SelectedRows"])
def test_phase2_row_selection_copy_agrees(name):
    """train/seam.py's numpy selection is a verbatim copy."""
    import inspect
    from seam_match_rcnn_tpu.train import seam as jax_seam
    from seam_match_rcnn_tpu_torch.train import seam
    assert inspect.getsource(getattr(seam, name)) == inspect.getsource(getattr(jax_seam, name))


def test_phase2_mdf2_row_selection_copy_agrees():
    """train/engine.py's MultiDF2 host selection is a verbatim copy, but for
    the module it imports the numpy box IoU from."""
    import inspect
    from seam_match_rcnn_tpu.train import engine as jax_engine
    from seam_match_rcnn_tpu_torch.train import engine

    def body(fn):
        return [line for line in inspect.getsource(fn).splitlines()
                if line.strip() not in ("from ..ops.rle import box_iou_xywh",
                                        "from ..eval.multidf2 import box_iou_xywh")]
    assert body(engine._best_iou_rows_mdf2) == body(jax_engine._best_iou_rows_mdf2)
