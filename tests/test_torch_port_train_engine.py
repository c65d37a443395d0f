"""The port's phase-1 epoch loop on the CPU: mixed-orientation batches
through the whole serving profile (fused stem and tile-resident RoIAlign,
their plain versions here), the non-finite-loss guard, and the GT boxes
scaled with their image (F-ref-2: the JAX engine leaves them unscaled)."""

import json
import types

import numpy as np
import pytest
import torch

import jax

from seam_match_rcnn_tpu.config import TransformConfig as JaxTransformConfig
from seam_match_rcnn_tpu.train.engine import train_one_epoch_matchrcnn as jax_epoch

from seam_match_rcnn_tpu_torch.config import (ModelConfig, RoIHeadsConfig, RPNConfig,
                                              TransformConfig)
from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model
from seam_match_rcnn_tpu_torch.train.engine import (NonFiniteLossError,
                                                    train_one_epoch_matchrcnn)
from seam_match_rcnn_tpu_torch.train.optim import multistep_warmup_schedule, sgd
from seam_match_rcnn_tpu_torch.train.steps import Phase1Trainer
from seam_match_rcnn_tpu_torch.utils.logging import ScalarWriter

torch.set_num_threads(2)
TRANSFORM = dict(min_size=48, max_size=64)
# a landscape and a portrait image -> two canvas buckets; their resize
# ratios differ per axis (40x60 -> 42x64, 60x40 -> 64x42)
SIZES = [(40, 60), (60, 40)]


def _target(rng, h, w, source, g=2):
    x1, y1 = rng.uniform(0, w / 2, g), rng.uniform(0, h / 2, g)
    bw, bh = rng.uniform(8, w / 2, g), rng.uniform(8, h / 2, g)
    return {"boxes": np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32),
            "labels": rng.randint(1, 14, g), "pair_ids": np.asarray([1, 2][:g]),
            "styles": np.asarray([1, 1][:g]), "sources": np.full(g, source),
            "mask_crops": (rng.rand(g, 56, 56) > 0.5).astype(np.uint8)}


def _data(seed, n_batches=2):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n_batches):
        images = [rng.rand(h, w, 3).astype(np.float32) for h, w in SIZES]
        targets = [_target(rng, h, w, source=j) for j, (h, w) in enumerate(SIZES)]
        out.append((images, targets, [2 * i, 2 * i + 1]))
    return out


def _model():
    cfg = ModelConfig(
        rpn=RPNConfig(pre_nms_top_n_train=80, post_nms_top_n_train=80,
                      batch_size_per_image=32),
        roi_heads=RoIHeadsConfig(batch_size_per_image=32, detections_per_img=8,
                                 roi_align_backend="pallas_resident"),
        transform=TransformConfig(**TRANSFORM), compute_dtype="float32",
        stem_backend="pallas", freeze_backbone_stages=True)
    return init_model(cfg, device="cpu", seed=1)


def test_epoch_of_mixed_orientation_batches_is_finite(tmp_path):
    model = _model()
    opt = sgd(model, multistep_warmup_schedule(0.02, (6, 9), 0.1, 1000, 1000, 1e-3))
    writer = ScalarWriter(str(tmp_path))
    before = model.backbone.body.conv1.weight.clone()
    last = train_one_epoch_matchrcnn(model, Phase1Trainer(model, opt), _data(0), epoch=0,
                                     generator=torch.Generator().manual_seed(0), print_freq=1,
                                     writer=writer)
    writer.close()
    assert opt.count == 2  # one update per batch, two buckets each
    assert set(last) >= {"loss_objectness", "loss_mask", "loss_match", "loss"}
    assert all(np.isfinite(v) for v in last.values())
    assert torch.equal(model.backbone.body.conv1.weight, before)  # the fused stem is frozen
    rows = [json.loads(line) for line in (tmp_path / "scalars.jsonl").read_text().splitlines()]
    assert {r["step"] for r in rows} == {1, 2} and all(np.isfinite(r["value"]) for r in rows)


class _Recorder:
    """A trainer that records its batches and returns ``loss``."""

    def __init__(self, loss=0.0):
        self.batches, self.loss = [], loss
        self.optimizer = types.SimpleNamespace(count=0)

    def step(self, batches, generator=None):
        self.batches.append(batches)
        return {"loss_mask": torch.tensor(0.5), "loss": torch.tensor(self.loss)}


def _stub_model():
    stub = torch.nn.Linear(1, 1)
    stub.cfg = ModelConfig(transform=TransformConfig(**TRANSFORM))
    return stub


def test_non_finite_loss_raises():
    with pytest.raises(NonFiniteLossError, match="Loss is nan at epoch 3 step 0 ids"):
        train_one_epoch_matchrcnn(_stub_model(), _Recorder(float("nan")), _data(1, 1),
                                  epoch=3, generator=torch.Generator())


def test_gt_boxes_are_scaled_with_their_image():
    """F-ref-2: each image's padded GT boxes are its original boxes times
    its own (x, y) resize ratio, as torchvision's GeneralizedRCNNTransform
    does; the JAX engine pads the original boxes."""
    data = _data(2, 1)
    images, targets, _ = data[0]
    rec = _Recorder()
    train_one_epoch_matchrcnn(_stub_model(), rec, data, epoch=0, generator=torch.Generator(),
                              g_max=4)
    jax_boxes = []

    def jax_step(state, batch, rng):
        jax_boxes.append(np.asarray(batch["gt"]["boxes"]))
        return state, {"loss": 0.0}

    jax_epoch(types.SimpleNamespace(cfg=types.SimpleNamespace(
        transform=JaxTransformConfig(**TRANSFORM))), None, jax_step, data, epoch=0,
        rng=jax.random.PRNGKey(0), g_max=4)
    (buckets,) = rec.batches
    assert len(buckets) == len(jax_boxes) == 2
    for bucket, jb, (h, w), t in zip(buckets, jax_boxes, SIZES, targets):
        (nh, nw), = bucket["sizes"].tolist()
        assert (nh, nw) != (h, w) and nh / h != nw / w
        want = t["boxes"] * np.asarray([nw / w, nh / h, nw / w, nh / h], np.float32)
        got = bucket["gt"]["boxes"][0].numpy()
        np.testing.assert_allclose(got[:2], want, rtol=1e-6)
        assert not bucket["gt"]["valid"][0, 2:].any()
        np.testing.assert_array_equal(jb[0, :2], t["boxes"])  # the JAX engine's
        assert not np.allclose(jb[0, :2], got[:2])
