"""The phase-1 ablation paths of the port against the JAX package, on the CPU:
the stage losses (``MatchRCNN.profile_losses``), the gradient-accumulation
triple (``train/steps.make_phase1_grad_apply``) and the engine's three step
forms, ``inference(gt=)`` with ``models/detection.prepend_gt``, the
``"xla"`` RoIAlign adjoint, and the config refusals of
``roi_adjoint_backend`` and ``remat_backbone``.

The JAX sides run the exact ("xla") RoIAlign with the f32 stem on tiny
canvases: one compile for every stage at once, one ``grad_fn`` compile a
canvas of the mixed batch.  Tolerances: stage losses rtol 1e-4; the
triple's update by ``assert_state_close`` and its losses by
``assert_losses_close`` (``tests/torch_port_train_common.py``);
``prepend_gt`` exact; the ``"xla"`` adjoint's gradient equal to the plain
adjoint's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seam_match_rcnn_tpu.models.detection import Detections as JaxDetections
from seam_match_rcnn_tpu.models.detection import prepend_gt as jax_prepend_gt
from seam_match_rcnn_tpu.models.matchrcnn import MatchRCNN as JaxMatchRCNN
from seam_match_rcnn_tpu.models.matchrcnn import init_model as jax_init
from seam_match_rcnn_tpu.train.optim import backbone_frozen_mask
from seam_match_rcnn_tpu.train.optim import sgd as jax_sgd
from seam_match_rcnn_tpu.train.steps import create_train_state, make_phase1_grad_apply as jax_gaa

from seam_match_rcnn_tpu_torch.ckpt.from_jax import load_jax_variables
from seam_match_rcnn_tpu_torch.config import ModelConfig, RoIHeadsConfig, TransformConfig
from seam_match_rcnn_tpu_torch.models.detection import Detections, prepend_gt
from seam_match_rcnn_tpu_torch.models.matchrcnn import MatchRCNN, init_model
from seam_match_rcnn_tpu_torch.ops import cuda_roi_align
from seam_match_rcnn_tpu_torch.ops.roi_align import multilevel_roi_align_adjoint
from seam_match_rcnn_tpu_torch.train.engine import train_one_epoch_matchrcnn
from seam_match_rcnn_tpu_torch.train.optim import sgd
from seam_match_rcnn_tpu_torch.train.steps import Phase1Trainer, make_phase1_grad_apply

from test_train_step import make_batch
from torch_port_canvas import small_canvas
from torch_port_train_common import (LOSS_KEYS, assert_losses_close, assert_state_close,
                                     jax_draws, randomize_biases, serving_train_cfg,
                                     to_port_batch)

torch.set_num_threads(2)
LR = 0.01
STAGES = ("backbone", "rpn", "sample", "boxbranch", "mask", "full")


def xla_cfg(**kw):
    """``serving_train_cfg`` on the exact RoIAlign (cheap to compile in JAX)."""
    cfg = serving_train_cfg()
    return dataclasses.replace(cfg, roi_heads=dataclasses.replace(
        cfg.roi_heads, roi_align_backend="xla"), **kw)


@pytest.fixture(scope="module")
def jax_setup():
    cfg = xla_cfg()
    jmodel, variables = jax_init(cfg, video=False, canvas=(64, 64))
    return cfg, jmodel, randomize_biases(variables)


@pytest.fixture(scope="module")
def jax_stages(jax_setup):
    """Every stage's loss of the JAX ``profile_losses`` in one compile."""
    cfg, jmodel, variables = jax_setup
    batch = make_batch(2, g=3, hw=(64, 64), seed=3)
    rng = jax.random.PRNGKey(11)

    def stages(params, stats, batch, rng):
        v = {"params": params, "batch_stats": stats}
        return {s: jmodel.apply(v, batch["images"], batch["sizes"], batch["gt"], rng, s,
                                method=JaxMatchRCNN.profile_losses, mutable=["batch_stats"])[0]
                for s in STAGES}

    out = jax.jit(stages)(variables["params"], variables["batch_stats"], batch, rng)
    return batch, jax_draws(rng, cfg, batch), {k: float(v) for k, v in out.items()}


@pytest.mark.parametrize("stage", STAGES)
def test_stage_losses_match_jax(jax_setup, jax_stages, stage):
    cfg, _, variables = jax_setup
    batch, draws, want = jax_stages
    port = load_jax_variables(init_model(cfg, device="cpu"), variables)
    got = float(port.profile_losses([to_port_batch(batch)], stage, draws=[draws]).detach())
    assert got == pytest.approx(want[stage], rel=1e-4), (stage, got, want[stage])
    if stage == "full":
        losses = port.training_losses([to_port_batch(batch)], draws=[draws])
        assert got == float(sum(losses.values()).detach())


def test_profile_losses_refuses_an_unknown_stage():
    model = init_model(xla_cfg(), device="cpu")
    batch = to_port_batch(make_batch(1, g=2, hw=(64, 64), seed=1))
    with pytest.raises(ValueError, match="unknown profile stage"):
        model.profile_losses([batch], "heads")


def test_grad_apply_mixed_batch_matches_jax(jax_setup):
    """Two buckets (a landscape and a portrait canvas, a street and a shop
    image each) at weight 1/2: the JAX engine's triple step, the BatchNorm
    statistics chained from the first bucket to the second, against the
    port's with the same draws a bucket."""
    cfg, jmodel, variables = jax_setup
    tx = jax_sgd(lambda s: LR, momentum=0.9, trainable_mask=backbone_frozen_mask)
    buckets = [make_batch(2, g=3, hw=(64, 96), seed=3), make_batch(2, g=3, hw=(96, 64), seed=4)]
    rngs = [jax.random.PRNGKey(5), jax.random.PRNGKey(6)]
    grad_fn, accum_fn, apply_fn = jax_gaa(jmodel, tx)
    state0 = create_train_state(variables, tx)
    acc, stats, want = None, None, {}
    for batch, rng in zip(buckets, rngs):
        cur = state0._replace(batch_stats=stats) if stats is not None else state0
        grads, losses, stats = grad_fn(cur, batch, rng, jnp.float32(0.5))
        acc = grads if acc is None else accum_fn(acc, grads)
        for k, v in losses.items():
            want[k] = want.get(k, 0.0) + 0.5 * float(v)
    state = apply_fn(state0, acc, stats)

    port = load_jax_variables(init_model(cfg, device="cpu"), variables)
    optimizer = sgd(port, lambda s: LR, momentum=0.9)
    p_grad, p_accum, p_apply = make_phase1_grad_apply(port, optimizer)
    acc, got = None, {}
    for batch, rng in zip(buckets, rngs):
        grads, losses = p_grad(to_port_batch(batch), 0.5, draws=jax_draws(rng, cfg, batch))
        acc = grads if acc is None else p_accum(acc, grads)
        for k, v in losses.items():
            got[k] = got.get(k, 0.0) + 0.5 * float(v)
    p_apply(acc)
    assert optimizer.count == 1 and set(got) == set(LOSS_KEYS)
    assert_losses_close(got, want)
    worst = assert_state_close(port, variables["params"], state.params, state.batch_stats)
    print(f"worst parameter update error / its size: {worst:.3e}")


def _mixed_epoch(cfg):
    """One batch of a landscape and a portrait image (street and shop, one
    garment pair) for the engine, on 32x64 / 64x32 canvases."""
    rng = np.random.RandomState(0)

    def target(source):
        return {"boxes": np.asarray([[2, 2, 14, 16], [4, 3, 18, 17]], np.float32),
                "labels": np.asarray([1, 2]), "pair_ids": np.asarray([1, 2]),
                "styles": np.asarray([1, 1]), "sources": np.asarray([source, source]),
                "mask_crops": (rng.rand(2, 28, 28) > 0.5).astype(np.uint8)}

    images = [rng.rand(20, 30, 3).astype(np.float32), rng.rand(30, 20, 3).astype(np.float32)]
    return [(images, [target(0), target(1)], [0, 1])]


@pytest.mark.parametrize("form", ["trainer", "triple", "per_bucket"])
def test_engine_takes_the_three_step_forms(form):
    """``train_one_epoch_matchrcnn`` on a mixed batch: ``Phase1Trainer`` and
    the triple make one update, the per-bucket callable one a bucket; the
    triple's losses are the buckets' summed by their weights (1/2 each)."""
    cfg = xla_cfg(transform=small_canvas(TransformConfig, (32, 64))(min_size=32, max_size=64))
    model = init_model(cfg, device="cpu")
    optimizer = sgd(model, lambda s: LR, momentum=0.9)
    if form == "trainer":
        step = Phase1Trainer(model, optimizer)
    elif form == "triple":
        step = make_phase1_grad_apply(model, optimizer)
        grad_fn = step[0]
        seen = []
        step = (lambda batch, w, gen: seen.append(w) or grad_fn(batch, w, gen),) + step[1:]
    else:
        trainer = Phase1Trainer(model, optimizer)
        step = lambda batch, gen: trainer.step([batch], gen)  # noqa: E731
    before = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    lf = train_one_epoch_matchrcnn(model, step, _mixed_epoch(cfg), epoch=0,
                                   generator=torch.Generator().manual_seed(0), g_max=4)
    assert optimizer.count == (2 if form == "per_bucket" else 1)
    assert set(lf) == set(LOSS_KEYS) and all(np.isfinite(v) for v in lf.values())
    assert any(not torch.equal(p, before[n]) for n, p in model.named_parameters()
               if p.requires_grad)
    if form == "triple":
        assert seen == [0.5, 0.5]


def test_grad_apply_refuses_a_mesh():
    model = init_model(xla_cfg(), device="cpu")
    with pytest.raises(ValueError, match="takes no mesh"):
        make_phase1_grad_apply(model, sgd(model, lambda s: LR), mesh=object())


def test_prepend_gt_matches_jax():
    rng = np.random.RandomState(2)
    b, d, g = 2, 5, 3
    det = dict(boxes=rng.rand(b, d, 4).astype(np.float32) * 50,
               scores=rng.rand(b, d).astype(np.float32), labels=rng.randint(0, 14, (b, d)),
               valid=rng.rand(b, d) > 0.3)
    gt = dict(boxes=rng.rand(b, g, 4).astype(np.float32) * 50, labels=rng.randint(1, 14, (b, g)),
              valid=np.asarray([[True, True, False], [True, False, False]]))
    want = jax_prepend_gt(JaxDetections(**{k: jnp.asarray(v) for k, v in det.items()}),
                          *(jnp.asarray(gt[k]) for k in ("boxes", "labels", "valid")))
    got = prepend_gt(Detections(**{k: torch.from_numpy(np.asarray(v)) for k, v in det.items()}),
                     *(torch.from_numpy(gt[k]) for k in ("boxes", "labels", "valid")))
    for k in ("boxes", "scores", "labels", "valid"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))
    assert got.scores.dtype == torch.float32 and got.valid.dtype == torch.bool


def test_inference_with_gt_prepends_and_leaves_the_detections():
    """The video model's ``inference(gt=)``: the first G rows are the GT
    boxes (score 1 where valid, 0 where not) and their RoI features, masks
    and descriptors are those of the boxes themselves; the other D rows
    equal ``inference`` without ``gt`` (the masks and descriptors, which
    convolutions compute over all G + D rows, within rtol 1e-5)."""
    model = init_model(xla_cfg(), video=True, device="cpu")
    batch = to_port_batch(make_batch(2, g=3, hw=(64, 64), seed=7))
    gt = {k: batch["gt"][k] for k in ("boxes", "labels", "valid")}
    plain = model.inference(batch["images"], batch["sizes"], with_masks=True)
    out = model.inference(batch["images"], batch["sizes"], with_masks=True, gt=gt)
    g = gt["boxes"].shape[1]
    for k, v in plain.items():
        assert out[k].shape[1] == v.shape[1] + g, k
        if k in ("masks", "match_features"):  # convolutions over more rows may sum apart
            torch.testing.assert_close(out[k][:, g:], v, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(out[k][:, g:], v), k
    assert torch.equal(out["boxes"][:, :g], gt["boxes"])
    assert torch.equal(out["scores"][:, :g], gt["valid"].float())
    assert torch.equal(out["valid"][:, :g], gt["valid"])
    # the GT rows' RoI features are the boxes' own (same rows, another batch of rois)
    alone = model.inference(batch["images"], batch["sizes"], with_masks=True,
                            gt={k: v[:, :1] for k, v in gt.items()})
    assert torch.equal(alone["roi_features"][:, 0], out["roi_features"][:, 0])
    assert torch.equal(alone["match_features"][:, 0], out["match_features"][:, 0])


def _levels(rng, shapes=((16, 24), (8, 12), (4, 6), (2, 3)), c=8):
    return [torch.from_numpy(rng.randn(2, c, h, w).astype(np.float32))
            .contiguous(memory_format=torch.channels_last).requires_grad_(True)
            for h, w in shapes]


@pytest.mark.parametrize("wrapper", ["roi_align", "roi_align_patch"])
def test_xla_adjoint_gives_the_plain_adjoint_gradient(wrapper, monkeypatch):
    """``adjoint="xla"`` backpropagates through the scatter-add adjoint and
    never calls K5's wrapper; its gradient equals the plain adjoint's
    exactly, and the default ("pallas") calls K5's wrapper."""
    rng = np.random.RandomState(5)
    rois = torch.tensor([[[2.0, 3.0, 60.0, 40.0], [0.0, 0.0, 95.0, 63.0], [10, 10, 30, 50]],
                         [[5.0, 5.0, 19.0, 17.0], [-4.0, 10.0, 40.0, 60.0], [1, 1, 90, 60]]])
    g = torch.from_numpy(rng.randn(6, 8, 7, 7).astype(np.float32))
    calls = []
    adjoint = cuda_roi_align.roi_align_adjoint
    monkeypatch.setattr(cuda_roi_align, "roi_align_adjoint",
                        lambda *a, **kw: calls.append(1) or adjoint(*a, **kw))
    fn = getattr(cuda_roi_align, wrapper)
    grads = {}
    for backend in ("xla", "pallas"):
        feats = _levels(np.random.RandomState(6))
        out = fn(feats, rois, 7, 2, adjoint=backend)
        grads[backend] = torch.autograd.grad(out, feats, g)
        assert len(calls) == (0 if backend == "xla" else 1)
    want = multilevel_roi_align_adjoint(g.permute(0, 2, 3, 1).reshape(2, 3, 7, 7, 8), rois,
                                        [(16, 24), (8, 12), (4, 6), (2, 3)])
    for got, w in zip(grads["xla"], want):
        assert torch.equal(got, w.permute(0, 3, 1, 2))
    for a, b in zip(grads["xla"], grads["pallas"]):  # on the CPU both are the plain adjoint
        assert torch.equal(a, b)


def test_xla_adjoint_config_reaches_the_backward(monkeypatch):
    """``RoIHeadsConfig.roi_adjoint_backend`` selects the model's RoIAlign
    backward: the default ("pallas") goes through K5's wrapper (its plain
    version on the CPU), "xla" never calls it, and both give the same
    gradients on the CPU."""
    calls = []
    adjoint = cuda_roi_align.roi_align_adjoint
    monkeypatch.setattr(cuda_roi_align, "roi_align_adjoint",
                        lambda *a, **kw: calls.append(1) or adjoint(*a, **kw))
    batch = to_port_batch(make_batch(1, g=3, hw=(64, 64), seed=3))
    grads, n_calls = [], []
    for backend in ("pallas", "xla"):
        cfg = serving_train_cfg()
        cfg = dataclasses.replace(cfg, roi_heads=dataclasses.replace(
            cfg.roi_heads, roi_adjoint_backend=backend))
        model = init_model(cfg, device="cpu")
        params = [p for p in model.parameters() if p.requires_grad]
        total = sum(model.training_losses([batch], torch.Generator().manual_seed(0)).values())
        grads.append(torch.autograd.grad(total, params, allow_unused=True))
        n_calls.append(len(calls))
        calls.clear()
    assert n_calls == [2, 0]  # the box and the mask branch's RoIAlign
    for a, b in zip(*grads):
        assert (a is None and b is None) or torch.equal(a, b)


def test_unknown_roi_adjoint_backend_raises():
    cfg = ModelConfig(roi_heads=RoIHeadsConfig(roi_adjoint_backend="scatter"))
    with pytest.raises(ValueError, match="roi_adjoint_backend"):
        MatchRCNN(cfg)
    with pytest.raises(ValueError, match="roi_adjoint_backend"):
        cuda_roi_align.roi_align(_levels(np.random.RandomState(0)),
                                 torch.tensor([[[0.0, 0, 8, 8]]] * 2), 2, adjoint="scatter")


def test_remat_backbone_must_be_a_bool():
    with pytest.raises(ValueError, match="remat_backbone"):
        MatchRCNN(ModelConfig(remat_backbone="blocks"))
