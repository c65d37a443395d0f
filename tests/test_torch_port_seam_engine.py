"""The port's phase-2 epoch loops against the JAX package's, step by step,
on the CPU: one stub runner hands both sides the same detections and RoI
features (in each side's layout), so no detector runs.  Checked: each
step's losses (rtol 1e-4 at the first step, 1e-3 after it), the skipped
batch, the ``save_fn`` calls and the final heads
(``torch_port_seam_common.assert_heads_close``).  Also the
MultiDF2 row selection's remap after an exclusion, and
``InferenceRunner.run``'s device outputs in input order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seam_match_rcnn_tpu.train import engine as jax_engine
from seam_match_rcnn_tpu.train import seam as jax_seam

from seam_match_rcnn_tpu_torch.config import ModelConfig, RoIHeadsConfig, RPNConfig
from seam_match_rcnn_tpu_torch.eval.runner import InferenceRunner
from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model
from seam_match_rcnn_tpu_torch.models.transform import batch_images
from seam_match_rcnn_tpu_torch.train import engine, seam
from torch_port_canvas import Canvas64x96
from torch_port_seam_common import (assert_heads_close, head_tree, jax_tx, make_heads,
                                    port_sgd, roi_features)

torch.set_num_threads(2)

P, T, D = 3, 3, 3


class StubRunner:
    """Hands out recorded (outputs, RoI features [N, D, 256, 14, 14]) per
    call, in order; ``jax=True`` gives the features in the JAX layout."""

    def __init__(self, recorded, jax=False):
        self.recorded, self.jax, self.calls = list(recorded), jax, 0

    def run(self, images, device_keys=None):
        outs, roi = self.recorded[self.calls]
        self.calls += 1
        assert len(images) == len(outs) and tuple(device_keys) == ("roi_features",)
        if self.jax:
            return outs, {"roi_features": jnp.asarray(roi.transpose(0, 1, 3, 4, 2))}
        return outs, {"roi_features": torch.from_numpy(roi)}


def _image_outputs(rng, score_lo=0.2):
    boxes = rng.uniform(0, 60, (D, 2))
    boxes = np.concatenate([boxes, boxes + rng.uniform(10, 60, (D, 2))], 1).astype(np.float32)
    return {"scores": rng.uniform(score_lo, 1.0, D).astype(np.float32), "boxes": boxes,
            "valid": rng.rand(D) > 0.1}


def product_batches(seed, mdf2=False):
    """Four product batches of P products x (1 shop + T frames), product ids
    drawn from 0..9, with their recorded runner outputs.  Batch 1's shops
    have no detection (no step); in batch 2 one product's frames come
    before its shop.  MultiDF2 items carry their GT key and box."""
    rng = np.random.RandomState(seed)
    data, recorded = [], []
    for b in range(4):
        ids = rng.choice(10, P, replace=False)
        items, outs = [], []
        for p in ids:
            order = [1] + [0] * T if not (b == 2 and p == ids[1]) else [0] * T + [1]
            for tag in order:
                item = {"image": np.zeros((2, 2, 3), np.float32), "tag": tag, "i": int(p)}
                o = _image_outputs(rng)
                if b == 1 and tag == 1:
                    o["scores"][:] = 0.0
                if mdf2:
                    item.update(key=f"1_{p}", styles=np.asarray([2, 1]),
                                pair_ids=np.asarray([p, p]),
                                boxes=np.stack([o["boxes"][0] + 5, o["boxes"][1] + 1]))
                items.append(item)
                outs.append(o)
        data.append(items)
        recorded.append((outs, roi_features(rng, len(outs), D)))
    return data, recorded


def _recording(fn, log):
    def step(*args):
        out = fn(*args)
        losses = out[-1] if isinstance(out, tuple) else out
        log.append({k: float(v) for k, v in losses.items()})
        return out
    step.optimizer = getattr(fn, "optimizer", None)
    return step


@pytest.mark.parametrize("kind", ["movingfashion", "multidf2"])
def test_epoch_loops_match_jax(kind):
    """Four batches from step 1 of the epoch, a save every 2 batches."""
    mdf2 = kind == "multidf2"
    data, recorded = product_batches(11 if mdf2 else 10, mdf2)
    mp, ta = make_heads(5, nlb_backend="pallas")
    variables = head_tree(mp, ta)
    state = jax_seam.create_head_state(variables, jax_tx())
    if mdf2:
        jax_step = jax_seam.make_mdf2_head_step(jax_tx())
        port_step = seam.make_mdf2_head_step(ta, port_sgd(ta.parameters()))
    else:
        jax_step = jax_seam.make_seam_head_step(jax_tx(), frames_per_product=T)
        port_step = seam.make_seam_head_step(mp, ta, port_sgd(list(mp.parameters())
                                                              + list(ta.parameters())), T)
    jax_loop = getattr(jax_engine, f"train_one_epoch_{kind}")
    port_loop = getattr(engine, f"train_one_epoch_{kind}")
    kw = dict(n_products=P, frames_per_product=T, score_thresh=0.5, max_rows=16,
              start_step=1, save_every_steps=2)
    want_losses, got_losses, want_saves, got_saves = [], [], [], []
    state = jax_loop(None, variables, state, _recording(jax_step, want_losses),
                     StubRunner(recorded, jax=True), data, epoch=1,
                     save_fn=lambda hs, count: want_saves.append(count), **kw)
    port_loop(StubRunner(recorded), _recording(port_step, got_losses), data, epoch=1,
              save_fn=got_saves.append, **kw)
    assert len(got_losses) == len(want_losses) == 3  # batch 1 takes no step
    assert got_saves == want_saves == [1, 3]
    for i, (g, w) in enumerate(zip(got_losses, want_losses)):
        assert g.keys() == w.keys()
        for k in w:
            # the first step starts from equal heads; each later one inherits
            # the earlier updates' f32 differences (torch_port_seam_common.LR)
            assert g[k] == pytest.approx(w[k], rel=1e-4 if i == 0 else 1e-3), (i, k)
    assert all(g["loss"] > 0 for g in got_losses)
    # the running statistics sum the three steps' batch statistics, the later
    # two from drifted heads: 1e-3, 1e-4 (a single step's are held to 1e-4,
    # 1e-5 in tests/test_torch_port_seam_step.py)
    assert_heads_close(mp, ta, variables["params"], state.params, state.batch_stats,
                       stats_tol=(1e-3, 1e-4))
    assert port_step.optimizer.count == 3


def test_best_iou_rows_mdf2_reindexes_after_exclusion():
    """tests/test_engine_units.py's case: product 0's street row comes
    before its shop, which has no detection; product 1's rows must move to
    the front and be remapped.  The port's selection equals the JAX one."""
    def out(scores, boxes):
        scores = np.asarray(scores, np.float32)
        return {"scores": scores, "boxes": np.asarray(boxes, np.float32),
                "valid": np.ones_like(scores, bool)}

    def item(tag):
        return {"tag": tag, "key": "0_1", "styles": np.asarray([0]),
                "pair_ids": np.asarray([1]), "boxes": np.asarray([[5, 5, 30, 30]], np.float32)}

    det = [[4, 4, 31, 31], [50, 50, 70, 70]]
    outs = [out([0.9, 0.2], det), out([0.1, 0.1], det),
            out([0.2, 0.8], [[50, 50, 70, 70], [6, 6, 29, 29]]), out([0.7, 0.1], det)]
    items, prods = [item(0), item(1), item(1), item(0)], [0, 0, 1, 1]
    args = (outs, items, prods, 0.5, 2, 2, 8)
    got, want = engine._best_iou_rows_mdf2(*args), jax_engine._best_iou_rows_mdf2(*args)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["shop_row"].tolist() == [-1, 0] and got["seq_mask"][1].tolist() == [True, False]
    assert got["row_img"][got["seq_gather"][1, 0]] == 3


def test_best_iou_rows_mdf2_stops_at_max_rows():
    data, recorded = product_batches(12, mdf2=True)
    items = data[0]
    prods = engine._mf_batch_to_images(items)[2]
    for max_rows in (3, 5, 16):
        args = (recorded[0][0], items, prods, 0.0, P, T, max_rows)
        got, want = engine._best_iou_rows_mdf2(*args), jax_engine._best_iou_rows_mdf2(*args)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_runner_run_keeps_features_on_the_device_in_input_order():
    """Two orientations in one call (two canvas buckets, chunks of 2), in
    f32: the features come back in input order, equal to the model's own
    forward of each image alone, and the host outputs to ``__call__``'s."""
    cfg = ModelConfig(transform=Canvas64x96(min_size=64, max_size=96),
                      rpn=RPNConfig(pre_nms_top_n_test=60, post_nms_top_n_test=80),
                      roi_heads=RoIHeadsConfig(detections_per_img=10), compute_dtype="float32")
    model = init_model(cfg, video=True, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    sizes = [(60, 80), (80, 60), (64, 96), (90, 70), (50, 75)]
    images = [rng.rand(h, w, 3).astype(np.float32) for h, w in sizes]
    runner = InferenceRunner(model, chunk=2, with_match=False, with_aggr_features=False,
                             with_roi_features=True)
    outs, dev = runner.run(images)
    roi = dev["roi_features"]
    d = cfg.roi_heads.detections_per_img
    assert tuple(roi.shape) == (5, d, 256, 14, 14) and set(outs[0]) == {
        "boxes", "scores", "labels", "valid"}
    assert [len(b.indices) for b in runner.batches(images)] == [3, 2]
    for i, img in enumerate(images):
        (b,) = batch_images([img], cfg.transform, torch.device("cpu"))
        alone = model.inference(b.pixels, torch.as_tensor(b.sizes), with_match=False)
        # 1e-4: oneDNN sums a batch's f32 convs in another order than one
        # image's (3.4e-5 at most here); another image's features differ by ~1
        np.testing.assert_allclose(roi[i].numpy(), alone["roi_features"][0].numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(outs[i]["scores"], alone["scores"][0].numpy(), rtol=1e-4,
                                   atol=1e-5)
    host = InferenceRunner(model, chunk=2)(images)
    for o, h in zip(outs, host):
        assert set(h) == {"boxes", "scores", "labels", "valid", "match_features",
                          "aggr_features"}
        np.testing.assert_array_equal(o["boxes"], h["boxes"])
    with pytest.raises(ValueError, match="device key"):
        InferenceRunner(model, chunk=2).run(images[:1], device_keys=("roi_features",))
