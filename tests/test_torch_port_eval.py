"""The retrieval evaluation harnesses, port vs JAX, on identical runner outputs.

Both packages' ``eval/movingfashion.evaluate`` (all 7 strategies, regular
and hard splits, both gallery dtypes) and ``eval/multidf2.evaluate`` take
the same per-image detector outputs through ``runner=``: seeded numpy
outputs in the runner's format (boxes in image coordinates, scores, valid,
match and aggregator descriptors), with each product's garment near its
prototype descriptor in the shop image and in most frames, and clutter
around it.  The models share weights through the bridge; the harnesses use
only their scorers' last layers and the aggregator (NLB + attention pooling).
Metric files, per-product accuracies, CSVs and returned top-1 values must be
equal.  Also: the port's runner forms the same forward batches as the JAX
package's device ingest under "pallas_int8" (the int8 pyramid's scales span
a batch) and its orientation canvases under the other backends, and the
cv2 host ingest (``EvalConfig()``'s) runs both harnesses.

Then MovingFashion end to end under the int8 RoIAlign: the port's
``evaluate`` through the port's ``InferenceRunner`` against the JAX
package's through its own, on shared weights: the serving profile with
``roi_align_backend="pallas_int8"`` (K7 over a pyramid quantized once per
forward, the backend that differs most from what the other tests hold), f32
compute, device ingest, the RPN caps of tests/test_torch_port_slice.py and
96x128 canvases.  Two products of one shop image and two frames, all of one
geometry, so each forward batch (and the int8 scales) spans a product's
three images on both sides.  The JAX kernels run in interpret mode, the
port's wrappers take their plain versions.
"""

import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from seam_match_rcnn_tpu.ckpt.torch_convert import convert_state_dict
from seam_match_rcnn_tpu.config import EvalConfig as JaxEvalConfig
from seam_match_rcnn_tpu.config import ModelConfig as JaxModelConfig
from seam_match_rcnn_tpu.config import RoIHeadsConfig as JaxRoIHeadsConfig
from seam_match_rcnn_tpu.config import RPNConfig as JaxRPNConfig
from seam_match_rcnn_tpu.config import serving_model_config as jax_serving_config
from seam_match_rcnn_tpu.eval import movingfashion as jax_mf
from seam_match_rcnn_tpu.eval import multidf2 as jax_mdf2
from seam_match_rcnn_tpu.eval.runner import InferenceRunner as JaxRunner
from seam_match_rcnn_tpu.models.matchrcnn import make_model
from seam_match_rcnn_tpu.models.transform import batch_images as jax_host_batches
from seam_match_rcnn_tpu.models.transform import device_batch_images as jax_batches

from seam_match_rcnn_tpu_torch.config import (EvalConfig, ModelConfig, RoIHeadsConfig, RPNConfig,
                                              TransformConfig, serving_model_config)
from seam_match_rcnn_tpu_torch.eval import movingfashion, multidf2
from seam_match_rcnn_tpu_torch.eval.runner import InferenceRunner
from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model
from seam_match_rcnn_tpu_torch.models.transform import device_batch_images
from seam_match_rcnn_tpu_torch.ops import cuda_roi_align
from torch_port_canvas import Canvas96x128, JaxCanvas96x128

torch.set_num_threads(2)

D, T, N_PRODUCTS = 6, 4, 7


@pytest.fixture(scope="module")
def models():
    """The port's video model (seeded, non-zero W_z) and the same weights as
    JAX variables."""
    port = init_model(ModelConfig(), video=True, seed=3, device="cpu")
    nlb = port.roi_heads["temporal_aggregator"].newnlb
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in (nlb.W.weight, nlb.W.bias):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
        # scorers that prefer near descriptors (sigmoid of -0.02 |x - y|^2 + c),
        # so that the metrics see both hits and misses
        for name in ("match_predictor", "temporal_aggregator"):
            last = port.roi_heads[name].last
            last.weight.copy_(torch.tensor([[0.01], [-0.01]])
                              + 0.002 * torch.randn(last.weight.shape, generator=gen))
            last.bias.copy_(torch.tensor([-3.0, 3.0]) + torch.randn(2, generator=gen))
    variables = convert_state_dict({k: v.detach().numpy() for k, v in port.state_dict().items()},
                                   video=True)
    return port, make_model(JaxModelConfig(), video=True), variables


def _detections(rng, proto, present, box):
    """One image's runner output: D detections, the first the garment (when
    present) near its prototype descriptors and its box, the rest clutter."""
    feats = rng.randn(D, 2, 256).astype(np.float32)
    boxes = np.stack([rng.uniform(0, 300, D), rng.uniform(0, 200, D),
                      rng.uniform(320, 640, D), rng.uniform(220, 480, D)], -1)
    if present:
        feats[0] = proto + 0.3 * rng.randn(2, 256)
        boxes[0] = box + rng.uniform(-6, 6, 4)
    valid = rng.rand(D) > 0.15
    valid[0] = True
    return {"boxes": boxes.astype(np.float32), "scores": rng.uniform(0.05, 1, D).astype(np.float32),
            "labels": rng.randint(1, 14, D), "valid": valid,
            "match_features": feats[:, 0].copy(), "aggr_features": feats[:, 1].copy()}


@pytest.fixture(scope="module")
def recorded():
    """Products (images are keys into the recorded outputs) and the outputs."""
    rng = np.random.RandomState(0)
    protos = rng.randn(N_PRODUCTS, 2, 256).astype(np.float32)
    outputs, products = {}, []
    for p in range(N_PRODUCTS):
        box = np.asarray([60 + 20 * p, 40, 360 + 10 * p, 420], np.float32)
        names = [f"p{p}_{i}" for i in range(T + 1)]
        outputs[names[0]] = _detections(rng, protos[p], True, box)
        gt = np.tile(box, (T, 1))
        for i, name in enumerate(names[1:]):
            outputs[name] = _detections(rng, protos[p], rng.rand() > 0.2, box)
            if i == 1:
                gt[i] = -1  # an unannotated frame
        targets = [{"boxes": box[None], "styles": np.asarray([1 + p % 2]),
                    "pair_ids": np.asarray([p])} for _ in names]
        products.append({"images": names, "tracklet_gt": gt, "source": 1 if p % 3 else 0,
                         "key": f"{1 + p % 2}_{p}", "has_video": p != 4, "targets": targets})
    return products, outputs


def _read_artifacts(out_dir: Path):
    csvs = list(out_dir.glob("*.csv"))
    assert len(csvs) == 1
    got = {"csv": csvs[0].read_text(), "metrics": json.loads((out_dir / "metrics.json").read_text())}
    npz = out_dir / "accs_per_product.npz"
    if npz.exists():
        with np.load(npz, allow_pickle=True) as z:
            got["accs"] = {k: [None if a is None else np.asarray(a).tolist() for a in z[k]]
                           for k in z.files}
    return got


@pytest.mark.parametrize("harness,gallery_dtype", [("movingfashion", "f32"),
                                                   ("movingfashion", "fp16"),
                                                   ("multidf2", "f32"), ("multidf2", "fp16")])
def test_harness_matches_jax_on_identical_outputs(models, recorded, tmp_path, harness,
                                                  gallery_dtype):
    port, jmodel, variables = models
    products, outputs = recorded
    runner = lambda images: [outputs[name] for name in images]  # noqa: E731
    if harness == "movingfashion":
        kw = dict(score_threshold=0.0, tracking_threshold=0.3, gallery_dtype=gallery_dtype,
                  ingest="device")
        want = jax_mf.evaluate(jmodel, variables, products, JaxEvalConfig(**kw), runner=runner,
                               out_dir=str(tmp_path / "jax"))
        got = movingfashion.evaluate(port, products, EvalConfig(**kw), runner=runner,
                                     out_dir=str(tmp_path / "port"))
    else:
        kw = dict(score_threshold=0.0, tracking_threshold=0.7, gallery_dtype=gallery_dtype,
                  ingest="device")
        want = jax_mdf2.evaluate(jmodel, variables, products, JaxEvalConfig(**kw),
                                 runner=runner, out_dir=str(tmp_path / "jax"))
        got = multidf2.evaluate(port, products, EvalConfig(**kw), runner=runner,
                                out_dir=str(tmp_path / "port"))
    assert got == want
    a, b = _read_artifacts(tmp_path / "port"), _read_artifacts(tmp_path / "jax")
    assert a == b
    # the fixture exercises the metrics: neither all hits nor all misses
    top1 = [v["1"] for v in a["metrics"]["all"].values()]
    assert 0 < max(top1) and min(top1) < 1
    if harness == "movingfashion":
        assert set(a["metrics"]) == {"all", "regular", "hard", "rank_median",
                                     "avg_track_length"}
        assert len(a["accs"]) == N_PRODUCTS - 1  # the gallery-only product has no queries


def test_runner_batches_as_the_jax_device_ingest():
    """One forward batch per source geometry, in order of first appearance,
    with the same valid and original sizes: the chunks over which the int8
    pyramid is quantized are the JAX runner's."""
    rng = np.random.RandomState(1)
    sizes = [(120, 160), (160, 120), (120, 160), (96, 200), (160, 120), (120, 160)]
    images = [rng.rand(h, w, 3).astype(np.float32) for h, w in sizes]
    cfg = TransformConfig(min_size=96, max_size=128)
    want = jax_batches(images, cfg)
    got = device_batch_images(images, cfg, torch.device("cpu"))
    assert [g.indices for g in got] == [list(w.indices) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.sizes, w.sizes)
        np.testing.assert_array_equal(g.orig_sizes, w.orig_sizes)
        np.testing.assert_allclose(g.pixels.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w.pixels), rtol=0, atol=1e-5)


@pytest.mark.parametrize("backend", ["pallas_resident", "pallas", "pallas_int8"])
def test_runner_batches_follow_the_backend(backend):
    """Under "pallas_int8", whose scales span a forward batch, the runner
    forms the JAX device ingest's batches, one per source geometry; under
    the backends whose outputs are per image, the two orientation canvases
    (the JAX host ingest's buckets), which fill more of each chunk."""
    rng = np.random.RandomState(2)
    sizes = [(120, 160), (160, 120), (96, 200), (120, 160), (100, 140), (160, 120)]
    images = [rng.rand(h, w, 3).astype(np.float32) for h, w in sizes]
    cfg = serving_model_config(roi_heads=RoIHeadsConfig(roi_align_backend=backend),
                               transform=Canvas96x128(min_size=96, max_size=128))
    model = types.SimpleNamespace(cfg=cfg, parameters=lambda: iter([torch.zeros(1)]))
    got = [b.indices for b in InferenceRunner(model).batches(images)]
    jcfg = JaxCanvas96x128(min_size=96, max_size=128)
    by_geometry = backend == "pallas_int8"
    want = (jax_batches if by_geometry else jax_host_batches)(images, jcfg)
    assert got == [list(w.indices) for w in want]
    assert len(got) == (4 if by_geometry else 2)


def test_host_ingest_runs_as_the_jax_default(tmp_path):
    """``InferenceRunner(ingest="host")`` (cv2 on the host, the JAX
    package's buckets) and both harnesses under ``EvalConfig()``, whose
    ingest is "host", run: a small-canvas model on the CPU, boxes in each
    image's original coordinates.  An unknown ingest raises."""
    cfg = ModelConfig(rpn=RPNConfig(pre_nms_top_n_test=60, post_nms_top_n_test=80),
                      roi_heads=RoIHeadsConfig(detections_per_img=6), compute_dtype="float32",
                      transform=Canvas96x128(min_size=96, max_size=128))
    port = init_model(cfg, video=True, seed=5, device="cpu")
    rng = np.random.RandomState(8)
    images = [_image(rng, 120, 160), _image(rng, 150, 110), _image(rng, 96, 128)]
    runner = InferenceRunner(port, chunk=4, ingest="host")
    assert [b.indices for b in runner.batches(images)] == [
        list(b.indices) for b in jax_host_batches(images, JaxCanvas96x128(min_size=96,
                                                                           max_size=128))]
    for img, o in zip(images, runner(images)):
        assert o["boxes"].shape == (6, 4) and o["match_features"].shape == (6, 256)
        assert np.isfinite(o["aggr_features"]).all()
        b = o["boxes"][o["valid"]]
        assert len(b) and (b[:, 2] <= img.shape[1] + 1e-3).all() \
            and (b[:, 3] <= img.shape[0] + 1e-3).all()

    assert EvalConfig().ingest == "host"
    mf = [{"images": [_image(rng, 120, 160) for _ in range(3)],
           "tracklet_gt": np.tile([[10.0, 10.0, 100.0, 90.0]], (2, 1)),
           "source": 1 - i, "key": f"product{i}"} for i in range(2)]
    top1 = movingfashion.evaluate(port, mf, EvalConfig(), out_dir=str(tmp_path / "mf"))
    assert len(top1) == 3 and all(np.isfinite(top1))
    box = np.asarray([10.0, 10.0, 100.0, 90.0], np.float32)
    mdf2 = [{"images": [_image(rng, 120, 160) for _ in range(2)],
             "targets": [{"boxes": box[None], "styles": np.asarray([1]),
                          "pair_ids": np.asarray([i])} for _ in range(2)],
             "key": f"1_{i}", "has_video": True} for i in range(2)]
    top1 = multidf2.evaluate(port, mdf2, EvalConfig(), out_dir=str(tmp_path / "mdf2"))
    assert len(top1) == 3 and all(np.isfinite(top1))
    with pytest.raises(ValueError):
        InferenceRunner(port, ingest="cv2")


class _Recording:
    """A runner that keeps what it returned."""

    def __init__(self, runner):
        self.runner, self.device, self.outputs = runner, getattr(runner, "device", None), []

    def __call__(self, images):
        out = self.runner(images)
        self.outputs.extend(out)
        return out


def _image(rng, h, w):
    img = rng.uniform(0.0, 0.25, (h, w, 3)).astype(np.float32)
    bh, bw = h // 2, w // 2
    y, x = rng.randint(0, h - bh), rng.randint(0, w - bw)
    img[y:y + bh, x:x + bw] = rng.uniform(0.3, 1.0, 3)
    return img


def test_movingfashion_int8_end_to_end_matches_jax(tmp_path):
    kw = lambda rpn, rh: dict(  # noqa: E731
        rpn=rpn(pre_nms_top_n_test=60, post_nms_top_n_test=80),
        roi_heads=rh(detections_per_img=6, roi_align_backend="pallas_int8"),
        compute_dtype="float32")
    cfg = serving_model_config(**kw(RPNConfig, RoIHeadsConfig),
                               transform=Canvas96x128(min_size=96, max_size=128))
    jcfg = jax_serving_config(**kw(JaxRPNConfig, JaxRoIHeadsConfig),
                              transform=JaxCanvas96x128(min_size=96, max_size=128))
    port = init_model(cfg, video=True, seed=5, device="cpu")
    gen = torch.Generator().manual_seed(6)
    nlb = port.roi_heads["temporal_aggregator"].newnlb
    with torch.no_grad():  # a non-zero W_z, so the NLB is not an identity
        for p in (nlb.W.weight, nlb.W.bias):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    variables = convert_state_dict({k: v.detach().numpy() for k, v in port.state_dict().items()},
                                   video=True)
    rng = np.random.RandomState(7)
    products = [{"images": [_image(rng, 120, 160) for _ in range(3)],
                 "tracklet_gt": np.tile([[10.0, 10.0, 100.0, 90.0]], (2, 1)),
                 "source": 1 - i, "key": f"product{i}"} for i in range(2)]
    ecfg = dict(score_threshold=0.0, infer_chunk=3, ingest="device")

    jrun = _Recording(JaxRunner(make_model(jcfg, video=True), variables, chunk=3,
                                ingest="device"))
    want = jax_mf.evaluate(jrun.runner.model, variables, products, JaxEvalConfig(**ecfg),
                           runner=jrun, out_dir=str(tmp_path / "jax"))
    run = _Recording(InferenceRunner(port, chunk=3))
    got = movingfashion.evaluate(port, products, EvalConfig(**ecfg), runner=run,
                                 out_dir=str(tmp_path / "port"))
    assert cuda_roi_align.roi_align_patch_int8.launches == 0  # the plain version on the CPU

    assert len(run.outputs) == len(jrun.outputs) == 6
    tol = dict(rtol=1e-3, atol=1e-3)  # tests/test_torch_port_slice.py's
    for a, b in zip(run.outputs, jrun.outputs):
        v = b["valid"]
        np.testing.assert_array_equal(a["valid"], v)
        assert v.sum() >= 2
        for k in ("boxes", "scores", "match_features", "aggr_features"):
            np.testing.assert_allclose(a[k][v], b[k][v], err_msg=k, **tol)
    # the same top-k tables
    assert got == want
    metrics = [json.loads((tmp_path / side / "metrics.json").read_text())
               for side in ("port", "jax")]
    assert metrics[0] == metrics[1]
