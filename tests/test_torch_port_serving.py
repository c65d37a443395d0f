"""SeamRetrieval, port vs JAX: build_gallery + retrieve, and detect with
full-image masks, on shared weights.

The reduced config of tests/test_serving.py (XLA backends on the JAX side
and the port's plain versions on the CPU) on 96x128 / 128x96 canvases, JAX
ingest on the device so both sides resize with half-pixel bilinear
interpolation.  Images are numpy rectangles on noise at non-canvas sizes,
landscape and portrait.
"""

import numpy as np
import pytest
import torch

import jax

from seam_match_rcnn_tpu.config import EvalConfig, ModelConfig, RoIHeadsConfig, RPNConfig
from seam_match_rcnn_tpu.models.matchrcnn import init_model as jax_init
from seam_match_rcnn_tpu.serving import SeamRetrieval as JaxSeamRetrieval

from seam_match_rcnn_tpu_torch.ckpt.from_jax import load_jax_variables
from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model
from seam_match_rcnn_tpu_torch.serving import Gallery, SeamRetrieval
from torch_port_canvas import Canvas96x128, JaxCanvas96x128

torch.set_num_threads(2)


def _image(rng, h, w):
    img = rng.uniform(0.0, 0.25, (h, w, 3)).astype(np.float32)
    bh, bw = h // 2, w // 2
    y, x = rng.randint(0, h - bh), rng.randint(0, w - bw)
    img[y:y + bh, x:x + bw] = rng.uniform(0.3, 1.0, 3)
    return img


@pytest.fixture(scope="module")
def models():
    """The JAX video model and variables (seeded, non-zero W_z) and the
    port's model on the same weights, both at the reduced config."""
    kw = dict(rpn=RPNConfig(pre_nms_top_n_test=60, post_nms_top_n_test=80),
              roi_heads=RoIHeadsConfig(detections_per_img=6), compute_dtype="float32")
    cfg = ModelConfig(transform=JaxCanvas96x128(min_size=96, max_size=128), **kw)
    port_cfg = ModelConfig(transform=Canvas96x128(min_size=96, max_size=128), **kw)
    jmodel, variables = jax_init(cfg, video=True, canvas=(64, 64))
    rng = np.random.RandomState(3)
    params = jax.tree.map(np.asarray, variables["params"])
    params["temporal_aggregator"]["nlb"]["w_z"] = {
        "kernel": (rng.randn(128, 256) * 0.05).astype(np.float32),
        "bias": (rng.randn(256) * 0.05).astype(np.float32)}
    variables = {"params": params,
                 "batch_stats": jax.tree.map(np.asarray, variables["batch_stats"])}
    port = load_jax_variables(init_model(port_cfg, video=True, device="cpu"), variables)
    return jmodel, variables, port


def test_retrieval_matches_jax(models, tmp_path):
    jmodel, variables, port = models
    rng = np.random.RandomState(3)
    rng.randn(128 * 256 + 256)  # the draws of W_z in the fixture
    shops = [_image(rng, 120, 160), _image(rng, 160, 120), _image(rng, 96, 128)]
    frames = [_image(rng, 120, 160) for _ in range(3)]
    keys = ["a", "b", "c"]
    ecfg = EvalConfig(score_threshold=0.0)

    jretr = JaxSeamRetrieval(jmodel, variables, cfg=ecfg, chunk=4, ingest="device")
    jgal = jretr.build_gallery(shops, keys=keys)
    want = jretr.retrieve(frames, jgal, k=2)

    retr = SeamRetrieval(port, cfg=ecfg, chunk=4)
    gal = Gallery.load(retr.build_gallery(shops, keys=keys).save(str(tmp_path / "g")))
    got = retr.retrieve(frames, gal, k=2)

    assert gal.keys == jgal.keys
    np.testing.assert_allclose(gal.aggr_feats, jgal.aggr_feats, rtol=1e-3, atol=1e-3)
    assert got.keys == want.keys
    assert got.track_length == want.track_length
    # f32 throughout; descriptors agree to ~1e-5 and the scores are sigmoids
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-4)


def test_detect_matches_jax(models):
    """detect: boxes in original coordinates and each row's mask pasted at
    the original size, against the JAX ``SeamRetrieval.detect`` on the same
    model and frames (two landscape frames of one size and a portrait one
    at a non-canvas size), on the rows valid on both sides."""
    jmodel, variables, port = models
    rng = np.random.RandomState(7)
    frames = [_image(rng, 120, 160), _image(rng, 120, 160), _image(rng, 150, 110)]
    ecfg = EvalConfig(score_threshold=0.0)
    want = JaxSeamRetrieval(jmodel, variables, cfg=ecfg, chunk=4, ingest="device").detect(frames)
    retr = SeamRetrieval(port, cfg=ecfg, chunk=4)
    got = retr.detect(frames)
    assert retr.detect(frames[:1], with_masks=False)[0].keys() == {"boxes", "scores", "labels",
                                                                  "valid"}
    tol = dict(rtol=1e-3, atol=1e-3)
    for g, w, f in zip(got, want, frames):
        assert set(g) == set(w) == {"boxes", "scores", "labels", "valid", "masks"}
        assert g["masks"].shape == (6,) + f.shape[:2] and g["masks"].dtype == np.float32
        v = g["valid"] & w["valid"]
        assert v.sum() >= 2
        np.testing.assert_allclose(g["boxes"][v], w["boxes"][v], **tol)
        np.testing.assert_allclose(g["scores"][v], w["scores"][v], **tol)
        np.testing.assert_array_equal(g["labels"][v], w["labels"][v])
        np.testing.assert_allclose(g["masks"][v], w["masks"][v], **tol)
        assert (w["masks"][v] > 0.5).any()
